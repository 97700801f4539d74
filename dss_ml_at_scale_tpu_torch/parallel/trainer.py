"""The trainer: the port of ``dss_ml_at_scale_tpu/parallel/trainer.py``.

Two tasks run under one ``Trainer``:

- ``ClassifierTask``, the JAX task: Adam at 1e-5 by default, softmax
  cross-entropy, top-1 accuracy (and top-k on eval); uint8 images are
  normalized inside the step and NCHW input is transposed to NHWC; with
  ``augment`` the train step crops and flips on the device
  (:mod:`..data.augment`), keyed by the step count.
- ``LMTask``: next-token cross entropy of a ``TransformerLM`` on
  ``tokens`` batches, Adam at 3e-4 or a learning-rate schedule.

``optax.adam(lr)`` and ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)`` compute the same update: both divide the bias-corrected first
moment by the square root of the bias-corrected second moment plus eps.

``Trainer.fit`` keeps the reference's epoch semantics: an infinite reader,
``steps_per_epoch`` given or ``rows // (batch x processes)``, epochs that
end at a step count (so a resumed run finishes the epoch it resumed in),
eval each epoch capped at ``limit_val_batches``, per-epoch throughput
(images/s for the classifier, tokens/s for the LM, over every process).
Each epoch's summary also carries the steady throughput after the epoch's
first step (the first step builds the kernels and warms the allocator
caches; the trainer synchronizes once after it) and the data wait of the
steps that follow it.

Data parallelism (a process group of more than one rank,
:mod:`..runtime.distributed`): each rank reads its own shard, the model is
wrapped in ``DistributedDataParallel`` (gradients averaged over the ranks;
the BatchNorm statistics are global, reduced by the model's own layers),
and the epoch's train and val metrics are means over the ranks.
``shard_opt_state`` is ZeRO-1: ``ZeroRedundancyOptimizer`` keeps each
rank's share of Adam's moments, the same update as a replicated Adam.

With ``checkpoint_dir`` the trainer saves once per epoch, as orbax does in
the JAX trainer: ``<dir>/<step>/`` holds ``state.pt`` (model, optimizer,
scheduler, step, epoch and the epoch's metrics, ``torch.save``),
``metrics.json`` and a SHA-256 manifest, written in a temporary directory
and renamed into place, durably, by rank 0 alone (a ZeRO-1 optimizer is
consolidated to rank 0 first, a collective of every rank; the others wait
at a barrier). Retention keeps the ``keep_checkpoints`` best steps by the
best metric when eval runs, the newest ones otherwise. ``resume`` restores
the newest intact step on every rank, falling back past corrupt ones
(``checkpoint_fallback_total``) and moving newer unusable steps aside, and
keeps the best-so-far of the steps on disk. As in the JAX trainer a
resumed fit continues by step count on a fresh stream: the train iterator
starts from its beginning. The port resumes its own checkpoints; orbax
checkpoints of the JAX package are not read.

``profile_dir`` traces steps ``[profile_start_step, profile_start_step +
profile_num_steps)`` with ``torch.profiler`` into a Chrome trace per rank,
``<profile_dir>/trace_rank<r>_steps<a>-<b>.json``.

Not ported yet: the health supervisor, preemption, ``resume_auto`` and
tracking.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import math
import os
import pickle
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..data.prefetch import Feeder
from ..data.transform import IMAGENET_MEAN, IMAGENET_STD
from ..models.metrics import cross_entropy_loss, multiclass_accuracy, topk_accuracy
from ..models.transformer import next_token_loss
from ..resilience import checkpoint as integrity
from ..resilience import durability
from ..runtime import distributed as rt
from ..utils.profiling import StepTimer

log = logging.getLogger(__name__)

Batch = Mapping[str, Any]


@dataclasses.dataclass
class ClassifierTask:
    """Image classification: a ResNet and its optimizer.

    Batches carry ``image`` (NHWC or NCHW, float or uint8) and ``label``
    (int) tensors on the model's device.
    """

    model: torch.nn.Module
    learning_rate: float | Callable[[int], float] = 1e-5
    eval_topk: tuple = ()
    # On-device RandomResizedCrop + flip of the train batches
    # (data.augment.AugmentConfig); None trains on the batches as they come.
    augment: Any = None
    optimizer: torch.optim.Optimizer = dataclasses.field(init=False)
    scheduler: Any = dataclasses.field(init=False, default=None)
    # The model the train step runs: ``model``, or its DDP wrapper.
    net: torch.nn.Module = dataclasses.field(init=False)
    # Updates taken so far (the JAX ``state.step``): the augment key.
    step: int = dataclasses.field(init=False, default=0)
    throughput_unit = "images"
    default_best_metric = "val_acc"
    default_best_mode = "max"

    def __post_init__(self):
        self.net = self.model
        self.optimizer, self.scheduler = _adam(self.model, self.learning_rate)

    def shard_optimizer(self) -> None:
        """ZeRO-1: the same Adam, its state split over the ranks."""
        self.optimizer, self.scheduler = _adam(self.model, self.learning_rate, zero1=True)

    @staticmethod
    def batch_units(batch: Batch) -> int:
        return len(batch["label"])

    def images(self, batch: Batch) -> torch.Tensor:
        x = batch["image"]
        if x.ndim == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
            x = x.permute(0, 2, 3, 1).contiguous()  # NCHW -> NHWC
        if x.dtype == torch.uint8:
            mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
            std = torch.as_tensor(IMAGENET_STD, device=x.device)
            x = (x.float() / 255.0 - mean) / std
        return x

    def train_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        """One Adam step; metrics are 0-d tensors (no host sync)."""
        images, labels = self.images(batch), batch["label"].long()
        if self.augment is not None:
            from ..data.augment import augment_for_step

            images = augment_for_step(self.step, images, images.shape[1], self.augment,
                                      rank=rt.process_index(), ranks=rt.process_count())
        self.model.train()
        logits = self.net(images)
        loss = cross_entropy_loss(logits, labels)
        grad_norm = _adam_step(self.model, self.optimizer, loss, self.scheduler)
        self.step += 1
        return {
            "train_loss": loss.detach(),
            "train_acc": multiclass_accuracy(logits.detach(), labels),
            "grad_norm": grad_norm,
        }

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        images, labels = self.images(batch), batch["label"].long()
        self.model.eval()
        logits = self.model(images)
        out = {
            "val_loss": cross_entropy_loss(logits, labels),
            "val_acc": multiclass_accuracy(logits, labels),
        }
        for k in self.eval_topk:
            out[f"val_top{k}_acc"] = topk_accuracy(logits, labels, k)
        return out

def _adam(model: torch.nn.Module, learning_rate, zero1: bool = False):
    """``(optimizer, scheduler)``: Adam (betas 0.9/0.999, eps 1e-8, as
    optax) at ``learning_rate``, a float, or a schedule of the update count
    driven by a ``LambdaLR`` on a base rate of 1, so update ``i`` runs at
    exactly ``schedule(i)``, as under ``optax.adam(schedule)``. ``zero1``:
    a ``ZeroRedundancyOptimizer`` around the same Adam."""
    scheduled = callable(learning_rate)
    kw = dict(lr=1.0 if scheduled else learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if zero1:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        optimizer = ZeroRedundancyOptimizer(model.parameters(),
                                            optimizer_class=torch.optim.Adam, **kw)
    else:
        optimizer = torch.optim.Adam(model.parameters(), **kw)
    scheduler = (torch.optim.lr_scheduler.LambdaLR(optimizer, learning_rate)
                 if scheduled else None)
    return optimizer, scheduler


def _adam_step(model: torch.nn.Module, optimizer, loss: torch.Tensor,
               scheduler=None) -> torch.Tensor:
    """Backward, one optimizer update (and one schedule step); returns the
    gradients' global norm (``optax.global_norm``) as a 0-d tensor."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    norms = [torch.linalg.vector_norm(p.grad.float())
             for p in model.parameters() if p.grad is not None]
    grad_norm = torch.linalg.vector_norm(torch.stack(norms))
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return grad_norm


@dataclasses.dataclass
class LMTask:
    """Causal language-model task: the port of the JAX ``LMTask``.

    Batches carry ``tokens`` ``[B, S]`` int tensors on the model's device;
    the loss is next-token cross entropy. ``learning_rate`` is a float, or
    a schedule (a function of the update count, as
    :func:`..parallel.schedules.warmup_cosine_decay_schedule` returns), as
    :func:`_adam` takes it.
    """

    model: torch.nn.Module
    learning_rate: float | Callable[[int], float] = 3e-4
    # The MoE load-balance loss of the JAX task; the MoE FFN is not ported.
    aux_loss_weight: float = 0.0
    optimizer: torch.optim.Optimizer = dataclasses.field(init=False)
    scheduler: Any = dataclasses.field(init=False, default=None)
    net: torch.nn.Module = dataclasses.field(init=False)
    throughput_unit = "tokens"
    default_best_metric = "val_loss"
    default_best_mode = "min"

    def __post_init__(self):
        if self.aux_loss_weight > 0.0:
            raise ValueError(
                "aux_loss_weight > 0 needs the MoE FFN, which a later slice of "
                "the port brings (ROADMAP Queue 1 item 14)"
            )
        self.net = self.model
        self.optimizer, self.scheduler = _adam(self.model, self.learning_rate)

    def shard_optimizer(self) -> None:
        """ZeRO-1: the same Adam, its state split over the ranks."""
        self.optimizer, self.scheduler = _adam(self.model, self.learning_rate, zero1=True)

    def batch_units(self, batch: Batch) -> int:
        return int(np.prod(batch["tokens"].shape))

    def train_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        """One Adam step; metrics are 0-d tensors (no host sync)."""
        tokens = batch["tokens"]
        self.model.train()
        loss = next_token_loss(self.net(tokens), tokens)
        grad_norm = _adam_step(self.model, self.optimizer, loss, self.scheduler)
        loss = loss.detach()
        return {"train_loss": loss, "train_ppl": torch.exp(loss), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        tokens = batch["tokens"]
        self.model.eval()
        loss = next_token_loss(self.model(tokens), tokens)
        return {"val_loss": loss, "val_ppl": torch.exp(loss)}


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 2                      # reference MAX_EPOCHS
    steps_per_epoch: int | None = None       # else total_train_rows // batch
    total_train_rows: int | None = None
    limit_val_batches: int | None = 5
    log_every_steps: int = 10
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 2
    # None: the task's default_best_metric / default_best_mode (val_acc /
    # max for the classifier, val_loss / min for the LM).
    best_metric: str | None = None
    best_mode: str | None = None
    resume: bool = False
    feeder_depth: int = 2
    # torch.profiler trace of steps [profile_start_step,
    # profile_start_step + profile_num_steps) into profile_dir.
    profile_dir: str | None = None
    profile_start_step: int = 5
    profile_num_steps: int = 5
    # ZeRO-1: Adam's state split over the ranks.
    shard_opt_state: bool = False


@dataclasses.dataclass
class FitResult:
    steps: int
    history: list[dict]
    best_checkpoint_step: int | None = None
    best_metric_value: float | None = None
    best_checkpoint_path: str | None = None


STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class Trainer:
    """Explicit epoch/step loop on one device per process."""

    def __init__(self, config: TrainerConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)

    def _steps_per_epoch(self, batch_size: int) -> int:
        cfg = self.config
        if cfg.steps_per_epoch is not None:
            return cfg.steps_per_epoch
        if cfg.total_train_rows is None:
            raise ValueError("TrainerConfig needs steps_per_epoch or total_train_rows")
        steps = cfg.total_train_rows // (batch_size * rt.process_count())
        if steps == 0:
            raise ValueError(
                f"total_train_rows={cfg.total_train_rows} < global batch "
                f"{batch_size} x {rt.process_count()}; no full step per epoch"
            )
        return steps

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def data_parallel(self, task) -> None:
        """Wrap the task's model for a run of several ranks, and shard its
        optimizer (ZeRO-1) when asked; once per task, before its first step
        and any restore."""
        if rt.process_count() > 1 and task.net is task.model:
            from torch.nn.parallel import DistributedDataParallel

            # The BN statistics are global and so identical on every rank:
            # no buffer broadcast.
            task.net = DistributedDataParallel(
                task.model, device_ids=[self.device] if self.device.type == "cuda" else None,
                broadcast_buffers=False)
        zero1 = hasattr(task.optimizer, "consolidate_state_dict")
        if self.config.shard_opt_state and dist.is_initialized() and not zero1:
            task.shard_optimizer()

    def fit(
        self,
        task,
        train_data: Iterable[Mapping[str, np.ndarray]],
        val_data_factory: Callable[[], Iterable[Mapping[str, np.ndarray]]] | None = None,
    ) -> FitResult:
        """Train ``task`` (a ``ClassifierTask`` or an ``LMTask``) on batches
        of ``train_data`` for ``max_epochs`` epochs (``resume``: from the
        newest intact checkpoint on), evaluating each epoch on a fresh
        ``val_data_factory()`` when one is given. In a run of several ranks
        every rank calls this with its own shard of the data."""
        # The task's best-metric defaults resolve into a local config: the
        # same Trainer may fit either task.
        cfg = dataclasses.replace(
            self.config,
            best_metric=self.config.best_metric or task.default_best_metric,
            best_mode=self.config.best_mode or task.default_best_mode,
        )
        if hasattr(task, "shard_optimizer"):
            self.data_parallel(task)
        coordinator = rt.process_index() == 0
        use_best = val_data_factory is not None
        root = Path(cfg.checkpoint_dir) if cfg.checkpoint_dir is not None else None
        step = 0
        best_value = best_step = None
        if root is not None and cfg.resume and integrity.list_steps(root):
            step = _restore_with_fallback(root, task, record=coordinator)
            rt.barrier()  # every rank has read before newer steps move aside
            if coordinator:
                for stale in (s for s in integrity.list_steps(root) if s > step):
                    integrity.quarantine_step(root / str(stale))
            best_value, best_step = _best_on_disk(root, cfg)
            rt.barrier()
        task.step = step

        # A resumed run takes the stream from its start, as the JAX trainer.
        train_iter = iter(train_data)
        first = next(train_iter)
        batch_size = len(next(iter(first.values())))
        units = task.batch_units(first) * rt.process_count()
        unit = task.throughput_unit
        steps_per_epoch = self._steps_per_epoch(batch_size)
        sign = 1.0 if cfg.best_mode == "max" else -1.0
        feeder = Feeder(itertools.chain([first], train_iter), self.device,
                        depth=cfg.feeder_depth, name="train")
        history: list[dict] = []
        profile = _ProfileWindow(cfg, self.device)
        try:
            # A resumed run finishes the epoch its restored step is in.
            for epoch in range(step // steps_per_epoch, cfg.max_epochs):
                t0 = time.perf_counter()
                wait0 = feeder.wait_seconds
                timer = StepTimer()
                epoch_steps, metrics = 0, {}
                t_first = wait_first = None
                exhausted = False
                while step < (epoch + 1) * steps_per_epoch:
                    try:
                        batch = next(feeder)
                    except StopIteration:
                        exhausted = True
                        break
                    profile.before(step)
                    metrics = task.train_step(batch)
                    epoch_steps += 1
                    step += 1
                    timer.tick()
                    profile.after(step, self._sync)
                    if epoch_steps == 1:
                        self._sync()
                        t_first, wait_first = time.perf_counter(), feeder.wait_seconds
                    if step % cfg.log_every_steps == 0:
                        log.info("step %d: %s", step, {k: float(v) for k, v in metrics.items()})
                if epoch_steps == 0:
                    log.warning("train data exhausted at step %d", step)
                    break
                self._sync()
                t_end = time.perf_counter()
                summary = {
                    "epoch": epoch,
                    "steps": epoch_steps,
                    "epoch_time_s": t_end - t0,
                    f"{unit}_per_sec": epoch_steps * units / (t_end - t0),
                    "data_wait_s": feeder.wait_seconds - wait0,
                    **timer.summary(),
                    **rt.mean_over_ranks({k: float(v) for k, v in metrics.items()}),
                }
                if epoch_steps > 1:
                    steady = t_end - t_first
                    summary.update({
                        f"steady_{unit}_per_sec": (epoch_steps - 1) * units / steady,
                        "steady_step_time_s": steady / (epoch_steps - 1),
                        "steady_data_wait_s":
                            (feeder.wait_seconds - wait_first) / (epoch_steps - 1),
                    })
                if use_best:
                    summary.update(self._evaluate(task, val_data_factory))
                history.append(summary)
                log.info("epoch %d: %s", epoch, summary)
                metric = summary.get(cfg.best_metric)
                if metric is not None and (best_value is None or sign * metric > sign * best_value):
                    best_value, best_step = metric, step
                if root is not None:
                    _save(root, task, step, epoch, summary, write=coordinator)
                    if coordinator:
                        _retain(root, cfg, use_best)
                    rt.barrier()
                if exhausted:
                    log.warning("train data exhausted at step %d", step)
                    break
        finally:
            profile.close()
            feeder.close()
        return FitResult(
            steps=step, history=history, best_checkpoint_step=best_step,
            best_metric_value=best_value,
            best_checkpoint_path=(str(root / str(best_step))
                                  if root is not None and best_step is not None else None),
        )

    def _evaluate(self, task, val_data_factory) -> dict:
        """Each metric's mean over the val batches of every rank (each
        rank reads its own shard; no collective runs inside the loop)."""
        totals: dict[str, float] = {}
        count = 0
        val_data = val_data_factory()
        source = iter(val_data)
        if self.config.limit_val_batches is not None:
            # Limit before the feeder, so no extra batch is decoded.
            source = itertools.islice(source, self.config.limit_val_batches)
        feeder = Feeder(source, self.device, depth=self.config.feeder_depth, name="eval")
        try:
            for batch in feeder:
                for k, v in task.eval_step(batch).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
        finally:
            feeder.close()
            stop = getattr(val_data, "stop", None)
            if callable(stop):
                stop()
        if rt.process_count() > 1:
            sums = rt.mean_over_ranks({**totals, "_count": float(count)})
            count = sums.pop("_count") * rt.process_count()
            totals = {k: v * rt.process_count() for k, v in sums.items()}
        return {k: v / max(count, 1) for k, v in totals.items()}


class _ProfileWindow:
    """``torch.profiler`` over steps ``[start, start + num)`` of a fit,
    written as a Chrome trace into ``profile_dir`` when the window closes
    (or the fit ends inside it)."""

    def __init__(self, cfg: TrainerConfig, device: torch.device):
        self.dir = Path(cfg.profile_dir) if cfg.profile_dir is not None else None
        self.start, self.num = cfg.profile_start_step, cfg.profile_num_steps
        self.device = device
        self.prof = None
        self.first = self.stop_at = self.last = None

    def before(self, step: int) -> None:
        if self.dir is None or self.prof is not None or step < self.start:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.first, self.stop_at, self.last = step, step + self.num, step

    def after(self, step: int, sync: Callable[[], None]) -> None:
        if self.prof is None:
            return
        self.last = step
        if step >= self.stop_at:
            sync()
            self._write(step)

    def close(self) -> None:
        if self.prof is not None:
            self._write(self.last)

    def _write(self, step: int) -> None:
        prof, self.prof = self.prof, None
        prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.dir / f"trace_rank{rt.process_index()}_steps{self.first}-{step}.json"
        prof.export_chrome_trace(str(path))
        log.info("profile of steps %d-%d written to %s", self.first, step, path)
        self.start = math.inf  # one window per fit


def _optimizer_state(task) -> dict | None:
    """The optimizer's whole state, on rank 0 (``None`` elsewhere): a
    ZeRO-1 optimizer consolidates its shards there first, a collective
    that every rank must enter."""
    opt = task.optimizer
    if hasattr(opt, "consolidate_state_dict"):
        opt.consolidate_state_dict(to=0)
    return opt.state_dict() if rt.process_index() == 0 else None


def _save(root: Path, task, step: int, epoch: int, metrics: dict, *, write: bool = True):
    """Write checkpoint ``root/<step>/`` durably: its files and manifest in
    a temporary directory, fsynced, then renamed into place. Every rank
    calls it; only the one with ``write`` writes."""
    optimizer_state = _optimizer_state(task)
    if not write:
        return None
    root.mkdir(parents=True, exist_ok=True)
    final = root / str(step)
    tmp = root / f"{step}{durability.TMP_SUFFIX}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    scheduler = task.scheduler
    state = {
        "model": task.model.state_dict(),
        "optimizer": optimizer_state,
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        "step": step,
        "epoch": epoch,
        "metrics": metrics,
    }
    torch.save(state, tmp / (STATE_FILE + durability.TMP_SUFFIX))
    durability.durable_replace(tmp / (STATE_FILE + durability.TMP_SUFFIX), tmp / STATE_FILE)
    durability.durable_write_json(tmp / METRICS_FILE, metrics)
    integrity.write_manifest(tmp)
    if final.exists():  # as orbax: another run's step, never overwritten
        shutil.rmtree(tmp)
        raise FileExistsError(f"checkpoint step {step} already exists under {root}; "
                              "resume that run, or use another directory")
    os.replace(tmp, final)
    durability.fsync_dir(root)
    return final


def _step_metric(root: Path, step: int, name: str) -> float | None:
    try:
        value = json.loads((root / str(step) / METRICS_FILE).read_text()).get(name)
    except (OSError, ValueError, AttributeError):
        return None
    return value if isinstance(value, (int, float)) and math.isfinite(value) else None


def _retain(root: Path, cfg: TrainerConfig, use_best: bool) -> None:
    """Keep ``keep_checkpoints`` steps: the best by the best metric when
    eval runs (a step without the metric ranks last), else the newest."""
    steps = integrity.list_steps(root)
    if len(steps) <= cfg.keep_checkpoints:
        return
    sign = 1.0 if cfg.best_mode == "max" else -1.0

    def rank(s):
        if not use_best:
            return s
        m = _step_metric(root, s, cfg.best_metric)
        return (-math.inf if m is None else sign * m, s)

    keep = set(sorted(steps, key=rank, reverse=True)[:cfg.keep_checkpoints])
    for s in steps:
        if s not in keep:
            shutil.rmtree(root / str(s))


def _best_on_disk(root: Path, cfg: TrainerConfig) -> tuple[float | None, int | None]:
    """Best (value, step) among the steps still on disk: a resumed run
    keeps its best-so-far, and never points at a pruned step."""
    sign = 1.0 if cfg.best_mode == "max" else -1.0
    found = [(sign * m, s, m) for s in integrity.list_steps(root)
             if (m := _step_metric(root, s, cfg.best_metric)) is not None]
    if not found:
        return None, None
    _, s, m = max(found)
    return m, s


def _restore_with_fallback(root: Path, task, record: bool = True) -> int:
    """Load the newest usable step into ``task``, walking past corrupt
    ones: each step is verified against its manifest first, and a corrupt
    step, or one whose load raises anyway, is skipped with a
    ``checkpoint_fallback_total`` count (``record``: on one rank only).
    Returns the restored step."""
    steps = sorted(integrity.list_steps(root), reverse=True)
    last_exc = None
    for step in steps:
        status, problems = integrity.verify_step(root / str(step))
        if status == "corrupt":
            if record:
                integrity.record_fallback(step, "; ".join(problems))
            continue
        try:
            # On the host: load_state_dict copies to each parameter's device,
            # and Adam keeps its step counts on the CPU, as a fresh Adam does.
            state = torch.load(root / str(step) / STATE_FILE, map_location="cpu",
                               weights_only=True)
            task.model.load_state_dict(state["model"])
            task.optimizer.load_state_dict(state["optimizer"])
            if (task.scheduler is None) != (state["scheduler"] is None):
                raise ValueError("the checkpoint's learning-rate schedule does not match the task's")
            if task.scheduler is not None:
                # The restored count on the task's own curve: a schedule
                # declared anew sets the next update's rate, as optax
                # evaluates its schedule at the restored count.
                sched = task.scheduler
                sched.load_state_dict(state["scheduler"])
                for group, fn, base in zip(task.optimizer.param_groups, sched.lr_lambdas,
                                           sched.base_lrs):
                    group["lr"] = base * fn(sched.last_epoch)
        except (OSError, RuntimeError, KeyError, ValueError, EOFError,
                pickle.UnpicklingError) as e:
            if record:
                integrity.record_fallback(step, f"restore raised {type(e).__name__}: {e}")
            last_exc = e
            continue
        log.info("resumed from checkpoint step %d", state["step"])
        return int(state["step"])
    raise FileNotFoundError(
        f"no intact checkpoint step under {root} (candidates: {steps})"
    ) from last_exc
