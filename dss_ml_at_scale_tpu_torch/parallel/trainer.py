"""Single-card trainer: the port of ``dss_ml_at_scale_tpu/parallel/trainer.py``.

Two tasks run under one ``Trainer``:

- ``ClassifierTask``, the JAX task: Adam at 1e-5 by default, softmax
  cross-entropy, top-1 accuracy (and top-k on eval); uint8 images are
  normalized inside the step and NCHW input is transposed to NHWC.
- ``LMTask``: next-token cross entropy of a ``TransformerLM`` on
  ``tokens`` batches, Adam at 3e-4 or a learning-rate schedule.

``optax.adam(lr)`` and ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)`` compute the same update: both divide the bias-corrected first
moment by the square root of the bias-corrected second moment plus eps.

``Trainer.fit`` keeps the reference's epoch semantics: an infinite reader,
``steps_per_epoch`` given or ``rows // batch``, epochs that end at a step
count (so a resumed run finishes the epoch it resumed in), eval each epoch
capped at ``limit_val_batches``, per-epoch throughput (images/s for the
classifier, tokens/s for the LM). Each epoch's summary also carries the
steady throughput after the epoch's first step (the first step builds the
kernels and warms the allocator caches; the trainer synchronizes once after
it) and the data wait of the steps that follow it.

With ``checkpoint_dir`` the trainer saves once per epoch, as orbax does in
the JAX trainer: ``<dir>/<step>/`` holds ``state.pt`` (model, optimizer,
scheduler, step, epoch and the epoch's metrics, ``torch.save``),
``metrics.json`` and a SHA-256 manifest, written in a temporary directory
and renamed into place, durably. Retention keeps the ``keep_checkpoints``
best steps by the best metric when eval runs, the newest ones otherwise.
``resume`` restores the newest intact step, falling back past corrupt ones
(``checkpoint_fallback_total``) and moving newer unusable steps aside, and
keeps the best-so-far of the steps on disk. A resumed fit advances the
train iterator past the batches the restored steps consumed (read on the
host, never sent to the device), so a source that replays its stream from
the start, as the LM's token source does, gives the run an uninterrupted
fit would have; the JAX trainer restarts the stream instead. The port
resumes its own checkpoints; orbax checkpoints of the JAX package are not
read.

Not ported yet: the health supervisor, preemption, ``resume_auto``,
tracking, profiling windows, and data parallelism (DDP with BN sums
all-reduced across ranks, and ZeRO-1).
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

from ..data.prefetch import Feeder
from ..data.transform import IMAGENET_MEAN, IMAGENET_STD
from ..models.metrics import cross_entropy_loss, multiclass_accuracy, topk_accuracy
from ..models.transformer import next_token_loss
from ..resilience import checkpoint as integrity
from ..resilience import durability
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
    learning_rate: float = 1e-5
    eval_topk: tuple = ()
    optimizer: torch.optim.Optimizer = dataclasses.field(init=False)
    scheduler = None  # no learning-rate schedule
    throughput_unit = "images"
    default_best_metric = "val_acc"
    default_best_mode = "max"

    def __post_init__(self):
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)

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
        self.model.train()
        logits = self.model(images)
        loss = cross_entropy_loss(logits, labels)
        grad_norm = _adam_step(self.model, self.optimizer, loss)
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
    :func:`..parallel.schedules.warmup_cosine_decay_schedule` returns)
    driven by a ``LambdaLR`` on an Adam of base learning rate 1, so update
    ``i`` runs at exactly ``schedule(i)``, as under ``optax.adam(schedule)``.
    """

    model: torch.nn.Module
    learning_rate: float | Callable[[int], float] = 3e-4
    # The MoE load-balance loss of the JAX task; the MoE FFN is not ported.
    aux_loss_weight: float = 0.0
    optimizer: torch.optim.Optimizer = dataclasses.field(init=False)
    scheduler: Any = dataclasses.field(init=False, default=None)
    throughput_unit = "tokens"
    default_best_metric = "val_loss"
    default_best_mode = "min"

    def __post_init__(self):
        if self.aux_loss_weight > 0.0:
            raise ValueError(
                "aux_loss_weight > 0 needs the MoE FFN, which a later slice of "
                "the port brings (ROADMAP Queue 1 item 14)"
            )
        scheduled = callable(self.learning_rate)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=1.0 if scheduled else self.learning_rate,
            betas=(0.9, 0.999), eps=1e-8)
        if scheduled:
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                               self.learning_rate)

    def batch_units(self, batch: Batch) -> int:
        return int(np.prod(batch["tokens"].shape))

    def train_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        """One Adam step; metrics are 0-d tensors (no host sync)."""
        tokens = batch["tokens"]
        self.model.train()
        loss = next_token_loss(self.model(tokens), tokens)
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
    """Explicit epoch/step loop on one device."""

    def __init__(self, config: TrainerConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)

    def _steps_per_epoch(self, batch_size: int) -> int:
        cfg = self.config
        if cfg.steps_per_epoch is not None:
            return cfg.steps_per_epoch
        if cfg.total_train_rows is None:
            raise ValueError("TrainerConfig needs steps_per_epoch or total_train_rows")
        steps = cfg.total_train_rows // batch_size
        if steps == 0:
            raise ValueError(
                f"total_train_rows={cfg.total_train_rows} < batch {batch_size}; "
                "no full step per epoch"
            )
        return steps

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(
        self,
        task,
        train_data: Iterable[Mapping[str, np.ndarray]],
        val_data_factory: Callable[[], Iterable[Mapping[str, np.ndarray]]] | None = None,
    ) -> FitResult:
        """Train ``task`` (a ``ClassifierTask`` or an ``LMTask``) on batches
        of ``train_data`` for ``max_epochs`` epochs (``resume``: from the
        newest intact checkpoint on), evaluating each epoch on a fresh
        ``val_data_factory()`` when one is given."""
        # The task's best-metric defaults resolve into a local config: the
        # same Trainer may fit either task.
        cfg = dataclasses.replace(
            self.config,
            best_metric=self.config.best_metric or task.default_best_metric,
            best_mode=self.config.best_mode or task.default_best_mode,
        )
        use_best = val_data_factory is not None
        root = Path(cfg.checkpoint_dir) if cfg.checkpoint_dir is not None else None
        step = 0
        best_value = best_step = None
        if root is not None and cfg.resume and integrity.list_steps(root):
            step = _restore_with_fallback(root, task)
            for stale in (s for s in integrity.list_steps(root) if s > step):
                integrity.quarantine_step(root / str(stale))
            best_value, best_step = _best_on_disk(root, cfg)

        train_iter = iter(train_data)
        for _ in range(step):  # the batches the restored steps consumed
            next(train_iter)
        first = next(train_iter)
        batch_size = len(next(iter(first.values())))
        units = task.batch_units(first)
        unit = task.throughput_unit
        steps_per_epoch = self._steps_per_epoch(batch_size)
        sign = 1.0 if cfg.best_mode == "max" else -1.0
        feeder = Feeder(itertools.chain([first], train_iter), self.device,
                        depth=cfg.feeder_depth, name="train")
        history: list[dict] = []
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
                    metrics = task.train_step(batch)
                    epoch_steps += 1
                    step += 1
                    timer.tick()
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
                    **{k: float(v) for k, v in metrics.items()},
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
                    _save(root, task, step, epoch, summary)
                    _retain(root, cfg, use_best)
                if exhausted:
                    log.warning("train data exhausted at step %d", step)
                    break
        finally:
            feeder.close()
        return FitResult(
            steps=step, history=history, best_checkpoint_step=best_step,
            best_metric_value=best_value,
            best_checkpoint_path=(str(root / str(best_step))
                                  if root is not None and best_step is not None else None),
        )

    def _evaluate(self, task, val_data_factory) -> dict:
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
        return {k: v / max(count, 1) for k, v in totals.items()}


def _save(root: Path, task, step: int, epoch: int, metrics: dict) -> Path:
    """Write checkpoint ``root/<step>/`` durably: its files and manifest in
    a temporary directory, fsynced, then renamed into place."""
    root.mkdir(parents=True, exist_ok=True)
    final = root / str(step)
    tmp = root / f"{step}{durability.TMP_SUFFIX}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    scheduler = task.scheduler
    state = {
        "model": task.model.state_dict(),
        "optimizer": task.optimizer.state_dict(),
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


def _restore_with_fallback(root: Path, task) -> int:
    """Load the newest usable step into ``task``, walking past corrupt
    ones: each step is verified against its manifest first, and a corrupt
    step, or one whose load raises anyway, is skipped with a
    ``checkpoint_fallback_total`` count. Returns the restored step."""
    steps = sorted(integrity.list_steps(root), reverse=True)
    last_exc = None
    for step in steps:
        status, problems = integrity.verify_step(root / str(step))
        if status == "corrupt":
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
            integrity.record_fallback(step, f"restore raised {type(e).__name__}: {e}")
            last_exc = e
            continue
        log.info("resumed from checkpoint step %d", state["step"])
        return int(state["step"])
    raise FileNotFoundError(
        f"no intact checkpoint step under {root} (candidates: {steps})"
    ) from last_exc
