"""The trainer: the port of ``dss_ml_at_scale_tpu/parallel/trainer.py``.

Two tasks run under one ``Trainer``:

- ``ClassifierTask``, the JAX task: Adam at 1e-5 by default, softmax
  cross-entropy, top-1 accuracy (and top-k on eval); uint8 images are
  normalized inside the step and NCHW input is transposed to NHWC; with
  ``augment`` the train step crops and flips on the device
  (:mod:`..data.augment`), keyed by the step count.
- ``LMTask``: next-token cross entropy of a ``TransformerLM`` on
  ``tokens`` batches (plus ``aux_loss_weight`` times the MoE layers'
  load-balance loss), Adam at 3e-4 or a learning-rate schedule.

A task's ``layout`` says how its ranks share the work. ``"data"`` (the
default): each rank reads its own shard and DDP averages the gradients.
``"sequence"`` (an ``LMTask`` of a ring-attention model, the counterpart
of JAX's ``batch_specs={"tokens": P(None, "sp")}``): every rank reads the
same batch and takes its shard of the sequence; the gradients are summed
over the ranks. ``"pipeline"`` (:mod:`.pipeline`, :mod:`..models.pipelined_lm`):
every rank reads the same batch and the task shares it out itself. Outside
``"data"`` there is no DDP, ZeRO-1 is refused (as the JAX trainer refuses
``shard_opt_state`` for a task that declares its own layout), and the
throughput counts the one batch once.

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

Crash safety, as in the JAX trainer:

- ``health`` (a :class:`..resilience.health.HealthConfig`) supervises every
  step: the task computes its gradients, the guard judges the loss and
  grad-norm signals and reads the verdict (one host sync per step), and a
  bad update is discarded before ``optimizer.step()``; the batch's row
  provenance is quarantined and the epoch pulls a make-up batch (epochs
  end at a step count), so a poisoned run commits the update sequence of
  a clean run whose stream left the poison batch out. A streak escalates
  to a rollback (the newest intact step restored, newer steps moved
  aside) and then to an abort with a diagnostic bundle. ``health=None``
  is the unsupervised step: no snapshot, no verdict, no sync.
- SIGTERM (:class:`..resilience.preemption.PreemptionGuard`) ends the fit
  after the step in flight with a metrics-less checkpoint saved mid-epoch
  and ``FitResult.preempted``; in a run of several ranks the ranks agree
  on the step to stop at (:class:`_StopVote`).
- ``resume_auto`` resumes from the newest intact step when there is one
  and starts fresh when every step is torn, after sweeping stranded tmp
  files (process 0); ``auto_resume_total`` counts the restores.
- A ``tracker`` (a :class:`..tracking.RunStore`) gets the metrics and the
  journal events ``config`` (the checkpoint dir, before any step),
  ``resume`` and ``checkpoint`` (each published step).

The port publishes a step only with its manifest (written in the staging
directory before the rename), so the JAX trainer's manifest repair of a
restored step has nothing to repair here.

Tracing and metrics, as in the JAX trainer: ``fit`` opens a ``run`` trace
and a ``fit`` root span whose begin event reaches the flight recorder
before the first step, so any kill after the start leaves an open span
naming the run. Each committed step runs a ``train_step`` span under its
batch's own step trace (born on the feeder thread with ``reader.next`` and
``feeder.place``); ``eval``, ``checkpoint`` and ``checkpoint.finalize``
(the manifest, the rename, the journal commit) run under the trace of the
step they follow, and ``train_epoch`` is recorded when an epoch ends. On a
card the ``train_step`` span covers the host's dispatch of the step's
kernels (the step ends in no synchronize, so it measures the card's time
only once the launch queue is full) plus, under ``health``, the verdict's
fetch. The metrics: ``train_step_seconds`` and the
``train_step_window_seconds`` window (every committed step's
``train_step`` span), ``train_data_wait_seconds`` (the feeder's waits,
one in four), ``train_throughput_rows_per_sec`` (the last epoch's),
``train_compile_events_total`` and the SLO engine's train-step objective.

Replay is bitwise on a card: a CUDA device runs cuDNN in its
deterministic mode without autotuning (the trainer sets both for the
process; the kernels of :mod:`..ops` use no atomics), so two runs of the
same seed, data order and flags commit the same parameters, the property
the chaos soak's ``params_bitwise_equal`` holds.
"""

from __future__ import annotations

import contextlib
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

from .. import telemetry
from ..data.prefetch import Feeder, split_provenance
from ..data.transform import IMAGENET_MEAN, IMAGENET_STD
from ..models.metrics import cross_entropy_loss, multiclass_accuracy, topk_accuracy
from ..models.moe import collect_aux_loss
from ..models.transformer import next_token_loss
from ..resilience import checkpoint as integrity
from ..resilience import durability, health
from ..resilience.faults import maybe_fail
from ..resilience.preemption import PreemptionGuard
from ..runtime import distributed as rt
from ..telemetry import tracecontext
from ..utils.profiling import StepTimer
from .ring import sequence_shard, sharded_next_token_loss

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
        metrics = self.compute_update(batch)
        self.commit_update()
        return metrics

    def compute_update(self, batch: Batch) -> dict[str, torch.Tensor]:
        """A step up to its update: forward (which moves the BatchNorm
        running statistics), backward and the gradients' norm. The
        augment draws are keyed by ``step``, the updates committed so far:
        a discarded step's make-up batch gets the key of the step it
        replaces."""
        images, labels = self.images(batch), batch["label"].long()
        if self.augment is not None:
            from ..data.augment import augment_for_step

            images = augment_for_step(self.step, images, images.shape[1], self.augment,
                                      rank=rt.process_index(), ranks=rt.process_count())
        self.model.train()
        logits = self.net(images)
        loss = cross_entropy_loss(logits, labels)
        grad_norm = _backward(self.model, self.optimizer, loss)
        return {
            "train_loss": loss.detach(),
            "train_acc": multiclass_accuracy(logits.detach(), labels),
            "grad_norm": grad_norm,
        }

    def commit_update(self) -> None:
        """The update of the gradients :meth:`compute_update` left."""
        _update(self.optimizer, self.scheduler)
        self.step += 1

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


def _backward(model: torch.nn.Module, optimizer, loss: torch.Tensor, group=None,
              mean: bool = False) -> torch.Tensor:
    """Backward; then, with a ``group``, the gradients summed (``mean``:
    averaged) over its ranks; returns their global norm
    (``optax.global_norm``) as a 0-d tensor."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if group is not None and rt.group_size(group) > 1:
        _reduce_grads(model, group, mean)
    norms = [torch.linalg.vector_norm(p.grad.float())
             for p in model.parameters() if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


def _reduce_grads(model: torch.nn.Module, group, mean: bool) -> None:
    """Every gradient of ``model`` summed (``mean``: averaged) over
    ``group``, in one all-reduce of their concatenation."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= rt.group_size(group)
    for g, new in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(new)


def _update(optimizer, scheduler=None) -> None:
    """One optimizer update and one schedule step."""
    optimizer.step()
    if scheduler is not None:
        scheduler.step()


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
    # The weight of the MoE layers' load-balance loss in the objective (a
    # model without MoE layers adds 0, as in JAX).
    aux_loss_weight: float = 0.0
    optimizer: torch.optim.Optimizer = dataclasses.field(init=False)
    scheduler: Any = dataclasses.field(init=False, default=None)
    net: torch.nn.Module = dataclasses.field(init=False)
    # Updates taken so far (the JAX ``state.step``).
    step: int = dataclasses.field(init=False, default=0)
    # "data", or "sequence" for a ring-attention model (module docstring).
    layout: str = dataclasses.field(init=False, default="data")
    throughput_unit = "tokens"
    default_best_metric = "val_loss"
    default_best_mode = "min"

    def __post_init__(self):
        self.layout = "sequence" if getattr(self.model, "attention", None) == "ring" else "data"
        self.net = self.model
        self.optimizer, self.scheduler = _adam(self.model, self.learning_rate)

    def shard_optimizer(self) -> None:
        """ZeRO-1: the same Adam, its state split over the ranks."""
        self.optimizer, self.scheduler = _adam(self.model, self.learning_rate, zero1=True)

    def batch_units(self, batch: Batch) -> int:
        return int(np.prod(batch["tokens"].shape))

    def train_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        """One Adam step; metrics are 0-d tensors (no host sync)."""
        metrics = self.compute_update(batch)
        self.commit_update()
        return metrics

    def compute_update(self, batch: Batch) -> dict[str, torch.Tensor]:
        """A step up to its update: forward, backward, the gradients' norm.
        ``train_loss`` is the objective, aux term included, as JAX reports
        it."""
        tokens = batch["tokens"]
        self.model.train()
        if self.layout == "sequence":
            group = self.model.group
            share = sharded_next_token_loss(self.net(sequence_shard(tokens, group)), tokens,
                                            group)
            if self.aux_loss_weight > 0.0:
                # Each rank's aux term is the global one's share: the
                # gradients and the reported loss are sums over the ranks.
                share = share + (self.aux_loss_weight / rt.group_size(group)
                                 * collect_aux_loss(self.model))
            grad_norm = _backward(self.model, self.optimizer, share, group)
            loss = share.detach().clone()
            dist.all_reduce(loss, group=group)
        else:
            loss = next_token_loss(self.net(tokens), tokens)
            if self.aux_loss_weight > 0.0:
                loss = loss + self.aux_loss_weight * collect_aux_loss(self.model)
            grad_norm = _backward(self.model, self.optimizer, loss)
            loss = loss.detach()
        return {"train_loss": loss, "train_ppl": torch.exp(loss), "grad_norm": grad_norm}

    def commit_update(self) -> None:
        """The update of the gradients :meth:`compute_update` left."""
        _update(self.optimizer, self.scheduler)
        self.step += 1

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        """The next-token loss alone (no aux term, as JAX's)."""
        tokens = batch["tokens"]
        self.model.eval()
        if self.layout == "sequence":
            group = self.model.group
            loss = sharded_next_token_loss(self.model(sequence_shard(tokens, group)), tokens,
                                           group)
            dist.all_reduce(loss, group=group)
        else:
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
    # Crash-only restart: resume from the newest intact step when there
    # is one (falling back past torn steps, sweeping stranded tmp files),
    # else start fresh instead of erroring.
    resume_auto: bool = False
    feeder_depth: int = 2
    # torch.profiler trace of steps [profile_start_step,
    # profile_start_step + profile_num_steps) into profile_dir.
    profile_dir: str | None = None
    profile_start_step: int = 5
    profile_num_steps: int = 5
    # ZeRO-1: Adam's state split over the ranks.
    shard_opt_state: bool = False
    # Training-health supervision (resilience.health.HealthConfig), or None
    # for the unsupervised step.
    health: Any = None


@dataclasses.dataclass
class FitResult:
    steps: int
    history: list[dict]
    best_checkpoint_step: int | None = None
    best_metric_value: float | None = None
    best_checkpoint_path: str | None = None
    # True when a SIGTERM stopped the fit: the step in flight finished and
    # a resumable checkpoint was saved; --resume continues from it.
    preempted: bool = False
    # Health accounting (0 without supervision): updates discarded, and
    # checkpoint rollbacks performed.
    skipped_steps: int = 0
    health_rollbacks: int = 0
    # True only when resume_auto restored a checkpoint (False when it
    # found nothing, or only wreckage, and started fresh).
    auto_resumed: bool = False


# The data-wait histogram takes one feeder wait in four (the exact total
# rides feeder_stall_seconds_total), as the JAX trainer samples it.
_HIST_SAMPLE_EVERY = 4

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class Trainer:
    """Explicit epoch/step loop on one device per process."""

    def __init__(self, config: TrainerConfig, device="cuda", tracker=None):
        self.config = config
        self.device = torch.device(device)
        self.tracker = tracker

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
        and any restore. A task of another layout shares its work itself."""
        if getattr(task, "layout", "data") != "data":
            if self.config.shard_opt_state:
                raise ValueError(
                    f"shard_opt_state=True conflicts with a task of layout "
                    f"{task.layout!r}, which lays its state out itself")
            return
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
        of ``train_data`` for ``max_epochs`` epochs (``resume`` or
        ``resume_auto``: from the newest intact checkpoint on), evaluating
        each epoch on a fresh ``val_data_factory()`` when one is given. In a
        run of several ranks every rank calls this with its own shard of
        the data."""
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
        if root is not None:
            # Before any step: a run killed in its startup or its first
            # save window stays revivable by `runs doctor --resume`.
            self._journal("config", checkpoint_dir=str(root.absolute()))
        step = 0
        best_value = best_step = None
        auto_resumed = False
        if root is not None and (cfg.resume or cfg.resume_auto):
            step, auto_resumed = self._resume(root, task, cfg)
            if step > 0:
                best_value, best_step = _best_on_disk(root, cfg)
        task.step = step

        # A resumed run takes the stream from its start, as the JAX trainer.
        train_iter = iter(train_data)
        raw_first = next(train_iter)
        first, _ = split_provenance(raw_first)
        batch_size = len(next(iter(first.values())))
        # Outside the "data" layout every rank reads the one batch.
        units = task.batch_units(first) * (
            rt.process_count() if getattr(task, "layout", "data") == "data" else 1)
        unit = task.throughput_unit
        steps_per_epoch = self._steps_per_epoch(batch_size)
        sign = 1.0 if cfg.best_mode == "max" else -1.0
        supervisor = guarded = hstate = None
        if cfg.health is not None:
            supervisor = health.HealthSupervisor(cfg.health)
            guarded = health.guard_train_step(task, cfg.health)
            hstate = health.HealthState.create(self.device)
        _deterministic_kernels(self.device)
        # The step's telemetry: handles resolved once, out of the loop.
        step_hist = telemetry.histogram(
            "train_step_seconds", "train_step span of each committed step")
        step_window = telemetry.window(
            "train_step_window_seconds", "windowed train_step span of each committed step")
        wait_hist = telemetry.histogram(
            "train_data_wait_seconds", "per-step time blocked on the input pipeline")
        throughput_gauge = telemetry.gauge(
            "train_throughput_rows_per_sec", "last epoch's global training throughput")
        compiles = telemetry.CompileTracker(telemetry.counter(
            "train_compile_events_total",
            "kernel libraries built or loaded at first use by a train step"))
        slo_note_step = telemetry.slo.get_engine().note_train_step
        feeder = Feeder(itertools.chain([raw_first], train_iter), self.device,
                        depth=cfg.feeder_depth, name="train",
                        wait_observer=telemetry.SampledObserver(
                            wait_hist, _HIST_SAMPLE_EVERY).observe)
        history: list[dict] = []
        profile = _ProfileWindow(cfg, self.device)
        guard = PreemptionGuard()
        vote = _StopVote(self.device)
        preempted = False
        # The run's root span: its begin event reaches the flight recorder
        # before the first step, so any kill from here on leaves an open
        # span naming the run. Closed first in the finally.
        trace_scope = contextlib.ExitStack()
        trace_scope.enter_context(tracecontext.trace(kind="run"))
        trace_scope.enter_context(telemetry.span("fit", max_epochs=cfg.max_epochs))
        step_handoff = tracecontext.Handoff(None)
        try:
            with guard:
                # A resumed run finishes the epoch its restored step is in.
                for epoch in range(step // steps_per_epoch, cfg.max_epochs):
                    t0_wall = time.time()
                    t0 = time.perf_counter()
                    wait0 = feeder.wait_seconds
                    timer = StepTimer()
                    epoch_steps, metrics = 0, {}
                    t_first = wait_first = None
                    exhausted = stop = False
                    # The epoch ends at a step count of committed updates: a
                    # discarded update pulls a make-up batch, and a
                    # rollback re-runs the restored span.
                    # dsst: hotpath — per-step cost budget is one queue.get (host-sync lint enforces it)
                    while step < (epoch + 1) * steps_per_epoch:
                        try:
                            batch, prov = next(feeder)
                        except StopIteration:
                            exhausted = True
                            break
                        profile.before(step)
                        # The step runs under its batch's own trace (born on
                        # the feeder thread): the reader pull, the copy and
                        # this dispatch share one trace id, and the begin
                        # event leaves an open train_step span in the flight
                        # recorder when a kill lands mid-step.
                        step_handoff = feeder.last_handoff
                        t_step = time.perf_counter()
                        with step_handoff.activate(), telemetry.span("train_step", step=step):
                            if supervisor is None:
                                metrics = task.train_step(batch)
                                action = "commit"
                            else:
                                hstate, step_metrics = guarded(
                                    hstate, batch, supervisor.next_injection())
                                if (step_metrics["health_verdict"] != health.VERDICT_OK
                                        and rt.process_count() > 1):
                                    prov = _gather_provenance(prov)
                                # Process 0 alone writes the quarantine.
                                action = supervisor.observe(step + 1, step_metrics,
                                                            prov if coordinator else None)
                                if action == "commit":
                                    metrics = step_metrics
                        dt_step = time.perf_counter() - t_step
                        compiles.update()
                        if action == "commit":
                            step_hist.observe(dt_step)
                            step_window.observe(dt_step)
                            slo_note_step(dt_step, step_handoff.ctx.trace_id
                                          if step_handoff.ctx is not None else None)
                            epoch_steps += 1
                            step += 1
                            timer.tick()
                            profile.after(step, self._sync)
                            if epoch_steps == 1:
                                self._sync()
                                t_first, wait_first = time.perf_counter(), feeder.wait_seconds
                            if step % cfg.log_every_steps == 0:
                                # dsst: ignore[host-sync] deliberate scalar fetch, throttled to log_every_steps
                                values = {k: float(v) for k, v in metrics.items()}
                                log.info("step %d: %s", step, values)
                                self._log(values, step)
                        elif action == "rollback":
                            step = self._health_rollback(root, task, cfg, supervisor, step + 1)
                            hstate = health.HealthState.create(self.device)
                            if best_step is not None and best_step > step:
                                best_value, best_step = _best_on_disk(root, cfg)
                        elif action == "abort":
                            raise supervisor.abort(
                                step + 1,
                                f"{supervisor.bad_streak} consecutive unhealthy steps under "
                                f"policy {cfg.health.policy!r} ({supervisor.rollbacks}/"
                                f"{cfg.health.max_rollbacks} rollbacks used)",
                                cfg.checkpoint_dir,
                            )
                        if vote.poll(guard.triggered):
                            stop = True
                            break
                    if stop:
                        preempted = True
                        self._preempt(root, task, step, epoch, step_handoff)
                        break
                    if epoch_steps == 0:
                        log.warning("train data exhausted at step %d", step)
                        break
                    self._sync()
                    t_end = time.perf_counter()
                    # dsst: ignore[span-discipline] args (step count) are only known at close; a raw record keeps the exact start/duration semantics of the JAX trainer
                    telemetry.get_span_log().record(
                        "train_epoch", t0_wall, t_end - t0, epoch=epoch, steps=epoch_steps)
                    throughput_gauge.set(epoch_steps * units / (t_end - t0))
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
                        with step_handoff.activate(), telemetry.span("eval", epoch=epoch):
                            summary.update(self._evaluate(task, val_data_factory))
                    history.append(summary)
                    log.info("epoch %d: %s", epoch, summary)
                    self._log({k: v for k, v in summary.items() if k != "epoch"}, step)
                    metric = summary.get(cfg.best_metric)
                    if metric is not None and (best_value is None
                                               or sign * metric > sign * best_value):
                        best_value, best_step = metric, step
                    if root is not None:
                        self._save(root, task, step, epoch, summary, step_handoff)
                        if coordinator:
                            _retain(root, cfg, use_best)
                        rt.barrier()
                    if exhausted:
                        log.warning("train data exhausted at step %d", step)
                        break
        finally:
            trace_scope.close()
            vote.close()
            profile.close()
            feeder.close()
        return FitResult(
            steps=step, history=history, best_checkpoint_step=best_step,
            best_metric_value=best_value,
            best_checkpoint_path=(str(root / str(best_step))
                                  if root is not None and best_step is not None else None),
            preempted=preempted,
            skipped_steps=supervisor.skipped_steps if supervisor is not None else 0,
            health_rollbacks=supervisor.rollbacks if supervisor is not None else 0,
            auto_resumed=auto_resumed,
        )

    # -- crash safety -------------------------------------------------------

    def _resume(self, root: Path, task, cfg: TrainerConfig) -> tuple[int, bool]:
        """Restore the newest usable step into ``task`` on every rank and
        move newer steps aside (process 0); ``(step, auto_resumed)``.
        Process 0 first sweeps the tmp files a killed predecessor
        stranded. Under ``resume_auto`` a directory holding only wreckage
        is moved aside and the run starts fresh (step 0)."""
        coordinator = rt.process_index() == 0
        if coordinator:
            swept = durability.sweep_stranded_tmp(root)
            if swept:
                log.warning("resume: removed %d stranded tmp artifact(s) under %s",
                            len(swept), root)
        rt.barrier()
        if not integrity.list_steps(root):
            return 0, False
        try:
            step = _restore_with_fallback(root, task, record=coordinator)
        except FileNotFoundError:
            if not cfg.resume_auto:
                raise
            log.warning("--resume-auto: no intact checkpoint under %s; moving the remains "
                        "aside and starting fresh", root)
            step = 0
            restored = False
        else:
            restored = True
        self._drop_newer_steps(root, step if restored else -1)
        if not restored:
            return 0, False
        if cfg.resume_auto:
            telemetry.counter(
                "auto_resume_total",
                "fits that auto-resumed from a journaled checkpoint without an "
                "operator-named step",
            ).inc()
        self._journal("resume", step=step)
        return step, cfg.resume_auto

    @staticmethod
    def _drop_newer_steps(root: Path, step: int) -> None:
        """Move the steps newer than ``step`` aside (process 0), after
        every rank has read: the run re-reaches those step numbers."""
        rt.barrier()
        if rt.process_index() == 0:
            for stale in (s for s in integrity.list_steps(root) if s > step):
                integrity.quarantine_step(root / str(stale))
        rt.barrier()

    def _health_rollback(self, root: Path | None, task, cfg: TrainerConfig, supervisor,
                         at_step: int) -> int:
        """The ladder's rollback: restore the newest intact step on every
        rank and move the rolled-over steps aside. Returns the restored
        step; escalates to the supervisor's abort when there is nothing to
        restore."""
        if root is None:
            raise supervisor.abort(
                at_step, "rollback requested but no checkpoint_dir is configured", None)
        t0_wall, t0 = time.time(), time.perf_counter()
        try:
            step = _restore_with_fallback(root, task, record=rt.process_index() == 0)
        except FileNotFoundError as e:
            raise supervisor.abort(
                at_step, f"rollback found no intact checkpoint: {e}", cfg.checkpoint_dir) from e
        self._drop_newer_steps(root, step)
        task.step = step
        supervisor.record_rollback(at_step, step, t0_wall, time.perf_counter() - t0)
        return step

    def _preempt(self, root: Path | None, task, step: int, epoch: int,
                 trace: tracecontext.Handoff) -> None:
        """The step in flight has finished: save a resumable checkpoint of
        ``step`` now, mid-epoch and synchronously (the eviction grace
        window is the one place not to return before the write commits).
        It carries no metrics, so retention's best-ranking never prunes it
        before the resume."""
        telemetry.counter("preemption_signals_total",
                          "preemption signals honored by Trainer.fit").inc()
        self._sync()
        latest = max(integrity.list_steps(root), default=-1) if root is not None else -1
        if root is not None and step > latest:
            self._save(root, task, step, epoch, {}, trace)
            rt.barrier()
        log.warning("preempted at step %d (epoch %d); resumable checkpoint %s", step, epoch,
                    "saved" if root is not None else "NOT saved (no checkpoint_dir)")

    def _save(self, root: Path, task, step: int, epoch: int, metrics: dict,
              trace: tracecontext.Handoff) -> None:
        """Every rank calls this; process 0 writes the step and journals
        it, under the trace of the step it saves (``checkpoint``, and
        ``checkpoint.finalize`` from the manifest to the journal commit)."""
        coordinator = rt.process_index() == 0
        with trace.activate(), telemetry.span("checkpoint", step=step):
            _save(root, task, step, epoch, metrics, write=coordinator,
                  on_commit=lambda: self._journal("checkpoint", step=step,
                                                  checkpoint_dir=str(root.absolute())))

    def _log(self, metrics: dict, step: int) -> None:
        if self.tracker is not None:
            self.tracker.log_metrics(metrics, step)

    def _journal(self, event: str, **fields) -> None:
        """Append to the tracker's run journal, if the tracker keeps one
        (``RunStore`` does)."""
        if event == "checkpoint":
            hook = getattr(self.tracker, "journal_checkpoint", None)
            if hook is not None:
                hook(fields["step"], fields["checkpoint_dir"])
            return
        hook = getattr(self.tracker, "journal_event", None)
        if hook is not None:
            hook(event, **fields)

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
            for batch, _ in feeder:
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


class _StopVote:
    """The ranks' agreement on the step at which to stop for a preemption
    signal: a rank that stopped alone would leave the others blocked in
    their next all-reduce.

    One process: the local flag, at once. Several: each step all-reduces
    the local flag (MAX) and reads the vote of the step before, so every
    rank stops after the same step, one step after the signal. On NCCL the
    vote is copied to pinned memory behind an event, so reading it waits
    for the previous step only, never for the one just dispatched.
    """

    def __init__(self, device: torch.device):
        self.multi = rt.process_count() > 1
        self.cuda = self.multi and dist.get_backend() == "nccl"
        self.device = device if self.cuda else torch.device("cpu")
        self.pending = None

    def poll(self, local: bool) -> bool:
        if not self.multi:
            return local
        flag = torch.full((1,), float(local), device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        ready = None
        if self.cuda:
            host = torch.empty(1, pin_memory=True)
            host.copy_(flag, non_blocking=True)
            ready = torch.cuda.Event()
            # dsst: ignore[span-discipline] torch.cuda.Event.record: marks the pinned copy of the stop flag on the card, not a span record
            ready.record()
            flag = host
        previous, self.pending = self.pending, (flag, ready)
        if previous is None:
            return False
        flag, ready = previous
        if ready is not None:
            ready.synchronize()
        return bool(flag[0] > 0)

    def close(self) -> None:
        if self.pending is not None and self.pending[1] is not None:
            self.pending[1].synchronize()
        self.pending = None


def _gather_provenance(prov) -> list | None:
    """Every rank's row provenance of a discarded step, on every rank (a
    collective: all ranks reach the same verdict, so all call it)."""
    parts: list = [None] * rt.process_count()
    dist.all_gather_object(parts, prov)
    rows = [r for part in parts if part for r in part]
    return rows or None


def _optimizer_state(task) -> dict | None:
    """The optimizer's whole state, on rank 0 (``None`` elsewhere): a
    ZeRO-1 optimizer consolidates its shards there first, a collective
    that every rank must enter."""
    opt = task.optimizer
    if hasattr(opt, "consolidate_state_dict"):
        opt.consolidate_state_dict(to=0)
    return opt.state_dict() if rt.process_index() == 0 else None


def _deterministic_kernels(device: torch.device) -> None:
    """Bitwise replay on a card: cuDNN in its deterministic mode, with no
    autotuning (which may pick another algorithm from one run to the
    next). Both are process-wide settings; a CPU device needs neither."""
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True


def _save(root: Path, task, step: int, epoch: int, metrics: dict, *, write: bool = True,
          on_commit: Callable[[], None] | None = None):
    """Write checkpoint ``root/<step>/`` durably: its files and manifest in
    a temporary directory ``<step>.tmp-<pid>``, fsynced, then renamed into
    place, and ``on_commit()`` after the rename (the manifest, the rename
    and the commit are the ``checkpoint.finalize`` span). Every rank calls
    it; only the one with ``write`` writes. Returns the step's directory
    where this rank wrote it."""
    maybe_fail("checkpoint.save")
    gather = getattr(task, "checkpoint_state", None)  # a pipeline's stacked stages
    if gather is not None:
        model_state, optimizer_state = gather()
    else:
        optimizer_state = _optimizer_state(task)
        model_state = task.model.state_dict() if write else None
    if not write:
        return None
    root.mkdir(parents=True, exist_ok=True)
    final = root / str(step)
    tmp = root / f"{step}{durability.TMP_SUFFIX}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    scheduler = task.scheduler
    state = {
        "model": model_state,
        "optimizer": optimizer_state,
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        "step": step,
        "epoch": epoch,
        "metrics": metrics,
    }
    torch.save(state, tmp / (STATE_FILE + durability.TMP_SUFFIX))
    durability.durable_replace(tmp / (STATE_FILE + durability.TMP_SUFFIX), tmp / STATE_FILE,
                               kind="checkpoint")
    durability.durable_write_json(tmp / METRICS_FILE, metrics, kind="checkpoint")
    with telemetry.span("checkpoint.finalize", step=step):
        integrity.write_manifest(tmp)
        if final.exists():  # as orbax: another run's step, never overwritten
            shutil.rmtree(tmp)
            raise FileExistsError(f"checkpoint step {step} already exists under {root}; "
                                  "resume that run, or use another directory")
        # dsst: ignore[durable-write] a directory commit: every file inside was published durably above, and fsync_dir(root) below makes the rename itself durable (durable_replace publishes files)
        os.replace(tmp, final)
        durability.fsync_dir(root, kind="checkpoint")
        if on_commit is not None:
            on_commit()
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


def _restore_with_fallback(root: Path, task, record: bool = True, *,
                           steps: list[int] | None = None, model_only: bool = False) -> int:
    """Load the first usable step of ``steps`` (default: newest first)
    into ``task``, walking past corrupt ones: each step is verified
    against its manifest first, and a corrupt step, or one whose load
    raises anyway, is skipped with a ``checkpoint_fallback_total`` count
    (``record``: on one rank only). ``model_only``: the weights alone (the
    optimizer state is read with them and dropped). Returns the restored
    step."""
    if steps is None:
        steps = sorted(integrity.list_steps(root), reverse=True)
    last_exc = None
    for step in steps:
        status, problems = integrity.verify_step(root / str(step))
        if status == "corrupt":
            if record:
                integrity.record_fallback(step, "; ".join(problems))
            continue
        try:
            maybe_fail("checkpoint.restore")
            # On the host: load_state_dict copies to each parameter's device,
            # and Adam keeps its step counts on the CPU, as a fresh Adam does.
            state = torch.load(root / str(step) / STATE_FILE, map_location="cpu",
                               weights_only=True)
            if model_only:
                task.model.load_state_dict(state["model"])
                log.info("restored the weights of checkpoint step %d", state["step"])
                return int(state["step"])
            if hasattr(task, "load_checkpoint_state"):
                task.load_checkpoint_state(state["model"], state["optimizer"])
            else:
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


def restore_state(task, checkpoint_dir, *, step: int | None = None, prefer: str = "best",
                  best_metric: str | None = None, best_mode: str | None = None) -> int:
    """Restore a ``Trainer`` checkpoint's weights into ``task.model``
    outside the ``Trainer`` (inference, export); returns the step
    restored. The optimizer state is dropped.

    ``prefer="best"`` takes the best step by the tracked metric (the
    task's defaults apply), the latest when no step saved the metric;
    ``"latest"`` the newest. Steps are verified against their manifests:
    a corrupt preferred step falls back to the newest intact one, as the
    ``Trainer``'s resume walks, while a pinned ``step=`` that fails
    verification raises, since serving other weights than the ones asked
    for by name would be worse than an error.
    """
    if prefer not in ("best", "latest"):
        raise ValueError(f"prefer must be 'best' or 'latest', got {prefer!r}")
    root = Path(checkpoint_dir)
    all_steps = sorted(integrity.list_steps(root), reverse=True)
    if step is not None:
        if step not in all_steps:
            raise FileNotFoundError(f"no checkpoint step {step} under {checkpoint_dir} "
                                    f"(steps: {all_steps})")
        status, problems = integrity.verify_step(root / str(step))
        if status == "corrupt":
            raise ValueError(f"pinned checkpoint step {step} under {checkpoint_dir} "
                             f"fails integrity verification: {'; '.join(problems)}")
        return _restore_with_fallback(root, task, record=False, steps=[step], model_only=True)
    if not all_steps:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
    preferred = None
    if prefer == "best":
        cfg = TrainerConfig(best_metric=best_metric or task.default_best_metric,
                            best_mode=best_mode or task.default_best_mode)
        preferred = _best_on_disk(root, cfg)[1]
    order = ([preferred] if preferred is not None else []) + [
        s for s in all_steps if s != preferred]
    return _restore_with_fallback(root, task, steps=order, model_only=True)
