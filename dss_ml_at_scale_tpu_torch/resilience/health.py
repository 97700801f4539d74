"""Training-health supervision: non-finite/spike detection + policy ladder.

Port of ``dss_ml_at_scale_tpu/resilience/health.py``. One NaN gradient
(a bad sample, an overflow) poisons Adam's moments and the run keeps
"succeeding" on garbage, or a loss spike knocks the model off its
trajectory. This module makes the recovery automatic and deterministic:

- **Signals** (:func:`guard_signals`): every supervised step computes
  ``isfinite`` of the loss and of the gradients' global norm and an EWMA
  mean/variance z-score of the loss, on 0-d tensors on the step's device,
  with the JAX guard's arithmetic; the tiny :class:`HealthState` carries
  the EWMA. In a run of several ranks the loss and the norm are summed
  over the ranks first (one all-reduce of two floats), so every rank
  judges the same numbers and reaches the same verdict.
- **Discard before commit** (:func:`guard_train_step`): JAX selects
  between the new and the old state inside one jitted program. Eager
  PyTorch mutates in place, so the port splits a task's step into
  ``compute_update`` (forward, backward, the gradients' norm) and
  ``commit_update`` (``optimizer.step()``, the schedule, the step count)
  and reads the verdict between the two: one host sync per supervised
  step. A bad step never reaches ``optimizer.step()``, so parameters,
  Adam's moments and step, the schedule and ``task.step`` stay as they
  were; the BatchNorm running statistics, which the forward updates, are
  copied aside before it (:class:`BufferSnapshot`, one multi-tensor copy)
  and put back. A kernel failure is no verdict: it raises.
- **Host policy ladder** (:class:`HealthSupervisor`): the first response
  is always discard-and-skip (the batch's provenance is quarantined);
  under ``policy="rollback"`` a streak of more than
  ``max_consecutive_skips`` bad steps escalates to restoring the newest
  manifest-intact checkpoint; after ``max_rollbacks`` restores the run
  aborts with a diagnostic bundle (``policy="abort"`` aborts on the first
  bad step).

Fault sites ``grads.nonfinite`` and ``loss.spike`` (value faults,
:func:`~.faults.fault_fires`) poison the loss and grad-norm *signals*
after the real gradients were computed, exactly as the JAX guard does;
the gradients themselves are not touched.

Counters: ``nonfinite_steps_total``, ``loss_spikes_total``,
``health_rollbacks_total``, ``quarantined_batches_total``; rollbacks also
record a ``health_rollback`` span.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import time
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from .. import telemetry
from ..runtime import distributed as rt
from . import durability
from .faults import active_plan, fault_fires

log = logging.getLogger(__name__)

# Verdict codes of the guarded step (metrics["health_verdict"]).
VERDICT_OK = 0
VERDICT_NONFINITE = 1
VERDICT_SPIKE = 2

# Injection codes fed to the guarded step's ``inject`` argument.
INJECT_NONE = 0
INJECT_NONFINITE = 1
INJECT_SPIKE = 2

_VERDICT_NAMES = {VERDICT_NONFINITE: "nonfinite", VERDICT_SPIKE: "spike"}


class TrainingHealthError(RuntimeError):
    """Training aborted by the health policy ladder.

    ``bundle_path`` points at the diagnostic bundle when one was written
    (a checkpoint dir was configured), else None.
    """

    def __init__(self, message: str, bundle_path: str | None = None):
        super().__init__(message)
        self.bundle_path = bundle_path


@dataclasses.dataclass
class HealthConfig:
    """Knobs for the supervised training loop (the JAX ``HealthConfig``).

    ``policy``: ``skip`` discards bad updates and keeps going;
    ``rollback`` escalates to restore-newest-intact-checkpoint, aborting
    after ``max_rollbacks``; ``abort`` stops on the first bad step.
    ``max_consecutive_skips`` is the number of consecutive bad steps
    tolerated as plain skips: the (N+1)-th escalates (rollback under
    ``rollback``; abort under ``skip``, so a fully poisoned stream cannot
    spin forever).
    """

    policy: str = "skip"
    # Spike detector: |loss - ewma_mean| > spike_zscore * ewma_std, armed
    # after warmup_steps observations; min_spike_std floors the std so a
    # flat loss cannot divide by ~0.
    spike_zscore: float = 6.0
    ewma_alpha: float = 0.1
    warmup_steps: int = 20
    min_spike_std: float = 1e-3
    # Policy ladder.
    max_consecutive_skips: int = 3
    max_rollbacks: int = 2
    # Metric keys the guard reads from the task's step output.
    loss_key: str = "train_loss"
    grad_norm_key: str = "grad_norm"
    # Where quarantined batch provenance is persisted (a
    # resilience.rollback.QuarantineList), or None to only count/skip.
    quarantine: Any = None
    # Magnitude of the injected loss spike (site loss.spike).
    inject_spike_delta: float = 1e4

    def __post_init__(self):
        if self.policy not in ("skip", "rollback", "abort"):
            raise ValueError(
                f"health policy must be skip|rollback|abort, got {self.policy!r}"
            )


@dataclasses.dataclass
class HealthState:
    """EWMA loss statistics: 0-d tensors on the step's device."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, device="cpu") -> "HealthState":
        return cls(
            mean=torch.zeros((), dtype=torch.float32, device=device),
            var=torch.zeros((), dtype=torch.float32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )


def guard_signals(metrics: dict, h: HealthState, cfg: HealthConfig,
                  inject: int) -> tuple[dict, HealthState, torch.Tensor]:
    """The JAX guard's arithmetic on one step's metrics.

    Returns ``(metrics', h', verdict)``: the metrics with the (possibly
    poisoned, rank-reduced) loss, the grad norm, ``loss_zscore`` and the
    0-d int32 ``verdict`` tensor; ``h'`` is the EWMA state to keep if the
    step commits. No host sync here.
    """
    loss = metrics[cfg.loss_key].detach().float()
    # Value-fault injection: poison the signals after the real gradients
    # were computed, as a NaN gradient would present.
    if inject == INJECT_NONFINITE:
        loss = torch.full_like(loss, math.nan)
    elif inject == INJECT_SPIKE:
        loss = loss + cfg.inject_spike_delta
    gn = metrics.get(cfg.grad_norm_key)
    if gn is not None:
        gn = gn.detach().float()
        if inject == INJECT_NONFINITE:
            gn = torch.full_like(gn, math.nan)
    world = rt.process_count()
    if world > 1:
        # The ranks' losses differ; their sum (and a NaN anywhere) is the
        # same number on every rank, so every rank reaches one verdict.
        signals = torch.stack([loss, gn if gn is not None else torch.zeros_like(loss)])
        dist.all_reduce(signals)
        loss = signals[0] / world
        finite = torch.isfinite(signals).all()
    else:
        finite = torch.isfinite(loss)
        if gn is not None:
            finite = finite & torch.isfinite(gn)
    std = torch.sqrt(torch.clamp_min(h.var, cfg.min_spike_std ** 2))
    z = torch.abs(loss - h.mean) / std
    armed = h.count >= cfg.warmup_steps
    spike = armed & (z > cfg.spike_zscore) & finite
    verdict = torch.where(
        ~finite, VERDICT_NONFINITE,
        torch.where(spike, VERDICT_SPIKE, VERDICT_OK)).to(torch.int32)
    delta = torch.where(finite, loss - h.mean, torch.zeros_like(loss))
    new_h = HealthState(
        mean=h.mean + cfg.ewma_alpha * delta,
        var=(1.0 - cfg.ewma_alpha) * (h.var + cfg.ewma_alpha * delta ** 2),
        count=h.count + 1,
    )
    out = {**metrics, cfg.loss_key: loss, "loss_zscore": z}
    if gn is not None:
        out[cfg.grad_norm_key] = gn
    return out, new_h, verdict


class BufferSnapshot:
    """A copy of a module's buffers (the BatchNorm running statistics),
    taken before a step's forward and put back when its update is
    discarded: one multi-tensor copy each way into storage allocated
    once."""

    def __init__(self, module: torch.nn.Module):
        self.live = list(module.buffers())
        self.saved = [torch.empty_like(b) for b in self.live]

    def save(self) -> None:
        if self.live:
            torch._foreach_copy_(self.saved, self.live)

    def restore(self) -> None:
        if self.live:
            torch._foreach_copy_(self.live, self.saved)


def guard_train_step(task, cfg: HealthConfig):
    """Wrap a task's step with health supervision.

    Returns ``guarded(h, batch, inject) -> (h', metrics)``, the
    counterpart of the JAX ``guard_train_step``: the task computes its
    gradients, the guard judges the signals, reads the verdict (the one
    host sync) and either commits the update and the new EWMA state, or
    discards both and puts the buffers back. ``metrics["health_verdict"]``
    is the verdict as a Python int.
    """
    snapshot = BufferSnapshot(task.model)

    def guarded(h: HealthState, batch, inject: int):
        snapshot.save()
        metrics = task.compute_update(batch)
        metrics, new_h, verdict = guard_signals(metrics, h, cfg, inject)
        metrics["health_verdict"] = code = int(verdict)
        if code == VERDICT_OK:
            task.commit_update()
            return new_h, metrics
        # Discard: the update and the detector update alike; a spike must
        # not widen the band it just tripped.
        snapshot.restore()
        return h, metrics

    return guarded


class HealthSupervisor:
    """Host half: verdict bookkeeping, quarantine, the policy ladder."""

    def __init__(self, cfg: HealthConfig):
        self.cfg = cfg
        self.bad_streak = 0
        self.rollbacks = 0
        self.skipped_steps = 0
        self.recent: collections.deque = collections.deque(maxlen=64)
        # Registered eagerly so /metrics renders the families (as zeros)
        # before the first incident.
        self._nonfinite = telemetry.counter(
            "nonfinite_steps_total",
            "train steps discarded for a non-finite loss/grad-norm",
        )
        self._spikes = telemetry.counter(
            "loss_spikes_total",
            "train steps discarded by the EWMA loss-spike detector",
        )
        self._rollback_counter = telemetry.counter(
            "health_rollbacks_total",
            "checkpoint rollbacks performed by the health supervisor",
        )
        self._quarantined = telemetry.counter(
            "quarantined_batches_total",
            "poison batches whose provenance was quarantined",
        )

    # -- per-step ---------------------------------------------------------

    def next_injection(self) -> int:
        """Injection code for the next step, per the active fault plan."""
        if fault_fires("grads.nonfinite"):
            return INJECT_NONFINITE
        if fault_fires("loss.spike"):
            return INJECT_SPIKE
        return INJECT_NONE

    def observe(self, step: int, metrics, provenance=None) -> str:
        """Digest one step's verdict → ``commit|skip|rollback|abort``.

        ``step`` is the step the update would have committed as;
        ``provenance`` the batch's RowRange list, if the reader supplied
        one.
        """
        verdict = int(metrics["health_verdict"])
        if verdict == VERDICT_OK:
            self.bad_streak = 0
            return "commit"

        loss = float(metrics[self.cfg.loss_key])
        z = float(metrics.get("loss_zscore", 0.0))
        kind = _VERDICT_NAMES[verdict]
        self.recent.append({"step": step, "verdict": kind, "loss": loss, "zscore": z})
        (self._nonfinite if verdict == VERDICT_NONFINITE else self._spikes).inc()
        self.skipped_steps += 1
        self.bad_streak += 1
        log.warning(
            "health: %s at step %d (loss=%g z=%g); update discarded (streak %d)",
            kind, step, loss, z, self.bad_streak,
        )
        if provenance and self.cfg.quarantine is not None:
            # Counted only when the provenance lands on the blocklist.
            self.cfg.quarantine.add(
                provenance, reason=f"{kind} at step {step} (loss={loss!r})", step=step,
            )
            self._quarantined.inc()
        if self.cfg.policy == "abort":
            return "abort"
        if self.bad_streak > self.cfg.max_consecutive_skips:
            if self.cfg.policy == "rollback" and self.rollbacks < self.cfg.max_rollbacks:
                return "rollback"
            return "abort"
        return "skip"

    def record_rollback(self, from_step: int, to_step: int,
                        t0_wall: float, duration: float) -> None:
        self.rollbacks += 1
        self.bad_streak = 0
        self._rollback_counter.inc()
        telemetry.get_span_log().record(
            "health_rollback", t0_wall, duration, from_step=from_step, to_step=to_step,
        )
        log.warning(
            "health: rolled back from step %d to checkpoint step %d (rollback %d/%d)",
            from_step, to_step, self.rollbacks, self.cfg.max_rollbacks,
        )

    # -- abort ------------------------------------------------------------

    def abort(self, step: int, reason: str, bundle_dir: str | None) -> TrainingHealthError:
        """Build the abort error, writing the diagnostic bundle
        ``health_abort_step<N>.json`` (durably) if a directory is given
        and this is process 0. The caller raises the return value."""
        bundle_path = None
        quarantine = self.cfg.quarantine
        bundle = {
            "reason": reason,
            "step": step,
            "policy": self.cfg.policy,
            "rollbacks": self.rollbacks,
            "skipped_steps": self.skipped_steps,
            "bad_streak": self.bad_streak,
            "spike_zscore": self.cfg.spike_zscore,
            "recent_incidents": list(self.recent),
            "quarantine_file": str(quarantine.path) if quarantine is not None else None,
            "quarantined_entries": len(quarantine) if quarantine is not None else 0,
            "fault_plan_stats": active_plan().stats() if active_plan() is not None else None,
            "time": time.time(),
        }
        if bundle_dir is not None:
            path = Path(bundle_dir) / f"health_abort_step{step}.json"
            if rt.process_index() == 0:
                try:
                    path.parent.mkdir(parents=True, exist_ok=True)
                    # Non-finite floats as strings: strict JSON readers
                    # choke on bare NaN tokens.
                    durability.durable_write_json(path, _json_safe(bundle), indent=1,
                                                  kind="bundle")
                except OSError:
                    log.exception("could not write health diagnostic bundle")
                    path = None
            bundle_path = str(path) if path is not None else None
        log.error("health: aborting training at step %d: %s", step, reason)
        return TrainingHealthError(
            f"training aborted by health supervisor at step {step}: {reason}"
            + (f" (diagnostic bundle: {bundle_path})" if bundle_path else ""),
            bundle_path=bundle_path,
        )


def _json_safe(obj):
    """Replace non-finite floats with their string spelling ('nan',
    'inf', '-inf') so the document stays strictly valid JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj
