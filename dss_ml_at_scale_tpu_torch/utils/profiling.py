"""Profiling hooks and step timing: the port of
``dss_ml_at_scale_tpu/utils/profiling.py``.

- :func:`trace`: a ``torch.profiler`` trace of the enclosed block, written
  as a Chrome trace (``chrome://tracing``, Perfetto) into a directory, where
  the JAX module writes a ``jax.profiler`` trace for TensorBoard. It records
  the host's ops and, where a card is present, its kernels.
- :func:`annotate`: a named span (``record_function``), so that phases such
  as decode, transfer and the train step show up labelled in the trace.
- :class:`StepTimer`: per-step wall time.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str | os.PathLike) -> Iterator[Path]:
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``logdir/trace_<pid>.json`` when the block ends (the
    path is what the context yields). CUDA activity is recorded when a card
    is available."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir) / f"trace_{os.getpid()}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield out
    prof.export_chrome_trace(str(out))


def annotate(name: str):
    """A named trace span: ``with annotate("decode"): ...``."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step wall-time recorder (one epoch's steps).

    ``tick()`` marks a step boundary; intervals between consecutive ticks
    are recorded, but the first interval after construction is discarded (it
    carries the first step's warm-up). It does not synchronize with the device: call
    :meth:`summary` after a synchronize for honest totals.
    """

    def __init__(self):
        self._times: list[float] = []
        self._last: float | None = None
        self._skip_next = True

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            if self._skip_next:
                self._skip_next = False
            else:
                self._times.append(now - self._last)
        self._last = now

    def summary(self) -> dict[str, float]:
        """Mean / p50 / p90 / max step seconds and steps/sec."""
        xs = self._times
        if not xs:
            return {}
        xs_sorted = sorted(xs)
        n = len(xs_sorted)
        mean = sum(xs_sorted) / n
        return {
            "step_time_mean_s": mean,
            "step_time_p50_s": xs_sorted[n // 2],
            "step_time_p90_s": xs_sorted[min(n - 1, (9 * n) // 10)],
            "step_time_max_s": xs_sorted[-1],
            "steps_per_sec": 1.0 / mean if mean > 0 else float("inf"),
        }
