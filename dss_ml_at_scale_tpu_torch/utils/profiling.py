"""Step timing: the port of ``dss_ml_at_scale_tpu/utils/profiling.py::StepTimer``.

The JAX module's ``jax.profiler`` trace hooks have no counterpart here yet;
``torch.profiler`` is used directly where a trace is wanted.
"""

from __future__ import annotations

import time


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
