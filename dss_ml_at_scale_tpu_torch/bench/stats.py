"""Noise-aware statistics for the bench harness: median/MAD + verdicts.

Port copy of ``dss_ml_at_scale_tpu/bench/stats.py`` (which imports no JAX):
the same method, floors and verdict words, so the two packages judge one
sample set alike.

A throughput sample on a shared host is a draw from a noisy
distribution, not a number, so the regression gate never compares two
single runs. Every scenario repetition contributes one sample, warmup
repetitions are discarded (cold caches, first-touch page faults, lazy
imports, kernel builds), the summary is **median + MAD** (both robust to
the one stalled repetition a busy box produces), and the regression
tolerance is *derived from the measured dispersion* of both sides rather
than hardcoded: a scenario that measures steadily is held to a tight band,
a jittery one gets the band its own noise demands, never less than the
metric's declared floor, so a quiet run cannot ratchet the gate into
flakiness.

The verdict vocabulary (:func:`classify`):

- ``regression``: the current median is outside the noise band on the
  *bad* side of the metric's declared direction; fails the run.
- ``improvement``: outside the band on the good side; reported (and a
  hint to re-baseline) but never a failure.
- ``within-noise``: inside the band.
- ``no-baseline``: nothing committed for this metric under the current
  environment fingerprint yet.
- ``informational``: the metric's schema declares ``gate=False``; it is
  recorded in artifacts and the baseline but never judged.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..telemetry.windows import quantile

# A regression must clear BOTH the relative floor and this many
# combined-MAD units: the classic robust-z idiom (MAD ~ 0.6745 sigma for a
# normal distribution, so 4 MADs ~ 2.7 sigma).
MAD_MULTIPLIER = 4.0

# Default relative floor: back-to-back throughput runs of the same code on
# a shared host routinely differ by 15-25%; a floor below that would gate
# on scheduler noise. Individual metrics can declare a tighter or looser
# floor in their schema.
DEFAULT_REL_FLOOR = 0.35


def discard_warmup(samples: Sequence, warmup: int) -> list:
    """Drop the first ``warmup`` entries: the cold repetitions every
    scenario pays once (kernel builds, page cache, thread-pool spin-up)."""
    if warmup < 0:
        raise ValueError("warmup must be >= 0")
    return list(samples[warmup:])


def median(xs: Sequence[float]) -> float:
    # The shared quantile helper (telemetry.windows): q=0.5 under linear
    # rank interpolation is the classic midpoint median, and one source of
    # quantile math keeps the bench verdicts and the live sketches alike.
    if not xs:
        raise ValueError("median of no samples")
    return quantile(xs, 0.5)


def mad(xs: Sequence[float], center: float | None = None) -> float:
    """Median absolute deviation around ``center`` (default: median)."""
    if not xs:
        raise ValueError("mad of no samples")
    c = median(xs) if center is None else center
    return median([abs(x - c) for x in xs])


@dataclasses.dataclass(frozen=True)
class Summary:
    """One metric's robust summary over a scenario's repetitions."""

    median: float
    mad: float
    n: int

    def to_json(self) -> dict:
        return {"median": self.median, "mad": self.mad, "n": self.n}


def summarize(samples: Sequence[float]) -> Summary:
    m = median(samples)
    return Summary(median=m, mad=mad(samples, m), n=len(samples))


def tolerance(current: Summary, baseline: Summary, *,
              floor: float = DEFAULT_REL_FLOOR,
              k: float = MAD_MULTIPLIER) -> float:
    """Relative noise band around the baseline median.

    ``k`` times the larger of the two *relative* dispersions (each side's
    MAD over its OWN median: the noisier side sets the band), floored at
    the metric's declared minimum. Normalizing the current MAD by the
    *baseline* median would let a large regression inflate its own
    tolerance (noise scales with the regressed value) and pass as
    within-noise.
    """
    base = abs(baseline.median)
    if base == 0.0:
        return floor
    rel_cur = (
        current.mad / abs(current.median) if current.median else 0.0
    )
    spread = k * max(rel_cur, baseline.mad / base)
    return max(floor, spread)


def classify(direction: str, current: Summary, baseline: Summary | None,
             *, gate: bool = True, floor: float = DEFAULT_REL_FLOOR,
             k: float = MAD_MULTIPLIER) -> dict:
    """Verdict for one metric vs its committed baseline entry.

    Returns ``{"verdict", "rel_change", "tolerance"}`` (the latter two
    absent when there is no baseline). ``direction`` is the schema's
    ``"higher"``/``"lower"``-is-better declaration.
    """
    if direction not in ("higher", "lower"):
        raise ValueError(f"direction must be 'higher' or 'lower', "
                         f"got {direction!r}")
    if not gate:
        return {"verdict": "informational"}
    if baseline is None or baseline.n == 0:
        return {"verdict": "no-baseline"}
    if baseline.median == 0.0:
        # A zero baseline carries no scale to judge against.
        return {"verdict": "no-baseline"}
    tol = tolerance(current, baseline, floor=floor, k=k)
    rel = (current.median - baseline.median) / abs(baseline.median)
    bad = rel < -tol if direction == "higher" else rel > tol
    good = rel > tol if direction == "higher" else rel < -tol
    verdict = "regression" if bad else (
        "improvement" if good else "within-noise"
    )
    return {
        "verdict": verdict,
        "rel_change": round(rel, 4),
        "tolerance": round(tol, 4),
    }
