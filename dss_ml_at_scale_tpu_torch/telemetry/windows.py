"""Sliding-window quantile sketch: live p50/p99 over the last window.

Port copy of ``dss_ml_at_scale_tpu/telemetry/windows.py``, cut to what the
serving paths read: :class:`SlidingQuantile` (the registry's ``window``
kind and the SLO engine's sources) and :class:`WindowedCounter` (the
good/bad counts of the image tier's events objectives), with their wire
snapshots for ``GET /telemetry``. The wire merge (fleet federation) is
not ported yet.

A rotating ring of ``sub_windows`` digests, each a fixed log-bucket count
vector plus count/sum/min/max, merged on read. Memory is constant,
``observe`` is one bisect + one lock, and a quantile's value error is
bounded by one bucket's relative width (``10^(1/9)`` with the default
edges). Expiry is by sub-window: a reading covers between
``window_s - window_s/sub_windows`` and ``window_s`` of history.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Sequence

DEFAULT_WINDOW_S = 60.0
DEFAULT_SUB_WINDOWS = 6

# 9 edges per decade from 1 µs to 100 s: a p99 read off the sketch is
# within ±29% of the exact sample quantile.
SKETCH_PER_DECADE = 9
SKETCH_LO = 1e-6
SKETCH_HI = 100.0

DEFAULT_QUANTILES = (0.5, 0.9, 0.99)

# Wire-format version of to_wire(), shared with the registry's payloads.
WIRE_VERSION = 1


def sketch_edges(lo: float = SKETCH_LO, hi: float = SKETCH_HI,
                 per_decade: int = SKETCH_PER_DECADE) -> tuple[float, ...]:
    """Log-spaced sketch bucket edges."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    n = round(math.log10(hi / lo) * per_decade)
    edges = [float(f"{lo * 10 ** (i / per_decade):.6g}") for i in range(n + 1)]
    edges[-1] = float(f"{hi:.6g}")
    return tuple(edges)


class _RingState:
    """Rotation bookkeeping; every access happens under the owner's lock."""

    __slots__ = ("slots", "index", "start", "t0")

    def __init__(self, n: int, new_slot: Callable[[], object], now: float):
        self.slots = [new_slot() for _ in range(n)]
        self.index = 0
        self.start = now  # current sub-window's opening instant
        self.t0 = now     # series birth (clamps rate()'s denominator)

    def advance(self, now: float, dt: float,
                new_slot: Callable[[], object]) -> None:
        """Expire sub-windows the clock has moved past."""
        elapsed = now - self.start
        if elapsed < dt:
            return
        steps = int(elapsed // dt)
        n = len(self.slots)
        if steps >= n:  # idle longer than the whole window: clear all
            for i in range(n):
                self.slots[i] = new_slot()
        else:
            for _ in range(steps):
                self.index = (self.index + 1) % n
                self.slots[self.index] = new_slot()
        self.start += steps * dt

    def covered(self, now: float, window_s: float) -> float:
        """Wall seconds the live ring actually spans."""
        return max(min(window_s, now - self.t0), 1e-9)


class _Digest:
    """One sub-window: log-bucket counts, count/sum/min/max, and the trace
    id of the worst sample."""

    __slots__ = ("counts", "count", "sum", "mn", "mx", "worst_trace")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.mn = math.inf
        self.mx = -math.inf
        self.worst_trace: str | None = None

class WindowedCounter:
    """A windowed sum: how much of something happened in the last
    ``window_s`` seconds (requests, errors)."""

    _guarded_by_lock = ("_ring",)

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 sub_windows: int = DEFAULT_SUB_WINDOWS,
                 clock: Callable[[], float] | None = None):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if sub_windows < 2:
            raise ValueError(f"sub_windows must be >= 2, got {sub_windows}")
        self.window_s = float(window_s)
        self._dt = self.window_s / int(sub_windows)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._ring = _RingState(int(sub_windows), float, self._clock())

    def add(self, n: float = 1.0) -> None:
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, float)
            self._ring.slots[self._ring.index] += n

    def total(self) -> float:
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, float)
            return float(sum(self._ring.slots))

    def to_wire(self) -> dict:
        return {"v": WIRE_VERSION, "kind": "windowed_counter", "window_s": self.window_s,
                "total": self.total()}


class SlidingQuantile:
    """Sliding-window quantile sketch (constant memory)."""

    _guarded_by_lock = ("_ring",)

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 sub_windows: int = DEFAULT_SUB_WINDOWS,
                 edges: Sequence[float] | None = None,
                 clock: Callable[[], float] | None = None):
        self.edges = tuple(edges) if edges is not None else sketch_edges()
        if not self.edges or any(
            b <= a for a, b in zip(self.edges, self.edges[1:])
        ):
            raise ValueError("edges must be strictly increasing, non-empty")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if sub_windows < 2:
            raise ValueError(f"sub_windows must be >= 2, got {sub_windows}")
        self.window_s = float(window_s)
        self.sub_windows = int(sub_windows)
        self._dt = self.window_s / self.sub_windows
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._ring = _RingState(self.sub_windows, self._new_slot, self._clock())

    def _new_slot(self) -> _Digest:
        return _Digest(len(self.edges) + 1)

    def observe(self, v: float, trace: str | None = None) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, self._new_slot)
            d = self._ring.slots[self._ring.index]
            d.counts[i] += 1
            d.count += 1
            d.sum += v
            if v < d.mn:
                d.mn = v
            if v >= d.mx:
                d.mx = v
                if trace is not None:
                    d.worst_trace = trace

    def _merged(self) -> _Digest:
        """Fold the live ring into one digest (merge on read)."""
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, self._new_slot)
            out = _Digest(len(self.edges) + 1)
            for d in self._ring.slots:
                if d.count == 0:
                    continue
                for i, c in enumerate(d.counts):
                    out.counts[i] += c
                out.count += d.count
                out.sum += d.sum
                if d.mn < out.mn:
                    out.mn = d.mn
                if d.mx >= out.mx:
                    out.mx = d.mx
                    out.worst_trace = d.worst_trace
            return out

    def _quantile_of(self, d: _Digest, q: float) -> float | None:
        if d.count == 0:
            return None
        rank = q * (d.count - 1)  # numpy.percentile's linear rank rule
        cum = 0
        for i, c in enumerate(d.counts):
            if c == 0:
                continue
            if rank <= cum + c - 1:
                lo = self.edges[i - 1] if i > 0 else d.mn
                hi = self.edges[i] if i < len(self.edges) else d.mx
                frac = (rank - cum + 0.5) / c
                v = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return float(min(max(v, d.mn), d.mx))
            cum += c
        return float(d.mx)

    def quantile(self, q: float) -> float | None:
        """Windowed quantile estimate, or None on an empty window."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return self._quantile_of(self._merged(), q)

    def count(self) -> int:
        return self._merged().count

    def worst_trace(self) -> str | None:
        """Trace id of the worst sample still in the window."""
        return self._merged().worst_trace

    def to_wire(self) -> dict:
        """Versioned snapshot of the merged live digest plus its geometry
        (what ``GET /telemetry`` serves per window series)."""
        d = self._merged()
        return {
            "v": WIRE_VERSION,
            "kind": "sliding_quantile",
            "window_s": self.window_s,
            "edges": list(self.edges),
            "counts": list(d.counts),
            "count": d.count,
            "sum": d.sum,
            "min": d.mn if d.count else None,
            "max": d.mx if d.count else None,
            "worst_trace": d.worst_trace,
        }

    def snapshot(self, qs: Sequence[float] = DEFAULT_QUANTILES) -> dict:
        """One JSON-ready windowed summary (the registry's ``window``
        sample shape)."""
        d = self._merged()
        now = self._clock()
        with self._lock:
            covered = self._ring.covered(now, self.window_s)
        return {
            "window_s": self.window_s,
            "count": d.count,
            "sum": d.sum,
            "rate": d.count / covered,
            "mean": (d.sum / d.count) if d.count else None,
            "min": d.mn if d.count else None,
            "max": d.mx if d.count else None,
            "quantiles": {
                f"{q:g}": self._quantile_of(d, q) for q in qs
            },
        }
