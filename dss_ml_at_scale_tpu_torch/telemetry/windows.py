"""Sliding-window telemetry primitives: quantile sketches + windowed series.

Port copy of ``dss_ml_at_scale_tpu/telemetry/windows.py`` (the JAX
package's module imports nothing of JAX, but the port keeps its own copy).
An SLO is a statement about now, not about the whole process lifetime, so
the live runtime needs *windowed* signals ("serving p99 over the last
60 s", "feeder stall fraction over the last 30 s"):

- :func:`quantile`: the one quantile definition (linear interpolation
  between closest ranks, ``numpy.percentile``'s default); the live sketch
  interpolates within a bucket by the same rank rule.
- :class:`SlidingQuantile`: a mergeable quantile sketch over a sliding
  window: a rotating ring of ``sub_windows`` digests, each a fixed
  log-bucket count vector plus count/sum/min/max, merged on read. Memory
  is constant, ``observe`` is one bisect + one lock, and a quantile's
  value error is bounded by one bucket's relative width
  (``10^(1/per_decade)`` with the default log edges). Expiry is by
  sub-window: a reading covers between ``window_s - window_s/sub_windows``
  and ``window_s`` of history.
- :class:`WindowedCounter`: a windowed sum (event counts, stall seconds):
  ``add``/``total``/``rate`` over the same rotating ring.

Both carry a versioned wire form (``to_wire``) and fold a peer's in
(``merge_wire``, loud on any geometry mismatch): what ``GET /telemetry``
serves and the fleet aggregator (:mod:`.federation`) merges.

Thread-safety: one lock per instance; every public method takes it. The
ring bookkeeping lives in a plain :class:`_RingState` owned under that
lock.

These primitives are the registry's ``window`` kind (rendered as a
Prometheus *summary* restricted to the window on ``/metrics``) and what
:mod:`.slo` computes burn rates from.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Iterable, Sequence

DEFAULT_WINDOW_S = 60.0
DEFAULT_SUB_WINDOWS = 6

# Default sketch edges: 9 per decade from 1 µs to 100 s. Denser than
# the histogram default (3/decade) because the sketch's *value* error
# is one bucket's relative width: 10^(1/9) ≈ 1.29, i.e. a p99 read off
# the sketch is within ±29% of the exact sample quantile — tight enough
# to judge a latency budget, cheap enough to keep 6 sub-windows of.
SKETCH_PER_DECADE = 9
SKETCH_LO = 1e-6
SKETCH_HI = 100.0

DEFAULT_QUANTILES = (0.5, 0.9, 0.99)

# Wire-format version for to_wire()/merge_wire(): bumped if the payload
# layout ever changes, so a mixed-version fleet fails its merges loudly
# instead of silently misfolding digests.
WIRE_VERSION = 1


def _check_wire(wire, kind: str, window_s: float) -> None:
    """Shared merge_wire validation: version, kind tag, and window
    geometry must match EXACTLY — the histogram-bucket precedent
    (:meth:`~.registry.MetricsRegistry._get` raises on mismatched
    buckets rather than silently forking a series)."""
    if not isinstance(wire, dict):
        raise ValueError(f"wire payload must be a dict, got {type(wire)}")
    v = wire.get("v")
    if v != WIRE_VERSION:
        raise ValueError(
            f"wire version mismatch: expected {WIRE_VERSION}, got {v!r}"
        )
    if wire.get("kind") != kind:
        raise ValueError(
            f"wire kind mismatch: expected {kind!r}, "
            f"got {wire.get('kind')!r}"
        )
    if float(wire.get("window_s", -1.0)) != window_s:
        raise ValueError(
            f"wire window geometry mismatch: this series has "
            f"window_s={window_s}, wire carries {wire.get('window_s')!r}"
        )


def quantile(samples: Sequence[float], q: float) -> float:
    """Exact quantile of ``samples``: linear interpolation between
    closest ranks (``numpy.percentile``'s default method).

    The live sketch's within-bucket interpolation uses the same rank
    rule, so a live p99 and an offline p99 over the same samples agree
    up to the sketch's bounded bucket error.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    xs = sorted(samples)
    if not xs:
        raise ValueError("quantile of no samples")
    rank = q * (len(xs) - 1)
    lo = int(math.floor(rank))
    frac = rank - lo
    if frac == 0.0 or lo + 1 >= len(xs):
        return float(xs[lo])
    return float(xs[lo] + (xs[lo + 1] - xs[lo]) * frac)


def sketch_edges(lo: float = SKETCH_LO, hi: float = SKETCH_HI,
                 per_decade: int = SKETCH_PER_DECADE) -> tuple[float, ...]:
    """Log-spaced sketch bucket edges (same construction as the
    histogram's :func:`~.registry.log_buckets`, denser by default)."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    n = round(math.log10(hi / lo) * per_decade)
    edges = [float(f"{lo * 10 ** (i / per_decade):.6g}") for i in range(n + 1)]
    edges[-1] = float(f"{hi:.6g}")
    return tuple(edges)


class _RingState:
    """Rotation bookkeeping for one windowed series. Plain data: every
    access happens under the owning series' lock (the owner declares
    ``_ring`` in its lock-discipline contract); rotation math lives
    here so the locked public methods stay lexically simple."""

    __slots__ = ("slots", "index", "start", "t0")

    def __init__(self, n: int, new_slot: Callable[[], object],
                 now: float):
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
        """Wall seconds the live ring actually spans (a young series
        has not yet covered its full window)."""
        return max(min(window_s, now - self.t0), 1e-9)


class _Windowed:
    """Shared shell: window geometry, the clock, the lock, the ring."""

    _guarded_by_lock = ("_ring",)

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 sub_windows: int = DEFAULT_SUB_WINDOWS,
                 clock: Callable[[], float] | None = None):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if sub_windows < 2:
            raise ValueError(
                f"sub_windows must be >= 2, got {sub_windows}"
            )
        self.window_s = float(window_s)
        self.sub_windows = int(sub_windows)
        self._dt = self.window_s / self.sub_windows
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._ring = _RingState(
            self.sub_windows, self._new_slot, self._clock()
        )

    def _new_slot(self):  # pragma: no cover - subclasses implement
        raise NotImplementedError

    def reset(self) -> None:
        with self._lock:
            self._ring = _RingState(
                self.sub_windows, self._new_slot, self._clock()
            )


class WindowedCounter(_Windowed):
    """A windowed sum: how much of something happened in the last
    ``window_s`` seconds (requests, errors, stall seconds)."""

    def _new_slot(self) -> float:
        return 0.0

    def add(self, n: float = 1.0) -> None:
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, self._new_slot)
            self._ring.slots[self._ring.index] += n

    def total(self) -> float:
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, self._new_slot)
            return float(sum(self._ring.slots))

    def rate(self) -> float:
        """Events (or units) per second over the covered window."""
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, self._new_slot)
            return (
                sum(self._ring.slots)
                / self._ring.covered(now, self.window_s)
            )

    def to_wire(self) -> dict:
        """Versioned mergeable snapshot of the live window (the
        ``/telemetry`` federation payload)."""
        return {
            "v": WIRE_VERSION,
            "kind": "windowed_counter",
            "window_s": self.window_s,
            "total": self.total(),
        }

    def merge_wire(self, wire: dict) -> None:
        """Fold a peer replica's :meth:`to_wire` payload into this
        counter's CURRENT sub-window. Geometry/version mismatch raises
        (the histogram-bucket precedent: fail loudly, never fork)."""
        _check_wire(wire, "windowed_counter", self.window_s)
        total = float(wire["total"])
        if total:
            self.add(total)


class _Digest:
    """One sub-window's mergeable summary: log-bucket counts plus
    count/sum/min/max and the trace id of the worst sample (what lets
    an SLO alert point its flow arrow at an offending request)."""

    __slots__ = ("counts", "count", "sum", "mn", "mx", "worst_trace")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.mn = math.inf
        self.mx = -math.inf
        self.worst_trace: str | None = None


class SlidingQuantile(_Windowed):
    """Mergeable sliding-window quantile sketch (constant memory).

    A rotating ring of :class:`_Digest` sub-windows; ``observe`` lands
    in the current sub-window (one bisect + one lock, the same cost as
    a histogram observe), reads merge the live ring. Quantiles invert
    the merged cumulative counts at :func:`quantile`'s rank rule and
    interpolate within the landing bucket, clamped to the window's
    observed min/max — value error is bounded by one bucket's relative
    width, rank error by the landing bucket's occupancy.
    """

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 sub_windows: int = DEFAULT_SUB_WINDOWS,
                 edges: Sequence[float] | None = None,
                 clock: Callable[[], float] | None = None):
        self.edges = tuple(edges) if edges is not None else sketch_edges()
        if not self.edges or any(
            b <= a for a, b in zip(self.edges, self.edges[1:])
        ):
            raise ValueError("edges must be strictly increasing, non-empty")
        super().__init__(window_s, sub_windows, clock)

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
        """Fold the live ring into one digest (called on every read —
        merge-on-read is what keeps observe at histogram cost)."""
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
        rank = q * (d.count - 1)  # the shared quantile() rank rule
        cum = 0
        for i, c in enumerate(d.counts):
            if c == 0:
                continue
            # This bucket holds sample ranks [cum, cum + c - 1]; a
            # fractional rank past the bucket's last sample belongs to
            # the next occupied bucket (the interpolation target).
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

    def quantiles(self, qs: Iterable[float]) -> dict[float, float | None]:
        d = self._merged()
        return {q: self._quantile_of(d, q) for q in qs}

    def count(self) -> int:
        return self._merged().count

    def sum_(self) -> float:
        return self._merged().sum

    def mean(self) -> float | None:
        d = self._merged()
        return (d.sum / d.count) if d.count else None

    def max_(self) -> float | None:
        d = self._merged()
        return d.mx if d.count else None

    def min_(self) -> float | None:
        d = self._merged()
        return d.mn if d.count else None

    def worst_trace(self) -> str | None:
        """Trace id of the worst sample still in the window, if the
        observer supplied one — the alert machinery's flow-arrow
        anchor."""
        return self._merged().worst_trace

    def rate(self) -> float:
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, self._new_slot)
            n = sum(d.count for d in self._ring.slots)
            return n / self._ring.covered(now, self.window_s)

    def to_wire(self) -> dict:
        """Versioned mergeable snapshot: the merged live digest plus
        the sketch geometry a receiver needs to verify before folding
        (edges + window). This is what ``GET /telemetry`` serves per
        window series and what the fleet aggregator merges."""
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

    def merge_wire(self, wire: dict) -> None:
        """Fold a peer replica's :meth:`to_wire` digest into the CURRENT
        sub-window. Bucket edges and window length must match exactly —
        merging counts across different edge vectors would silently
        corrupt every quantile, so a mismatch raises (the
        histogram-bucket precedent)."""
        _check_wire(wire, "sliding_quantile", self.window_s)
        edges = tuple(float(e) for e in wire.get("edges", ()))
        if edges != self.edges:
            raise ValueError(
                "wire sketch geometry mismatch: this sketch has "
                f"{len(self.edges)} edges "
                f"[{self.edges[0]:g}..{self.edges[-1]:g}], wire carries "
                f"{len(edges)} edge(s)"
            )
        counts = wire.get("counts")
        if not isinstance(counts, list) or \
                len(counts) != len(self.edges) + 1:
            raise ValueError(
                f"wire sketch counts mismatch: expected "
                f"{len(self.edges) + 1} buckets, got "
                f"{len(counts) if isinstance(counts, list) else counts!r}"
            )
        n = int(wire["count"])
        if n <= 0:
            return  # empty window: nothing to fold
        mn, mx = float(wire["min"]), float(wire["max"])
        now = self._clock()
        with self._lock:
            self._ring.advance(now, self._dt, self._new_slot)
            d = self._ring.slots[self._ring.index]
            for i, c in enumerate(counts):
                d.counts[i] += int(c)
            d.count += n
            d.sum += float(wire["sum"])
            if mn < d.mn:
                d.mn = mn
            if mx >= d.mx:
                d.mx = mx
                trace = wire.get("worst_trace")
                if trace is not None:
                    d.worst_trace = str(trace)

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


def quantile_of_wire(wire: dict, q: float) -> float | None:
    """Quantile straight off one :meth:`SlidingQuantile.to_wire`
    payload (no merging): what renders a single replica's live p99
    column in ``top --fleet``. Validation rides the same
    merge_wire path, so a malformed payload fails identically."""
    sk = SlidingQuantile(
        window_s=float(wire.get("window_s", DEFAULT_WINDOW_S)),
        edges=wire.get("edges") or None,
    )
    sk.merge_wire(wire)
    return sk.quantile(q)
