"""Process-local metrics registry: Counter / Gauge / Histogram / Window.

Port copy of ``dss_ml_at_scale_tpu/telemetry/registry.py``, cut to what the
LM serving path uses: the four kinds, the Prometheus text renderer
(``GET /metrics``), the JSON snapshot, and the raw wire snapshot
(``GET /telemetry``). Merging a peer's wire snapshot (fleet federation) and
the sampled observer are not ported yet.

The reference's only metric sink is MLflow autologging; the framework
needs an in-process registry the hot paths can hit at nanosecond cost
and the cold paths (``/metrics`` scrapes, run archival) can render from.
Design constraints:

- **Thread-safe increments**: decode workers, HPO trial threads, and
  HTTP handler threads all write concurrently; every child value guards
  its state with a lock (uncontended CPython lock ops are ~100 ns, well
  inside the <50 µs/step instrumentation budget).
- **Fixed log-scale histogram buckets** (:func:`log_buckets`): latency
  spans 6+ decades between a registry op and a checkpoint write; linear
  buckets would waste resolution at one end. Fixed (not adaptive)
  buckets keep snapshots mergeable across processes.
- **Two renderers**: Prometheus text exposition
  (:meth:`MetricsRegistry.render_prometheus` — what ``GET /metrics``
  serves) and a flat JSON snapshot (:meth:`MetricsRegistry.snapshot` —
  what :meth:`RunStore.log_telemetry` archives).

Families are get-or-create by name so call sites never coordinate:
``registry.counter("x")`` anywhere returns the same family, and a kind
or label-schema mismatch raises instead of silently forking series.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Mapping, Sequence

from . import windows as _windows


def log_buckets(
    lo: float = 1e-6, hi: float = 100.0, per_decade: int = 3
) -> tuple[float, ...]:
    """Log-spaced histogram edges from ``lo`` to ``hi`` inclusive.

    The default (1 µs → 100 s, 3 edges per decade) covers everything
    from a registry op to a full checkpoint write in 25 buckets.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    n = round(math.log10(hi / lo) * per_decade)
    edges = [float(f"{lo * 10 ** (i / per_decade):.6g}") for i in range(n + 1)]
    edges[-1] = float(f"{hi:.6g}")
    return tuple(edges)


DEFAULT_BUCKETS = log_buckets()


class _CounterValue:
    """One counter series (a concrete label set)."""

    __slots__ = ("_lock", "value")

    # Lock contract: hot-path writers
    # from every thread family hit these; mutation only under _lock.
    _guarded_by_lock = ("value",)

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self.value += n


    def _sample(self) -> dict:
        # lock-free approximate read: render paths tolerate a torn float; never written here
        return {"value": self.value}

    def _wire(self) -> dict:
        # lock-free approximate read, same contract as _sample
        v = self.value
        return {"v": _windows.WIRE_VERSION, "kind": "counter", "value": v}


class _GaugeValue:
    """One gauge series."""

    __slots__ = ("_lock", "value")

    _guarded_by_lock = ("value",)

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n



    def _sample(self) -> dict:
        # lock-free approximate read: render paths tolerate a torn float; never written here
        return {"value": self.value}

    def _wire(self) -> dict:
        # lock-free approximate read, same contract as _sample
        v = self.value
        return {"v": _windows.WIRE_VERSION, "kind": "gauge", "value": v}


class _HistogramValue:
    """One histogram series: per-bucket counts + sum + count."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    # buckets is immutable after construction and deliberately unlisted.
    _guarded_by_lock = ("counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1


    def _sample(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        cum = 0
        out = []
        for edge, c in zip(self.buckets, counts):
            cum += c
            out.append([_fmt(edge), cum])
        out.append(["+Inf", total])
        return {"count": total, "sum": s, "buckets": out}

    def _wire(self) -> dict:
        """RAW per-bucket counts (not the cumulative render): what a
        peer can add bucket-wise without reconstructing deltas."""
        with self._lock:
            return {"v": _windows.WIRE_VERSION, "kind": "histogram",
                    "buckets": list(self.buckets),
                    "counts": list(self.counts),
                    "sum": self.sum, "count": self.count}


class _WindowValue:
    """One windowed series: a sliding-window quantile sketch.

    The fourth registry kind (``window``): constant-memory live
    quantiles/rate/mean/max over the last ``window_s`` seconds
    (:class:`.windows.SlidingQuantile`).
    Renders as a Prometheus *summary* on ``/metrics`` — with the
    non-standard but documented semantics that the quantiles and
    ``_sum``/``_count`` cover only the window, not the process
    lifetime. The sketch carries its own lock; no state lives here.
    """

    __slots__ = ("_sketch", "_quantiles")

    def __init__(self, window_s: float, quantiles: Sequence[float]):
        self._sketch = _windows.SlidingQuantile(window_s=window_s)
        self._quantiles = tuple(quantiles)

    def observe(self, v: float, trace: str | None = None) -> None:
        self._sketch.observe(v, trace=trace)

    def quantile(self, q: float) -> float | None:
        return self._sketch.quantile(q)


    def _sample(self) -> dict:
        return self._sketch.snapshot(self._quantiles)

    def _wire(self) -> dict:
        # The sketch's own wire payload (kind "sliding_quantile") plus
        # the family's quantile list, so a federating receiver can
        # re-register the family with identical geometry.
        return {**self._sketch.to_wire(),
                "quantiles": list(self._quantiles)}


_CHILD_TYPES = {
    "counter": _CounterValue,
    "gauge": _GaugeValue,
    "histogram": _HistogramValue,
}


class MetricFamily:
    """A named metric plus its per-label-set children.

    An unlabeled family proxies value ops (``inc``/``set``/``observe``)
    straight to its single child; labeled families hand out children via
    :meth:`labels`. Call sites should hoist the child lookup out of hot
    loops (``h = fam.labels(path="/predict")`` once, ``h.observe(dt)``
    per event).
    """

    _guarded_by_lock = ("_children",)

    def __init__(self, kind: str, name: str, help: str = "",
                 label_names: Sequence[str] = (), buckets=None,
                 window_s: float | None = None, quantiles=None):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        # Resolve default buckets at registration so a later explicit
        # request can be compared against what this family actually uses.
        if buckets is not None:
            self._buckets = tuple(buckets)
        elif kind == "histogram":
            self._buckets = DEFAULT_BUCKETS
        else:
            self._buckets = None
        # Window geometry, resolved at registration for the same reason.
        if kind == "window":
            self._window_s = float(
                window_s if window_s is not None
                else _windows.DEFAULT_WINDOW_S
            )
            self._quantiles = tuple(
                quantiles if quantiles is not None
                else _windows.DEFAULT_QUANTILES
            )
        else:
            self._window_s = None
            self._quantiles = None
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.label_names:
            solo = self._new_child()
            self._children[()] = solo
            # Bind the child's mutators directly: the unlabeled hot path
            # pays zero indirection.
            for m in ("inc", "set", "observe", "quantile"):
                if hasattr(solo, m):
                    setattr(self, m, getattr(solo, m))

    def _new_child(self):
        if self.kind == "histogram":
            return _HistogramValue(self._buckets)
        if self.kind == "window":
            return _WindowValue(self._window_s, self._quantiles)
        return _CHILD_TYPES[self.kind]()

    def labels(self, **labels: str):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _require_unlabeled(self, op: str):
        raise TypeError(
            f"metric {self.name!r} is labeled {self.label_names}; call "
            f".labels(...).{op}(...)"
        )

    # Labeled families get these stubs; unlabeled families overwrote them
    # with the solo child's bound methods in __init__.
    def inc(self, n: float = 1.0) -> None:
        self._require_unlabeled("inc")

    def set(self, v: float) -> None:
        self._require_unlabeled("set")

    def observe(self, v: float) -> None:
        self._require_unlabeled("observe")


    def _series(self) -> list[tuple[dict, dict]]:
        """[(labels_dict, sample_dict), ...] sorted by label values."""
        with self._lock:
            items = sorted(self._children.items())
        return [
            (dict(zip(self.label_names, key)), child._sample())
            for key, child in items
        ]

    def _wire_series(self) -> list[tuple[dict, dict]]:
        """[(labels_dict, wire_dict), ...] — the mergeable sibling of
        :meth:`_series`, feeding :meth:`MetricsRegistry.wire_snapshot`."""
        with self._lock:
            items = sorted(self._children.items())
        return [
            (dict(zip(self.label_names, key)), child._wire())
            for key, child in items
        ]


class MetricsRegistry:
    """Get-or-create registry of metric families, one per process."""

    _guarded_by_lock = ("_families",)

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _get(self, kind: str, name: str, help: str, labels, buckets=None,
             window_s=None, quantiles=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = MetricFamily(
                    kind, name, help, labels, buckets,
                    window_s=window_s, quantiles=quantiles,
                )
                return fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {kind}"
            )
        if tuple(labels) != fam.label_names:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.label_names}, requested {tuple(labels)}"
            )
        if (
            kind == "histogram"
            and buckets is not None
            and tuple(buckets) != fam._buckets
        ):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{fam._buckets}, requested {tuple(buckets)}"
            )
        if kind == "window":
            if window_s is not None and float(window_s) != fam._window_s:
                raise ValueError(
                    f"window {name!r} already registered with "
                    f"window_s={fam._window_s}, requested {window_s}"
                )
            if quantiles is not None and tuple(quantiles) != fam._quantiles:
                raise ValueError(
                    f"window {name!r} already registered with quantiles "
                    f"{fam._quantiles}, requested {tuple(quantiles)}"
                )
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] | None = None) -> MetricFamily:
        return self._get("histogram", name, help, labels, buckets)

    def window(self, name: str, help: str = "",
               labels: Sequence[str] = (),
               window_s: float | None = None,
               quantiles: Sequence[float] | None = None) -> MetricFamily:
        """A sliding-window quantile series (live p50/p99/rate/max over
        the last ``window_s`` seconds) — the windowed sibling of
        :meth:`histogram`."""
        return self._get("window", name, help, labels,
                         window_s=window_s, quantiles=quantiles)

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]


    # -- federation wire form ---------------------------------------------

    def wire_snapshot(self) -> dict:
        """Mergeable snapshot of every series — what ``GET /telemetry``
        serves. Unlike :meth:`snapshot` (render-oriented: cumulative
        histogram pairs, resolved quantiles) this carries the RAW
        internals (per-bucket counts, window digest counts) so a peer
        registry can fold them in (the merge waits for the port's
        federation slice).
        """
        metrics = []
        for fam in self.families():
            for labels, wire in fam._wire_series():
                metrics.append({
                    "name": fam.name,
                    "type": fam.kind,
                    "help": fam.help,
                    "labels": labels,
                    "wire": wire,
                })
        return {
            "version": _windows.WIRE_VERSION,
            "ts": time.time(),
            "metrics": metrics,
        }

    # -- renderers --------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat JSON-serializable snapshot of every series."""
        metrics = []
        for fam in self.families():
            for labels, sample in fam._series():
                metrics.append({
                    "name": fam.name,
                    "type": fam.kind,
                    "labels": labels,
                    **sample,
                })
        return {"ts": time.time(), "metrics": metrics}


    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: list[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            # The window kind renders as a Prometheus summary whose
            # quantiles/_sum/_count cover only the sliding window.
            kind_txt = "summary" if fam.kind == "window" else fam.kind
            lines.append(f"# TYPE {fam.name} {kind_txt}")
            for labels, sample in fam._series():
                if fam.kind == "window":
                    for q, v in sample["quantiles"].items():
                        lines.append(
                            f"{fam.name}"
                            f"{_labels_text({**labels, 'quantile': q})} "
                            f"{_fmt(v if v is not None else math.nan)}"
                        )
                    lines.append(
                        f"{fam.name}_sum{_labels_text(labels)} "
                        f"{_fmt(sample['sum'])}"
                    )
                    lines.append(
                        f"{fam.name}_count{_labels_text(labels)} "
                        f"{sample['count']}"
                    )
                elif fam.kind == "histogram":
                    # _sample() pairs are already cumulative (le semantics).
                    for le, c in sample["buckets"]:
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_labels_text({**labels, 'le': le})} {c}"
                        )
                    lines.append(
                        f"{fam.name}_sum{_labels_text(labels)} "
                        f"{_fmt(sample['sum'])}"
                    )
                    lines.append(
                        f"{fam.name}_count{_labels_text(labels)} "
                        f"{sample['count']}"
                    )
                else:
                    lines.append(
                        f"{fam.name}{_labels_text(labels)} "
                        f"{_fmt(sample['value'])}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    """Float formatting shared by the text renderer and bucket keys."""
    if v != v:
        return "NaN"  # Prometheus spelling for an empty-window quantile
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.9g}"


def _escape_label(v: str) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(h: str) -> str:
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _labels_text(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"
