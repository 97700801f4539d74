"""The traced slices: a few steady steps under ``torch.profiler``, and the
reading of their traces.

Two slices follow each other. The first records the device alone (CUDA
activity: kernels, copies and the runtime calls that launch them), which
costs the host little, so its timeline is the device's as the window ran
it: the busy and idle time come from it. The second adds the host's
operators, which slows the host's dispatch, and serves to attribute each
kernel to the operators it was launched under. Each slice ends with a
``synchronize``; its window runs from its first host event to its last
(the ``record_function`` annotation :data:`SLICE` where the host's
operators are recorded). From the Chrome trace the profiler exports
(written to the run's temporary directory and deleted once read):

- device operations (kernels, copies, sets) with their intervals;
- each launch's host thread and time, by the correlation id that ties it
  to its kernel (the way ``scripts/profile_torch_train.py`` reads it);
- every runtime and driver call with its interval, so the time the host
  spent waiting in them on the device can be told from its own work;
- the host's operators (``cpu_op``) with their threads and intervals, so a
  kernel can be attributed to the operators its launch falls under.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import statistics
import tempfile

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Operations waiting on the device below which a launch cannot have waited
# for room in the launch queue (which holds about a thousand).
QUEUE_FREE = 64

# scripts/profile_torch_train.py::kind, the classes of device operations.
_FUSED = ("::fwd_kernel", "::bwd_da_kernel", "::bwd_dw_kernel", "::sum_rows_kernel")
_LIBRARY = ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "sm90", "cutlass", "gemm",
            "nvjet")


def kind(name: str) -> str:
    """The kind of a device operation, by its name."""
    if any(k in name for k in _FUSED):
        return "K1-K3"
    if "elementwise" not in name and any(k in name.lower() for k in _LIBRARY):
        return "convolutions and products (cuDNN, cuBLAS)"
    if "reduce_kernel" in name:
        return "reductions"
    if "copy" in name.lower() or "memcpy" in name.lower():
        return "copies and casts"
    if "elementwise" in name:
        return "other elementwise"
    return "other"


def _union(spans) -> list[tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Trace:
    steps: int
    window: tuple[float, float]  # microseconds
    host_tid: object
    device_ops: list[tuple[str, float, float, object]]  # name, start, end, correlation
    launches: dict  # correlation -> (tid, ts)
    ops: dict  # tid -> sorted list of (ts, end, name)
    calls: list  # (name, start, end) of each runtime and driver call, by start

    @classmethod
    def from_events(cls, events: list[dict], steps: int) -> "Trace":
        window = host_tid = None
        device_ops, launches, ops, host = [], {}, {}, []
        for e in events:
            cat, args = e.get("cat"), e.get("args") or {}
            if e.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                device_ops.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                   args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                host.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
                if "correlation" in args:
                    launches[args["correlation"]] = (e.get("tid"), float(e["ts"]))
            elif cat in ("cpu_op", "user_annotation"):
                if e.get("name") == SLICE:
                    window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    host_tid = e.get("tid")
                ops.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        if window is None and host:
            window = (min(a for _, a, _ in host), max(b for _, _, b in host))
        if window is None:
            raise ValueError(f"the trace has neither a {SLICE!r} annotation nor a runtime call")
        for lst in ops.values():
            lst.sort()
        return cls(steps, window, host_tid, device_ops, launches, ops,
                   sorted(host, key=lambda c: c[1]))

    # -- the device timeline ------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.window
        return _union((max(a, lo), min(b, hi)) for _, a, b, _ in self.device_ops
                      if b > lo and a < hi)

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(b - a for a, b in self._busy_intervals()) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The window's idle intervals on the device, microseconds."""
        out, at = [], self.window[0]
        for a, b in self._busy_intervals():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    # -- the host's waits -----------------------------------------------------
    def host_waits_s(self) -> float | None:
        """Seconds of the window the host spent in runtime calls waiting on
        the device, None where the trace holds no launch of a device
        operation. A call to a ``*Synchronize`` function waits for all of
        its length. Any other call waits for the end of its length beyond
        the same call's usual cost, where at its start ``QUEUE_FREE`` or
        more operations were launched and not yet finished on the device (a
        launch into a full queue waits for room); the usual cost is the
        median length of that call made with fewer waiting, or its shortest
        where it never was. The waits are counted as the union of their
        intervals, so a runtime call and the driver call inside it count
        once."""
        lo, hi = self.window
        ends = {corr: b for _, _, b, corr in self.device_ops if corr is not None}
        known = [c for c in self.launches if c in ends]
        if not known:
            return None
        launched = sorted(self.launches[c][1] for c in known)
        finished = sorted(ends[c] for c in known)
        calls = [(name, a, b, bisect.bisect_left(launched, a) - bisect.bisect_left(finished, a))
                 for name, a, b in self.calls if lo <= a and b <= hi]
        free: dict[str, list[float]] = {}
        for name, a, b, waiting in calls:
            if waiting < QUEUE_FREE:
                free.setdefault(name, []).append(b - a)
        usual = {name: statistics.median(v) for name, v in free.items()}
        waits = []
        for name, a, b, waiting in calls:
            if "Synchronize" in name:
                waits.append((a, b))
            elif waiting >= QUEUE_FREE:
                cost = usual.get(name)
                if cost is None:
                    cost = min(d - c for n, c, d, _ in calls if n == name)
                if b - a > cost:
                    waits.append((a + cost, b))
        return sum(b - a for a, b in _union(waits)) / 1e6

    # -- attribution to the host's operators ---------------------------------
    def _innermost(self, tid, ts: float) -> str | None:
        """The innermost operator (the slice's annotation aside) on ``tid``
        open at ``ts``."""
        lst = self.ops.get(tid, [])
        i = bisect.bisect_right(lst, (ts, float("inf"), ""))
        best = None
        for a, b, name in reversed(lst[:i]):
            if a <= ts <= b and name != SLICE and (best is None or b - a < best[0]):
                best = (b - a, name)
        return None if best is None else best[1]

    def device_seconds_under(self, names) -> tuple[float, int]:
        """``(seconds, operations)`` of the device operations whose launch
        falls inside a host operator named in ``names``."""
        names, total, count = set(names), 0.0, 0
        spans = {}  # tid -> the union of the named operators' intervals
        for tid, lst in self.ops.items():
            merged: list[list[float]] = []
            for a, b, name in lst:
                if name not in names:
                    continue
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            spans[tid] = ([m[0] for m in merged], [m[1] for m in merged])
        for _, a, b, corr in self.device_ops:
            tid, ts = self.launches.get(corr, (None, None))
            starts, ends = spans.get(tid, ((), ()))
            i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
            if i >= 0 and ts <= ends[i]:
                total += b - a
                count += 1
        return total / 1e6, count

    def device_seconds_named(self, predicate) -> tuple[float, int]:
        """``(seconds, operations)`` of the device operations whose name
        satisfies ``predicate``."""
        hits = [(b - a) for name, a, b, _ in self.device_ops if predicate(name)]
        return sum(hits) / 1e6, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations by kind and the longest idle gaps, each
        gap named by the innermost host operator open on the stepping
        thread when it began (``python`` where none was), in seconds over
        the traced window."""
        kinds: dict[str, float] = {}
        for name, a, b, _ in self.device_ops:
            kinds[kind(name)] = kinds.get(kind(name), 0.0) + (b - a) / 1e6
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": sorted(([k, v] for k, v in kinds.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": [[self._innermost(self.host_tid, a) or "python", (b - a) / 1e6]
                          for a, b in gaps],
        }


def profile_slice(run_steps, steps: int, device, host_ops: bool = True) -> Trace:
    """Trace ``run_steps(steps)``, which dispatches that many steady steps,
    and read the trace: with the host's operators, or (``host_ops=False``,
    on a card) the device's activity alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else []
    if host_ops or not cuda:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            run_steps(steps)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace.from_events(events, steps)
