"""Host-side span/event log with Chrome/Perfetto ``trace_event`` export.

Port copy of ``dss_ml_at_scale_tpu/telemetry/spans.py``, whole, with one
change of idiom: :meth:`SpanLog.span` labels the region in any active
``torch.profiler`` trace (``record_function``) where the JAX package used a
``jax.profiler.TraceAnnotation``, while the host-side record always lands
here.

Events are plain dicts (JSONL on disk)::

    {"name", "ts", "dur", "pid", "tid", "thread", "args",
     "trace", "span", "parent", "kind"}   # ts/dur in seconds

``thread`` is the emitting thread's name (what Perfetto lanes are labeled
with); the last four fields appear only under an active
:mod:`.tracecontext` trace and are the causal identity: every span of one
request or step shares ``trace``, and ``parent`` points at the enclosing
span.

:func:`to_perfetto` converts a list of them to Chrome trace_event JSON
(``ph: "X"`` complete events, microsecond timestamps) that loads in
``ui.perfetto.dev`` or ``chrome://tracing``, with ``ph: "M"``
process/thread-name metadata so lanes read "feeder-train" instead of raw
tids, and ``ph: "s"/"f"`` flow arrows stitching each trace id across its
thread hops.

Every span open also feeds the flight recorder (:mod:`.flightrec`) with a
*begin* event, so in-flight spans survive a SIGKILL even though this log
records only at close.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterable, Iterator, Mapping, Sequence

from torch.profiler import record_function

from ..utils.jsonl import JsonlWriter
from . import tracecontext

_spans_total_handle = None


def _spans_total():
    global _spans_total_handle
    if _spans_total_handle is None:
        # Local import: this module is imported by telemetry/__init__.
        from . import counter

        _spans_total_handle = counter(
            "trace_spans_total", "spans opened on the process span log"
        )
    return _spans_total_handle


class SpanLog:
    """Bounded in-memory span recorder with optional JSONL tee.

    ``capacity`` bounds memory (oldest events evicted); pass ``path`` to
    also append every event to a JSONL file as it is recorded (the
    crash-safe export — the in-memory ring is for snapshots).

    Locking: the event ring lives under ``_lock`` (every thread family
    records); the tee file is a :class:`~...utils.jsonl.JsonlWriter`
    with its own lock, so disk latency never blocks ring readers, and
    its handle is closed idempotently — at :meth:`close`, via the
    context manager, or by the writer's own ``atexit`` hook.
    """

    # Lock contract: the ring under
    # _lock; the tee file's state lives inside JsonlWriter (its own
    # lock — file I/O off the hot lock).
    _guarded_by_lock = ("_events",)

    def __init__(self, capacity: int = 100_000,
                 path: str | os.PathLike | None = None):
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tee = JsonlWriter(path) if path is not None else None

    def record(self, name: str, ts: float, dur: float, *,
               trace: "tracecontext.TraceContext | None" = None,
               **args) -> dict:
        """Record one complete span (``ts`` epoch seconds, ``dur``
        seconds).

        ``trace`` stamps the event with an explicit trace context (a
        worker recording on behalf of a request it holds a
        :class:`~dss_ml_at_scale_tpu_torch.telemetry.tracecontext.Handoff`
        for); default is the calling thread's active context.
        """
        event = self._event(name, ts, dur, trace, args)
        self._append(event)
        from . import flightrec

        flightrec.emit({**event, "ph": "X"})
        return event

    def _event(self, name: str, ts: float, dur: float,
               trace, args: dict, span_id: str | None = None) -> dict:
        event = {
            "name": name,
            "ts": ts,
            "dur": dur,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
        }
        ctx = trace if trace is not None else tracecontext.current()
        if ctx is not None:
            event["trace"] = ctx.trace_id
            event["span"] = span_id or tracecontext.new_span_id()
            event["parent"] = ctx.span_id
            event["kind"] = ctx.kind
        elif span_id is not None:
            event["span"] = span_id
        if args:
            event["args"] = args
        return event

    def _append(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)
        if self._tee is not None:
            # The writer serializes outside its lock and only touches
            # the file under it — a slow disk must not stall snapshot
            # readers on _lock.
            self._tee.write(event)

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        """``with log.span("decode"): ...`` — records wall time here AND
        labels the region in any active ``torch.profiler`` trace.

        Under an active trace the span becomes the context for its
        body (children point at it), and a *begin* event goes to the
        flight recorder at open — so a span cut short by SIGKILL is
        still reconstructible from the recorder tail.
        """
        from . import flightrec

        parent = tracecontext.current()
        span_id = tracecontext.new_span_id()
        token = None
        if parent is not None:
            token = tracecontext._ctx.set(parent.child(span_id))
        t0 = time.time()
        p0 = time.perf_counter()
        _spans_total().inc()
        begin = self._event(name, t0, 0.0, parent, args, span_id=span_id)
        flightrec.emit({**begin, "ph": "B"})
        try:
            with record_function(name):
                yield
        finally:
            if token is not None:
                tracecontext._ctx.reset(token)
            event = self._event(
                name, t0, time.perf_counter() - p0, parent, args,
                span_id=span_id,
            )
            self._append(event)
            flightrec.emit({**event, "ph": "E"})

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump_jsonl(self, path: str | os.PathLike) -> int:
        """Write the in-memory events to a JSONL file; returns the count."""
        events = self.events()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e) + "\n" for e in self.events())

    def close(self) -> None:
        if self._tee is not None:
            self._tee.close()

    def __enter__(self) -> "SpanLog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _flow_events(spans: list[dict]) -> list[dict]:
    """``ph: "s"/"f"`` flow arrows stitching one trace id across threads.

    For each trace, consecutive (by start time) spans on *different*
    threads get one arrow: an ``s`` anchored inside the source span and
    an ``f`` (``bp: "e"`` — bind to enclosing slice) inside the target.
    Same-thread succession needs no arrow; nesting already shows it.
    Succession is judged on the ``(pid, tid)`` PAIR: in a merged
    multi-replica timeline two processes legitimately reuse the same
    tid integer, and comparing tids alone would silently drop exactly
    the cross-process arrows the merge exists to draw.
    """
    by_trace: dict[str, list[dict]] = {}
    for e in spans:
        if e.get("trace"):
            by_trace.setdefault(e["trace"], []).append(e)
    flows: list[dict] = []
    for trace_id, group in by_trace.items():
        group.sort(key=lambda e: float(e.get("ts", 0.0)))
        hop = 0
        for a, b in zip(group, group[1:]):
            if (a.get("pid"), a.get("tid")) == (b.get("pid"), b.get("tid")):
                continue
            flow_id = int(trace_id[:8], 16) * 64 + (hop % 64)
            hop += 1
            common = {"cat": "dsst", "name": f"trace:{trace_id}",
                      "id": flow_id}
            # Anchor the arrow just inside each slice so Perfetto binds
            # it to the right span.
            a_ts = float(a.get("ts", 0.0)) + min(
                float(a.get("dur", 0.0)), 1e-6
            )
            flows.append({**common, "ph": "s",
                          "ts": round(a_ts * 1e6, 3),
                          "pid": int(a.get("pid", 0)),
                          "tid": int(a.get("tid", 0))})
            flows.append({**common, "ph": "f", "bp": "e",
                          "ts": round((float(b.get("ts", 0.0)) + 1e-6) * 1e6, 3),
                          "pid": int(b.get("pid", 0)),
                          "tid": int(b.get("tid", 0))})
    return flows


def to_perfetto(events: Iterable[dict],
                process_names: Mapping[int, str] | None = None) -> dict:
    """Span dicts → Chrome ``trace_event`` JSON object.

    Emits ``ph: "M"`` process/thread-name metadata (lanes labeled with
    the recorded thread names — feeder, batcher, decode-N — instead of
    raw tid integers), ``ph: "X"`` complete events with microsecond
    ``ts``/``dur`` sorted by ``ts``, and ``ph: "s"/"f"`` flow arrows
    connecting spans that share a trace id across threads. The result is
    ``json.dump``-able as-is.

    ``process_names`` maps pid → display name for multi-process
    timelines (:func:`merge_replica_spans` labels each replica's lane);
    unmapped pids keep the default ``"dsst"``.
    """
    spans = sorted(events, key=lambda e: float(e.get("ts", 0.0)))
    trace_events: list[dict] = []
    # Metadata first: one process_name, one thread_name per tid seen
    # (last name wins — threads are named at creation and keep them).
    thread_names: dict[tuple[int, int], str] = {}
    pids = set()
    for e in spans:
        pid, tid = int(e.get("pid", 0)), int(e.get("tid", 0))
        pids.add(pid)
        name = e.get("thread")
        if name:
            thread_names[(pid, tid)] = str(name)
    for pid in sorted(pids):
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "ts": 0,
            "args": {"name": (process_names or {}).get(pid, "dsst")},
        })
    for (pid, tid), name in sorted(thread_names.items()):
        trace_events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "ts": 0, "args": {"name": name},
        })
    body: list[dict] = []
    for e in spans:
        args = dict(e.get("args", {}))
        for key in ("trace", "span", "parent", "kind"):
            if e.get(key):
                args[key] = e[key]
        body.append({
            "name": str(e.get("name", "?")),
            "cat": "dsst",
            "ph": "X",
            "ts": round(float(e.get("ts", 0.0)) * 1e6, 3),
            "dur": round(max(float(e.get("dur", 0.0)), 0.0) * 1e6, 3),
            "pid": int(e.get("pid", 0)),
            "tid": int(e.get("tid", 0)),
            "args": args,
        })
    body.extend(_flow_events(spans))
    body.sort(key=lambda e: e["ts"])
    trace_events.extend(body)
    return {"displayTimeUnit": "ms", "traceEvents": trace_events}


def load_span_jsonl(path: str | os.PathLike) -> list[dict]:
    """Span-log JSONL (or a flight-recorder tail) → complete span dicts.

    Flight-recorder files carry ``ph`` B/E/X events: B/E pairs are
    folded into complete spans and begin-only spans (open at the kill)
    are included with ``open: true`` and zero duration — visible in the
    export rather than silently dropped. Reading goes through
    ``flightrec.read_raw`` so the rotation chain (``<path>.1``) and
    torn-line tolerance match what ``trace tail`` sees.
    """
    from . import flightrec

    events = flightrec.read_raw(path)
    if any("ph" in e for e in events):
        complete, opens = flightrec.reconstruct(
            [e for e in events if e.get("ph") in ("B", "E", "X")]
        )
        return complete + [
            {**{k: v for k, v in o.items() if k != "ph"},
             "dur": 0.0,
             "args": {**o.get("args", {}), "open": True}}
            for o in opens
        ]
    return events


# Pid stride between merged replicas: far above any real OS pid, so a
# remapped lane can never collide with another replica's.
REPLICA_PID_STRIDE = 1 << 20


def merge_replica_spans(
    paths: Sequence[str | os.PathLike],
) -> tuple[list[dict], dict[int, str]]:
    """Merge N replicas' span/flight-recorder files into ONE timeline.

    Each file's pids are densely remapped into a per-replica band
    (``i * REPLICA_PID_STRIDE + j``), so two replicas that ran as the
    same OS pid (containers, or plain restarts) land in distinct
    Perfetto process lanes. Returns ``(events, process_names)`` ready
    for :func:`to_perfetto` — which draws flow arrows *across files*
    for propagated trace ids, because ``_flow_events`` keys on the
    trace id and judges hops on the (pid, tid) pair.
    """
    merged: list[dict] = []
    process_names: dict[int, str] = {}
    for i, path in enumerate(paths):
        events = load_span_jsonl(path)
        remap: dict[int, int] = {}
        for e in events:
            orig = int(e.get("pid", 0))
            pid = remap.get(orig)
            if pid is None:
                pid = i * REPLICA_PID_STRIDE + len(remap)
                remap[orig] = pid
                process_names[pid] = (
                    f"replica {i}: {Path(path).name} (pid {orig})"
                )
            merged.append({**e, "pid": pid})
    return merged, process_names


def export_perfetto(jsonl_path: str | os.PathLike,
                    out_path: str | os.PathLike) -> int:
    """Convert a span JSONL (or flight-recorder tail) to a Chrome trace.

    Returns the number of events converted. The output loads in
    ``ui.perfetto.dev`` ("Open trace file") or ``chrome://tracing``.
    """
    events = load_span_jsonl(jsonl_path)
    trace = to_perfetto(events)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(trace))
    return len(events)
