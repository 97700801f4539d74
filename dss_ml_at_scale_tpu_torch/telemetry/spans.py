"""Host-side span log.

Port copy of ``dss_ml_at_scale_tpu/telemetry/spans.py``, cut to what the LM
serving path uses: :meth:`SpanLog.span` records wall time on a bounded
in-memory ring and labels the region in any active ``torch.profiler``
trace (``record_function``, where the JAX package used a
``jax.profiler.TraceAnnotation``). The JSONL tee, the Perfetto export and
the flight-recorder feed are not ported yet.

Events are plain dicts::

    {"name", "ts", "dur", "pid", "tid", "thread", "args",
     "trace", "span", "parent", "kind"}   # ts/dur in seconds

The last four fields appear only under an active
:mod:`.tracecontext` trace and are the causal identity: every span of one
request shares ``trace``, and ``parent`` points at the enclosing span.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Iterator

from torch.profiler import record_function

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
    """Bounded in-memory span recorder (oldest events evicted)."""

    _guarded_by_lock = ("_events",)

    def __init__(self, capacity: int = 100_000):
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def _event(self, name: str, ts: float, dur: float, trace, args: dict,
               span_id: str | None = None) -> dict:
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

    def record(self, name: str, ts: float, dur: float, *,
               trace: "tracecontext.TraceContext | None" = None, **args) -> dict:
        """Record one complete span (``ts`` epoch seconds, ``dur``
        seconds) whose timing the caller measured. ``trace`` stamps it
        with an explicit trace context (a worker recording for a request
        it holds the handoff of); by default the calling thread's."""
        event = self._event(name, ts, dur, trace, args)
        with self._lock:
            self._events.append(event)
        return event

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        """``with log.span("lm.step"): ...`` — records wall time here AND
        labels the region in any active ``torch.profiler`` trace. Under an
        active trace the span becomes the context for its body."""
        parent = tracecontext.current()
        span_id = tracecontext.new_span_id()
        token = None
        if parent is not None:
            token = tracecontext._ctx.set(parent.child(span_id))
        t0 = time.time()
        p0 = time.perf_counter()
        _spans_total().inc()
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
            with self._lock:
                self._events.append(event)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e) + "\n" for e in self.events())
