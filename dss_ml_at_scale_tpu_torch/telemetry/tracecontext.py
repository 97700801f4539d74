"""Causal trace identity: trace/span IDs with explicit thread handoffs.

Port copy of ``dss_ml_at_scale_tpu/telemetry/tracecontext.py`` (the JAX
package's module imports nothing of JAX, but the port keeps its own copy).

A serving request crosses four threads (HTTP handler → decode pool →
batcher → handler again); a training step crosses three (feeder thread
pulls the reader batch and places it on the mesh, the step loop runs the
step, a manifest finalizer commits the checkpoint). The span
log records what each thread did, but without a shared identity those
are four unlinked timelines — no query can answer "where did request X
spend its 40 ms" or "which step's batch was in flight at the crash".

This module is that identity layer:

- a :class:`TraceContext` is ``(trace_id, span_id, kind)`` — one
  ``trace_id`` per logical unit of work (an HTTP request, a training
  step, an HPO trial), ``span_id`` naming the *current* span so children
  can point at their parent, ``kind`` tagging the unit family
  (``request`` / ``step`` / ``trial`` / ``run``) for the attribution
  tooling;
- propagation is a ``contextvars.ContextVar``: within one thread every
  :meth:`SpanLog.span` under an active trace stamps the trace fields
  automatically, with zero API changes at instrumentation points;
- **threads do not inherit contextvars**, which is a feature: crossing a
  thread boundary requires an explicit :class:`Handoff`, captured where
  the work is enqueued and activated where it runs. The pipeline's four
  boundaries (feeder queue, serving decode/batch queues, HPO worker
  pool, checkpoint finalizer) each carry one, so a hop can never be
  *accidentally* attributed — it is either explicitly linked or
  visibly missing.

The IDs are the correlation keys everywhere else: the ``X-DSST-Trace``
response header and serving access log carry the request's trace id,
the flight recorder persists them per event, and the Perfetto exporter
stitches spans sharing a trace id across threads with flow events.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import re
from typing import Iterator

# The one propagation channel. Deliberately module-private: readers use
# current(), writers use trace()/Handoff.activate(), so every set has a
# matching reset and a leaked context cannot outlive its scope.
_ctx: contextvars.ContextVar["TraceContext | None"] = contextvars.ContextVar(
    "dsst_trace_ctx", default=None
)


# Wire form of a Handoff (W3C-traceparent-shaped, dsst field widths):
#   dsst1-<trace_id:16 hex>-<span_id:8 hex>-<kind>
# The version prefix is bumped if the field layout ever changes, so a
# mixed-version fleet degrades to minting (from_header -> None) instead
# of misparsing. Parsing is deliberately paranoid: the header arrives
# from the network, so anything but an exact match mints a fresh trace.
TRACE_HEADER_PREFIX = "dsst1"
# Hard cap well above the ~48 chars a valid header needs: an oversized
# value is rejected before the regex ever runs.
_HEADER_MAX_LEN = 64
_HEADER_RE = re.compile(
    r"\Adsst1-([0-9a-f]{16})-([0-9a-f]{8})-([a-z][a-z0-9_]{0,15})\Z"
)


def new_trace_id() -> str:
    """16-hex-char trace id (64 random bits: collision-safe at any
    plausible request rate, short enough to read in a log line)."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """8-hex-char span id, unique within its trace."""
    return os.urandom(4).hex()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One unit of work's identity at a point in its span tree."""

    trace_id: str
    span_id: str
    kind: str = "request"

    def child(self, span_id: str | None = None) -> "TraceContext":
        """The context a child span runs under (same trace, new span)."""
        return TraceContext(
            self.trace_id, span_id or new_span_id(), self.kind
        )


def current() -> TraceContext | None:
    """The calling thread's active trace context, or None."""
    return _ctx.get()


@contextlib.contextmanager
def trace(kind: str = "request",
          trace_id: str | None = None) -> Iterator[TraceContext]:
    """Open a new trace on the calling thread::

        with tracecontext.trace(kind="request") as ctx:
            ...  # every span here carries ctx.trace_id

    Nesting replaces the active context for the inner scope (a step
    trace activated inside a run trace attributes to the step) and
    restores the outer one on exit.
    """
    ctx = TraceContext(trace_id or new_trace_id(), new_span_id(), kind)
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


class Handoff:
    """Explicit carrier of a trace context across a boundary.

    Built from an inbound ``X-DSST-Trace`` header (:meth:`from_header`) or
    around a context directly, and activated where the work runs::

        with Handoff(ctx).activate():
            with telemetry.span("stage"):
                ...

    A Handoff around ``None`` activates as a no-op, so instrumented
    boundaries stay correct for untraced callers.
    """

    __slots__ = ("ctx",)

    def __init__(self, ctx: TraceContext | None = None):
        self.ctx = ctx

    @classmethod
    def capture(cls) -> "Handoff":
        """Snapshot the calling thread's current context (the image
        scheduler carries a request's trace to its worker threads)."""
        return cls(current())

    @contextlib.contextmanager
    def activate(self) -> Iterator[TraceContext | None]:
        if self.ctx is None:
            yield None
            return
        token = _ctx.set(self.ctx)
        try:
            yield self.ctx
        finally:
            _ctx.reset(token)

    # -- wire codec (cross-PROCESS handoff) -------------------------------

    @classmethod
    def from_header(cls, value) -> "Handoff":
        """Parse a wire header back into a Handoff. NEVER raises: the
        value arrives from the network, so anything malformed (wrong
        type, oversized, bad hex, wrong field count, unknown version)
        yields ``Handoff(None)`` — the caller mints, exactly as for an
        absent header."""
        if not isinstance(value, str) or len(value) > _HEADER_MAX_LEN:
            return cls(None)
        m = _HEADER_RE.match(value)
        if m is None:
            return cls(None)
        trace_id, span_id, kind = m.groups()
        return cls(TraceContext(trace_id, span_id, kind))
