"""Serving lifecycle: readiness state machine and the server handle.

Port copy of ``dss_ml_at_scale_tpu/serving/lifecycle.py``.

Splits the two questions load balancers ask into two answers:

- **liveness** (``GET /healthz``): is the process up? — 200 from start
  to final close, *including* while draining (a draining server is
  healthy; restarting it would kill the very work the drain protects).
- **readiness** (``GET /readyz``): should new traffic come here? — 200
  only in the READY state; 503 while STARTING (scorer still warming),
  DRAINING, or STOPPED, so an orchestrator pulls the instance from
  rotation *before* requests start bouncing off admission.

:class:`ServerHandle` is the embedding/ops face of graceful shutdown:
``close()`` walks READY → DRAINING (stop admitting, readiness flips)
→ finish queued work (bounded by the drain timeout) → stop the HTTP
loop → close the socket. In-flight responses finish writing — the
server never kills a request mid-body.
"""

from __future__ import annotations

import threading

from .. import telemetry

STARTING = "starting"
READY = "ready"
DRAINING = "draining"
STOPPED = "stopped"


class Lifecycle:
    """Thread-safe STARTING → READY → DRAINING → STOPPED progression."""

    # Lock contract: state transitions race between the serve thread,
    # handler threads, and the SIGTERM/drain path — _state only under
    # _lock.
    _guarded_by_lock = ("_state",)

    def __init__(self):
        self._lock = threading.Lock()
        self._state = STARTING
        # 1 exactly when /readyz answers 200 — scrapeable readiness, so
        # dashboards see the drain the instant it starts.
        self._ready_gauge = telemetry.gauge(
            "serving_ready", "1 when accepting requests (the /readyz state)"
        )
        self._ready_gauge.set(0)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def accepting(self) -> bool:
        return self.state == READY

    def mark_ready(self) -> None:
        with self._lock:
            if self._state != STARTING:
                return  # never un-drain: READY is reachable only once
            self._state = READY
        self._ready_gauge.set(1)

    def start_drain(self) -> None:
        with self._lock:
            if self._state in (DRAINING, STOPPED):
                return
            self._state = DRAINING
        self._ready_gauge.set(0)

    def mark_stopped(self) -> None:
        with self._lock:
            self._state = STOPPED
        self._ready_gauge.set(0)


class ServerHandle:
    """Owns a running server's clean end-of-life.

    ``serve_in_thread`` returns one of these instead of a bare
    ``(server, thread)`` pair: the old shape leaked the server socket
    and killed in-flight requests mid-write, because nothing tied
    "stop the accept loop" to "finish the queued work first".
    ``close()`` is idempotent and safe from any thread.
    """

    # Lock contract: close() races between the serve
    # thread, Ctrl-C handlers, and embedding teardown — the
    # exactly-once latch only under _lock.
    _guarded_by_lock = ("_closed",)

    def __init__(self, server, thread, *, drain_timeout_s: float | None = None):
        self.server = server
        self.thread = thread
        self._drain_timeout_s = drain_timeout_s
        self._lock = threading.Lock()
        self._closed = False

    @property
    def scheduler(self):
        return self.server.scheduler

    @property
    def lifecycle(self) -> Lifecycle:
        return self.server.lifecycle

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    @property
    def address(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def close(self, drain_timeout_s: float | None = None) -> None:
        """Graceful: drain admitted work, then stop accepting, then close.

        Order matters: admission closes first (new /predict → 503, so
        the drain converges), queued work finishes (bounded by the
        drain timeout; leftovers are failed, not abandoned), and only
        then does the accept loop stop and the socket close. Every
        admitted request has settled by the time the loop stops, so
        handler threads are just flushing already-computed responses.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if drain_timeout_s is None:
            drain_timeout_s = self._drain_timeout_s
        self.lifecycle.start_drain()
        self.scheduler.drain(drain_timeout_s)
        self.server.shutdown()
        self.thread.join(timeout=5.0)
        self.server.server_close()

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
