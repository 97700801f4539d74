"""HTTP token serving for the port (`serve-lm`).

Port of the LM half of ``dss_ml_at_scale_tpu/workloads/serving.py``:
:func:`make_lm_server`, :func:`serve_lm_in_thread` and the server class
under them, with the same routes, status codes, chunked NDJSON stream and
``X-DSST-Trace`` contract. A stdlib ``ThreadingHTTPServer`` in front of an
:class:`~..serving.lm.LMEngine`; HTTP/1.1 keep-alive with exact
``Content-Length`` on every non-streamed response. The image tier
(``dsst serve``'s ``Predictor``) comes with the image-serving slice.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import telemetry
from ..serving import (
    DeadlineExceeded,
    Lifecycle,
    NotAccepting,
    QueueFull,
    ServerHandle,
)
from ..telemetry import tracecontext
from ..utils.jsonl import JsonlWriter


class _ServingHTTPServer(ThreadingHTTPServer):
    # Keep-alive holds one handler thread per open client connection;
    # joining them on server_close (the ThreadingMixIn default) would
    # block shutdown on whichever client forgot to hang up. Daemon
    # threads: close() returns once the drain settled the WORK — the
    # response bytes flush from threads that die with the process.
    daemon_threads = True
    # Backpressure belongs to the admission controller (measured 429 +
    # Retry-After), not the kernel: the stdlib default TCP backlog of 5
    # reset concurrent connects the scheduler's queue_depth would have
    # admitted or politely rejected. The accept queue is sized with the
    # CONFIGURED admission queue (not a constant that a larger
    # queue_depth could outgrow) so every client gets an HTTP answer.
    request_queue_size = 128

    def __init__(self, addr, handler, queue_depth: int = 0):
        # server_bind reads request_queue_size at listen() time; the
        # instance attribute must exist before super().__init__ binds.
        self.request_queue_size = max(
            type(self).request_queue_size, 2 * queue_depth
        )
        super().__init__(addr, handler)



def make_lm_server(engine, host: str = "127.0.0.1", port: int = 8008, *,
                   max_body_bytes: int = 1024 * 1024,
                   access_log: str | os.PathLike | None = None,
                   ) -> ThreadingHTTPServer:
    """Token-streaming HTTP front end for an :class:`~..serving.lm.LMEngine`.

    The JAX package's control plane (``/healthz`` ``/readyz``
    ``/metrics`` ``/slo`` ``/telemetry``, HTTP/1.1 keep-alive, trace
    adoption/echo via ``X-DSST-Trace``), plus ``POST /generate``::

        {"tokens": [1, 2, 3], "max_new_tokens": 16,
         "temperature": 0.0, "top_k": null, "eos_id": null, "seed": 0}

    The response streams as chunked ``application/x-ndjson`` — ONE
    chunk per token (``{"token": t, "index": i}``) and a terminal
    ``{"done": reason, "tokens": n, "trace": id}`` line, so a client
    reads tokens as they decode instead of waiting for the whole
    completion; reasons are ``eos`` / ``max_tokens`` / ``deadline`` /
    ``drain``. Refusals keep the image tier's status contract:
    over-capacity requests 400 (:class:`~..serving.lm.PromptTooLong` —
    never a scatter past the arena), a full admission queue 429 +
    ``Retry-After``, draining 503. The ``engine`` must already be
    ``start()``-ed; the returned server owns it as ``server.scheduler``
    so :class:`ServerHandle` drains it exactly like the image tier
    (stop admitting, finish every in-flight slot).
    """
    from ..serving.lm import PromptTooLong

    request_hist = telemetry.histogram(
        "serving_request_seconds", "HTTP request latency", labels=("path",)
    )
    error_counter = telemetry.counter(
        "serving_errors_total", "HTTP 4xx/5xx responses", labels=("code",)
    )
    slo_engine = telemetry.slo.get_engine()
    lifecycle = Lifecycle()
    access = JsonlWriter(access_log) if access_log else None
    cfg = engine.cfg
    # How long one blocking event-queue read may take before the stream
    # is declared wedged: the engine settles every generation by itself
    # (deadline/drain events), so this only fires if the engine thread
    # died — generous, never load-bearing.
    _event_timeout = (
        cfg.deadline_ms / 1000.0 + 30.0 if cfg.deadline_ms > 0 else 120.0
    )

    _known_paths = frozenset(
        ("/healthz", "/readyz", "/metrics", "/slo", "/telemetry",
         "/generate")
    )

    class LMHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 60

        _trace_id = None
        _trace_inherited = False
        _last_code = None
        _gen_row = None

        def log_message(self, *a):
            pass

        def _observe(self, t0: float) -> None:
            path = self.path if self.path in _known_paths else "other"
            request_hist.labels(path=path).observe(time.perf_counter() - t0)

        def _json(self, code: int, payload: dict, headers=None) -> None:
            if code >= 400:
                error_counter.labels(code=str(code)).inc()
            self._last_code = code
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._trace_id is not None:
                self.send_header("X-DSST-Trace", self._trace_id)
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _metrics(self) -> None:
            body = telemetry.render_prometheus().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            t0 = time.perf_counter()
            self._trace_id = None
            try:
                if self.path == "/healthz":
                    self._json(200, {
                        "status": "ok",
                        "state": lifecycle.state,
                        "workload": "lm",
                        "decoder": type(engine.decoder).__name__,
                        "slots": cfg.slots,
                        "max_len": cfg.max_len,
                        "prefill_buckets": list(cfg.prefill_buckets),
                    })
                elif self.path == "/readyz":
                    if lifecycle.accepting:
                        self._json(200, {"ready": True,
                                         "state": lifecycle.state})
                    else:
                        self._json(503, {"ready": False,
                                         "state": lifecycle.state})
                elif self.path == "/metrics":
                    self._metrics()
                elif self.path == "/slo":
                    self._json(200, slo_engine.render_status())
                elif self.path == "/telemetry":
                    doc = telemetry.get_registry().wire_snapshot()
                    doc["slo_sources"] = slo_engine.wire_sources()
                    self._json(200, doc)
                else:
                    self._json(404, {"error": f"no route {self.path}"})
            finally:
                self._observe(t0)

        def do_POST(self):
            t0 = time.perf_counter()
            try:
                self._post()
            finally:
                self._observe(t0)
                if access is not None and self.path == "/generate":
                    row = self._gen_row or {}
                    access.write({
                        "ts": round(time.time(), 3),
                        "request_id": self._trace_id,
                        "trace_inherited": self._trace_inherited,
                        "status": self._last_code,
                        "latency_ms": round(
                            (time.perf_counter() - t0) * 1000.0, 3
                        ),
                        **row,
                    })

        def _post(self):
            self._trace_id = None
            self._last_code = None
            self._gen_row = None
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            # Same trace contract as /predict: adopt a valid inbound
            # X-DSST-Trace (router hop), mint otherwise; every streamed
            # chunk of this generation then shares the id the response
            # header echoes.
            inbound = tracecontext.Handoff.from_header(
                self.headers.get("X-DSST-Trace")
            )
            self._trace_inherited = inbound.ctx is not None
            with tracecontext.trace(
                kind="request",
                trace_id=(
                    inbound.ctx.trace_id if inbound.ctx is not None
                    else None
                ),
            ) as tctx:
                self._trace_id = tctx.trace_id
                with telemetry.span("serve.generate"):
                    self._generate()

        def _chunk(self, data: bytes) -> None:
            # One HTTP/1.1 chunk per ndjson line: hex length, CRLF,
            # data, CRLF — flushed so the client sees the token NOW.
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
            self.wfile.flush()

        def _generate(self):
            _close = {"Connection": "close"}
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"},
                           headers=_close)
                return
            if length < 0:
                self._json(400, {"error": "bad Content-Length"},
                           headers=_close)
                return
            if length > max_body_bytes:
                self._json(413, {
                    "error": f"body {length} bytes exceeds limit "
                             f"{max_body_bytes}",
                }, headers=_close)
                return
            body = self.rfile.read(length)
            try:
                payload = json.loads(body)
                prompt = payload["tokens"]
                if not isinstance(prompt, list):
                    raise TypeError("tokens must be a list of ints")
                top_k = payload.get("top_k")
                eos_id = payload.get("eos_id")
                if not lifecycle.accepting:
                    raise NotAccepting("server is draining")
                gen = engine.submit(
                    prompt,
                    int(payload.get("max_new_tokens", 16)),
                    temperature=float(payload.get("temperature", 0.0)),
                    top_k=None if top_k is None else int(top_k),
                    eos_id=None if eos_id is None else int(eos_id),
                    seed=int(payload.get("seed", 0)),
                    trace_id=self._trace_id,
                )
            except PromptTooLong as e:
                # The per-slot capacity guard: rejected at the door
                # (400), never a scatter past the preallocated arena.
                self._json(400, {"error": str(e)})
                return
            except QueueFull as e:
                self._json(429, {"error": str(e)},
                           headers={"Retry-After": str(e.retry_after)})
                return
            except (DeadlineExceeded, NotAccepting) as e:
                self._json(503, {"error": str(e)})
                return
            except (json.JSONDecodeError, KeyError, TypeError,
                    ValueError) as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._stream(gen, len(prompt))

        def _stream(self, gen, prompt_tokens: int) -> None:
            """Drain one generation's event queue into chunked ndjson."""
            import queue as _queue

            t_submit = time.perf_counter()
            try:
                first = gen.next_event(timeout=_event_timeout)
            except _queue.Empty:
                gen.cancel()
                self._json(500, {"error": "engine produced no tokens"},
                           headers={"Connection": "close"})
                return
            if first[0] == "error":
                # Nothing streamed yet (deadline passed while queued):
                # the clean 503 the image tier would have sent.
                self._json(503, {"error": str(first[1])})
                return
            self._last_code = 200
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            if self._trace_id is not None:
                self.send_header("X-DSST-Trace", self._trace_id)
            self.end_headers()
            n_tokens = 0
            ttft_ms = None
            reason = "error"
            event = first
            try:
                while True:
                    if event[0] == "token":
                        if ttft_ms is None:
                            ttft_ms = round(
                                (time.perf_counter() - t_submit) * 1000.0,
                                3,
                            )
                        self._chunk(json.dumps(
                            {"token": event[1], "index": event[2]}
                        ).encode() + b"\n")
                        n_tokens += 1
                    else:
                        # ("done", reason) or ("error", exc) mid-stream:
                        # both settle the stream with a terminal line.
                        reason = (
                            event[1] if event[0] == "done"
                            else f"error: {event[1]}"
                        )
                        self._chunk(json.dumps({
                            "done": reason,
                            "tokens": n_tokens,
                            "trace": self._trace_id,
                        }).encode() + b"\n")
                        self._chunk(b"")  # terminal 0-length chunk
                        break
                    event = gen.next_event(timeout=_event_timeout)
            except _queue.Empty:
                # Engine wedged mid-stream: close the chunk framing
                # without a done-line (the absent terminal record is
                # the client's signal the stream died) and drop the
                # connection.
                gen.cancel()
                reason = "error: engine stalled"
                self._chunk(b"")
                self.close_connection = True
            except (BrokenPipeError, ConnectionResetError):
                # Client went away mid-stream: retire the slot now
                # instead of decoding tokens nobody reads.
                gen.cancel()
                reason = "cancelled"
                self.close_connection = True
            self._gen_row = {
                "prompt_tokens": prompt_tokens,
                "tokens": n_tokens,
                "reason": reason,
                "ttft_ms": ttft_ms,
            }

    server = _ServingHTTPServer(
        (host, port), LMHandler, queue_depth=cfg.queue_depth
    )
    server.scheduler = engine
    server.lifecycle = lifecycle
    lifecycle.mark_ready()
    return server


def serve_lm_in_thread(engine, host: str = "127.0.0.1", port: int = 0, *,
                       access_log: str | os.PathLike | None = None,
                       ) -> ServerHandle:
    """A running token-streaming server as a :class:`ServerHandle`.

    ``engine`` must already be ``start()``-ed. ``handle.close()``
    drains it through the verbatim image-tier lifecycle: stop
    admitting (503), finish every in-flight slot, stop the accept
    loop, close the socket."""
    server = make_lm_server(engine, host, port, access_log=access_log)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return ServerHandle(server, thread)
