"""HTTP inference serving: images (`serve`) and tokens (`serve-lm`).

Port of ``dss_ml_at_scale_tpu/workloads/serving.py``: a stdlib
``ThreadingHTTPServer`` in front of a scorer, with the serving scheduler
(:mod:`..serving`) between them, and the same routes, status codes and
``X-DSST-Trace`` contract as the JAX package.

The image tier:

- **One scorer, fixed shapes**: :class:`Predictor` scores at a fixed
  micro-batch; requests are padded up to it (and chunked above it), so
  every call the card sees has one shape and the latency profile is flat
  after the warm-up call.
- **Scheduler-mediated scoring**: HTTP threads never run the model. They
  admit into a bounded queue (429 + ``Retry-After`` when full, 503 when a
  per-request deadline expires waiting), a decode pool turns JPEG bytes
  into arrays off the scoring thread, and one batcher thread coalesces
  images across requests into the micro-batch.
- **Same decode, same normalization**: images go through the training
  transform spec (``imagenet_transform_spec``) and the scorer ``predict``
  uses (``config/checkpoints.make_scorer``); class names come from the
  label vocabulary persisted with the checkpoint, so predictions match
  ``predict`` by construction.
- **Endpoints**: ``GET /healthz`` (liveness: 200 until the process exits,
  draining included), ``GET /readyz`` (200 only while accepting),
  ``GET /metrics`` (Prometheus text), ``GET /slo``, ``GET /telemetry``,
  and ``POST /predict`` with a raw JPEG body or JSON ``{"instances":
  ["<base64 jpeg>", ...]}`` -> ``{"predictions": [{"pred_index",
  "pred_prob", "pred_label"}, ...]}``.

The LM tier (:func:`make_lm_server`, :func:`serve_lm_in_thread`) puts an
:class:`~..serving.lm.LMEngine` behind ``POST /generate`` with a chunked
NDJSON stream. Both speak HTTP/1.1 keep-alive with exact
``Content-Length`` on every non-streamed response.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .. import telemetry
from ..serving import (
    DeadlineExceeded,
    Lifecycle,
    NotAccepting,
    QueueFull,
    SchedulerConfig,
    ServerHandle,
    ServingScheduler,
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



class NonFiniteScoreError(RuntimeError):
    """The scorer produced NaN/Inf probabilities.

    A server-side fault (corrupt checkpoint weights, poisoned batch-norm
    statistics, a numeric fault on the card), never the client's input:
    it maps to HTTP 500, counted on ``scoring_nonfinite_total``. Without
    the guard the NaN would go out as JSON ``NaN``, which most clients
    reject as invalid JSON after the 200 status already went out.
    """


class Predictor:
    """Checkpoint -> fixed-batch scorer on the card.

    The scoring pipeline is split where the scheduler needs it split:
    :meth:`decode` (host-side JPEG -> normalized array, safe to run from
    many decode workers) and :meth:`score` (pad/chunk to ``micro_batch``,
    one model call per chunk: the batcher thread's half). :meth:`predict`
    composes the two for synchronous embedding use.
    """

    def __init__(self, checkpoint_dir: str, *, step: int | None = None,
                 micro_batch: int = 8, resolved=None, device="cuda"):
        """``resolved``: an already computed ``resolve_checkpoint`` result
        ``(meta, crop, model, task)`` (the ``serve`` command resolves the
        checkpoint for its own diagnostics first); else the checkpoint is
        resolved here, its model built on ``device``."""
        from ..config.checkpoints import make_scorer, resolve_checkpoint
        from ..data.transform import imagenet_transform_spec
        from ..parallel import restore_state

        self.meta, self.crop, model, task = (
            resolved if resolved is not None
            else resolve_checkpoint(checkpoint_dir, device=device)
        )
        self.micro_batch = int(micro_batch)
        self.label_names = self.meta.get("label_names")
        self.device = next(model.parameters()).device
        # The training/predict transform (resize-256 field of view, the
        # normalization, the decode backend): serving scores the pixels
        # the model was trained on.
        self._spec = imagenet_transform_spec(crop=self.crop)
        self.step = restore_state(task, checkpoint_dir, step=step)
        # The scorer predict uses: parity by construction.
        self._score = make_scorer(task)
        self._predict_hist = telemetry.histogram(
            "predict_batch_seconds",
            "Predictor.score latency (pad + score + host fetch)",
        )
        self._predict_images = telemetry.counter(
            "predict_images_total", "images scored by Predictor.score"
        )
        self._predict_errors = telemetry.counter(
            "predict_errors_total", "Predictor.score calls that raised"
        )
        # One warm-up call at the serving shape: the first request pays
        # no library set-up.
        self._score(torch.zeros((self.micro_batch, self.crop, self.crop, 3),
                                device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode(self, jpegs: list[bytes]):
        """JPEG bytes -> normalized image array ``(N, crop, crop, 3)``:
        host work the scheduler's decode pool runs off the scorer."""
        content = np.empty(len(jpegs), object)
        content[:] = jpegs
        cols = self._spec({"content": content,
                           "label_index": np.zeros(len(jpegs), np.int64)})
        return cols["image"]

    def score(self, images) -> list[dict]:
        """Decoded images -> prediction rows: the tail chunk padded to
        ``micro_batch`` and larger inputs chunked, so every model call has
        the one shape."""
        t0 = time.perf_counter()
        try:
            out = self._score_images(images)
        except BaseException:
            self._predict_errors.inc()
            raise
        self._predict_hist.observe(time.perf_counter() - t0)
        self._predict_images.inc(len(images))
        return out

    def predict(self, jpegs: list[bytes]) -> list[dict]:
        """Synchronous decode + score of one request's images."""
        return self.score(self.decode(jpegs))

    def _score_images(self, images) -> list[dict]:
        out: list[dict] = []
        for lo in range(0, len(images), self.micro_batch):
            chunk = images[lo:lo + self.micro_batch]
            n = len(chunk)
            if n < self.micro_batch:  # pad to the one shape
                chunk = np.concatenate(
                    [chunk, np.zeros((self.micro_batch - n, *chunk.shape[1:]), chunk.dtype)])
            idx, prob = self._score(torch.from_numpy(np.ascontiguousarray(chunk))
                                    .to(self.device))
            # One host fetch per output per chunk, not per image.
            idx, prob = idx.cpu().numpy(), prob.cpu().numpy()
            # Only the real rows count: the padding rows score zeros.
            bad = int((~np.isfinite(prob[:n])).sum())
            if bad:
                telemetry.counter(
                    "scoring_nonfinite_total",
                    "scored images rejected for non-finite probabilities "
                    "(HTTP 500, never serialized)",
                ).inc(bad)
                raise NonFiniteScoreError(
                    f"{bad} non-finite probabilities from the scorer "
                    f"(checkpoint step {self.step})")
            for i in range(n):
                k = int(idx[i])
                row = {"pred_index": k, "pred_prob": float(prob[i])}
                if self.label_names and 0 <= k < len(self.label_names):
                    row["pred_label"] = self.label_names[k]
                out.append(row)
        return out


def make_server(predictor, host: str = "127.0.0.1",
                port: int = 8008, *,
                max_body_bytes: int = 64 * 1024 * 1024,
                max_instances: int = 1024,
                config: SchedulerConfig | None = None,
                access_log: str | os.PathLike | None = None,
                ) -> ThreadingHTTPServer:
    """A ready-to-run server (caller picks ``serve_forever`` vs thread).

    The returned server owns a started :class:`ServingScheduler`
    (``server.scheduler``) and its :class:`Lifecycle`
    (``server.lifecycle``), already marked READY — callers drive the
    drain through them (or use :func:`serve_in_thread`'s handle).

    ``max_body_bytes`` / ``max_instances`` bound what one request can
    make the server materialize (413 above the caps): without them a
    single oversized POST would be read and base64-decoded wholesale
    into memory (low-risk at the 127.0.0.1 default bind, but the caps
    make the exposure explicit and configurable).

    ``access_log`` (a path) enables the structured request log: one
    JSONL row per /predict, flushed as it happens (operational
    evidence, not durable state — a crash loses at most the in-flight
    row). Rows carry the request's trace id (``request_id``, the same
    value the ``X-DSST-Trace`` response header echoes), the HTTP
    status, image count, measured ``queue_ms``, and the ``batch_fill``
    of the micro-batch the request scored in — enough to answer "what
    did request X experience" without a debugger."""

    # Registered before the first request so a scrape of a fresh server
    # already declares the series (# TYPE lines render for empty
    # families). One histogram labeled by path, one error counter by
    # status code.
    request_hist = telemetry.histogram(
        "serving_request_seconds", "HTTP request latency", labels=("path",)
    )
    error_counter = telemetry.counter(
        "serving_errors_total", "HTTP 4xx/5xx responses", labels=("code",)
    )
    # The live half of the latency story: a sliding-window quantile
    # sketch next to the cumulative histogram, so /metrics can answer
    # "what is p99 NOW" instead of "what was p99 since boot".
    request_window = telemetry.window(
        "serving_request_window_seconds",
        "live windowed /predict latency (quantiles over the window, "
        "rendered as a summary)",
    )
    slo_engine = telemetry.slo.get_engine()

    lifecycle = Lifecycle()
    scheduler = ServingScheduler(predictor, config, lifecycle=lifecycle)
    access = JsonlWriter(access_log) if access_log else None
    _deadline_ms = scheduler.config.deadline_ms

    _known_paths = frozenset(
        ("/healthz", "/readyz", "/metrics", "/slo", "/telemetry",
         "/predict")
    )

    def _deadline_met(latency_ok: bool | None) -> bool | None:
        """Did this request beat the armed deadline? Reuses the SAME
        latency classification the SLO objective aggregated (so the
        two row fields can never contradict each other); None when no
        deadline is configured, or when the request never reached a
        scoring verdict (429 refused at the door, 4xx client errors)."""
        if _deadline_ms <= 0:
            return None
        return latency_ok

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 with exact Content-Length everywhere → keep-alive:
        # clients reuse the connection instead of paying TCP setup per
        # request under load.
        protocol_version = "HTTP/1.1"
        # Keep-alive's tax: an idle connection parks a handler thread in
        # readline(). The socket timeout reaps it; without this a quiet
        # client would pin a thread forever.
        timeout = 60

        # Per-request state (one handler instance serves one connection,
        # requests on it are sequential): the trace id echoed back as
        # X-DSST-Trace, the last response code, and the scheduler's
        # accounting side channel — what the access-log row is built of.
        _trace_id = None
        _trace_inherited = False
        _last_code = None
        _req_info = None
        _req_images = None

        def log_message(self, *a):  # quiet by default; errors still raise
            pass

        def _observe(self, t0: float) -> None:
            # Unknown paths collapse to one label so a port scan can't
            # explode series cardinality.
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
                # The request's causal identity, echoed to the client:
                # quote it back to find the request's cross-thread
                # spans.
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
            self._trace_id = None  # keep-alive: no stale header echo
            try:
                if self.path == "/healthz":
                    # Liveness: 200 even while draining — a draining
                    # server is healthy; restarting it would kill the
                    # work the drain protects.
                    self._json(200, {
                        "status": "ok",
                        "state": lifecycle.state,
                        "model": predictor.meta.get("model"),
                        "checkpoint_step": predictor.step,
                        "crop": predictor.crop,
                    })
                elif self.path == "/readyz":
                    # Readiness: only READY takes traffic.
                    if lifecycle.accepting:
                        self._json(200, {"ready": True,
                                         "state": lifecycle.state})
                    else:
                        self._json(503, {"ready": False,
                                         "state": lifecycle.state})
                elif self.path == "/metrics":
                    self._metrics()
                elif self.path == "/slo":
                    # The judging plane next to the measuring plane:
                    # every declared objective's live value, burn
                    # rates, and alert state (schema v1).
                    self._json(200, slo_engine.render_status())
                elif self.path == "/telemetry":
                    # The full registry in raw form (per-bucket counts,
                    # window digests) plus the SLO engine's
                    # measurement windows.
                    doc = telemetry.get_registry().wire_snapshot()
                    doc["slo_sources"] = slo_engine.wire_sources()
                    self._json(200, doc)
                else:
                    self._json(404, {"error": f"no route {self.path}"})
            finally:
                # Mirror do_POST: a client hanging up mid-response must
                # not drop the request from the latency histogram.
                self._observe(t0)

        def do_POST(self):
            t0 = time.perf_counter()
            try:
                self._post()
            finally:
                self._observe(t0)
                dur_s = time.perf_counter() - t0
                status = self._last_code
                latency_ok = verdict = None
                if self.path == "/predict" and status is not None:
                    # Feed the live plane: the windowed sketch (what
                    # /metrics renders as the summary quantiles) and the
                    # SLO engine's latency/error objectives, each
                    # carrying the request's trace id so a burn-rate
                    # alert can point at its worst offender.
                    # note_request returns THE shared classification
                    # (telemetry.slo.classify_request) — the access-log
                    # row reuses it, so the journaled per-request
                    # ground truth and the live objective can never
                    # judge the same request differently (and the
                    # request is classified exactly once).
                    request_window.observe(dur_s, trace=self._trace_id)
                    _, latency_ok, verdict = slo_engine.note_request(
                        dur_s, status, trace_id=self._trace_id
                    )
                if access is not None and self.path == "/predict":
                    info = self._req_info or {}
                    access.write({
                        "ts": round(time.time(), 3),
                        "request_id": self._trace_id,
                        # Propagated (adopted from X-DSST-Trace) vs
                        # minted here — the field that tells a router
                        # hop apart from a direct client when
                        # debugging fleet traces.
                        "trace_inherited": self._trace_inherited,
                        "status": status,
                        "images": self._req_images,
                        "latency_ms": round(dur_s * 1000.0, 3),
                        "queue_ms": info.get("queue_ms"),
                        "batch_fill": info.get("batch_fill"),
                        # Per-request SLO ground truth — what the
                        # windowed latency objective aggregates.
                        "deadline_met": _deadline_met(latency_ok),
                        "slo": verdict,
                    })

        def _post(self):
            self._trace_id = None  # keep-alive: no stale header echo
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            # One trace per request, opened at the HTTP edge. A valid
            # inbound X-DSST-Trace header (a client or router hop that
            # already minted the unit's identity) is ADOPTED — its
            # trace_id continues here, so the hop renders as one
            # linked Perfetto flow. Malformed or absent mints fresh,
            # exactly as before: from_header never raises on hostile
            # input, it just yields an empty handoff. Everything
            # downstream (admission, decode pool, batcher) shares this
            # trace_id, and the response echoes it as X-DSST-Trace.
            self._last_code = None
            self._req_info = None
            self._req_images = None
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
                with telemetry.span("serve.request"):
                    self._post_predict()

        def _post_predict(self):
            # Responding WITHOUT consuming the body would leave its
            # bytes in the keep-alive stream, desyncing the next
            # request on this connection — these early returns must
            # advertise and perform a close (send_header("Connection",
            # "close") also sets close_connection).
            _close = {"Connection": "close"}
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "bad Content-Length"},
                           headers=_close)
                return
            if length < 0:
                # A negative length would make rfile.read() read until
                # EOF — exactly the unbounded read the cap exists to
                # prevent.
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
                if self.headers.get("Content-Type", "").startswith(
                    "application/json"
                ):
                    payload = json.loads(body)
                    instances = payload["instances"]
                    if (not isinstance(instances, list)
                            or len(instances) > max_instances):
                        self._json(413 if isinstance(instances, list)
                                   else 400, {
                            "error": "instances must be a list of at "
                                     f"most {max_instances} items",
                        })
                        return
                    jpegs = [base64.b64decode(x) for x in instances]
                else:
                    jpegs = [body]  # raw single JPEG
                if not jpegs:
                    raise ValueError("empty instances")
                self._req_images = len(jpegs)
                self._req_info = {}
                preds = scheduler.submit(jpegs, info=self._req_info)
            except QueueFull as e:
                # Backpressure, not failure: the client should retry
                # after the queue's measured time-to-capacity.
                self._json(429, {"error": str(e)},
                           headers={"Retry-After": str(e.retry_after)})
                return
            except (DeadlineExceeded, NotAccepting) as e:
                # Too late (deadline) or going away (drain): shed, 503.
                self._json(503, {"error": str(e)})
                return
            except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                    OSError) as e:
                # Input-shaped failures (bad JSON, missing keys, broken
                # base64/JPEG bytes) are the CLIENT's 400 ...
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:
                # ... a genuine server-side fault (a CUDA runtime
                # error, OOM, non-finite scores) is a 500 — and must
                # not kill serving either.
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {"predictions": preds})

    server = _ServingHTTPServer(
        (host, port), Handler, queue_depth=scheduler.config.queue_depth
    )
    server.scheduler = scheduler
    server.lifecycle = lifecycle
    scheduler.start()
    lifecycle.mark_ready()
    return server


def serve_in_thread(predictor, host: str = "127.0.0.1", port: int = 0, *,
                    config: SchedulerConfig | None = None,
                    access_log: str | os.PathLike | None = None,
                    ) -> ServerHandle:
    """A running server as a :class:`ServerHandle` — the test and
    embedding entry point; ``port=0`` picks a free port
    (``handle.port``). ``handle.close()`` performs the graceful drain
    (stop admitting → finish queued work → stop the accept loop → close
    the socket), so embedders never leak the server socket or kill
    in-flight requests mid-write."""
    server = make_server(predictor, host, port, config=config,
                         access_log=access_log)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return ServerHandle(server, thread)


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
