"""The serving scheduler: admission → decode pool → batcher → scorer.

Port of ``dss_ml_at_scale_tpu/serving/scheduler.py``. Requests are
admitted under a bound, their images decoded by a worker pool, and a
single batcher thread coalesces images *across requests* into the fixed
micro-batch shape before scoring once (instead of every HTTP thread
racing to run the model, a 1-image request padding a whole micro-batch
alone).

What the client sees at each gate:

====================  ======================================  =====
gate                  condition                               HTTP
====================  ======================================  =====
admission             pending images would exceed the depth   429 + Retry-After
deadline              not scored before ``deadline_ms``       503 (work dropped, never scored late)
lifecycle             draining or stopped                     503
decode                broken JPEG / bad base64 payload        400 (raised type preserved)
scorer                CUDA runtime fault, non-finite scores   500
====================  ======================================  =====

Telemetry (all on the process registry, so ``GET /metrics`` sees them):
``serving_queue_depth`` gauge, ``serving_time_in_queue_seconds`` and
``serving_batch_fill`` histograms, ``serving_admission_rejected_total``
/ ``serving_deadline_expired_total`` / ``serving_batches_total``
counters.

The predictor contract is duck-typed: a full
:class:`~..workloads.serving.Predictor` exposes
``decode(jpegs) -> array`` and ``score(images) -> rows`` (the split
pipeline); anything exposing only ``predict(payloads) -> rows`` (test
stubs, foreign models) still works — decode becomes a passthrough and
batches score through ``predict``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time

import numpy as np

from .. import telemetry
from ..telemetry import tracecontext
from .admission import (
    AdmissionController,
    DeadlineExceeded,
    NotAccepting,
    Request,
    WorkItem,
)
from .batcher import Batcher, DecodePool
from .lifecycle import Lifecycle

# Linear-ish fill buckets: micro-batches are small integers; the
# default log-seconds buckets would waste every edge below 1.
FILL_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0,
                48.0, 64.0, 128.0, 256.0)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs the `serve` command exposes; defaults favor low added latency.

    ``queue_depth`` is counted in *images* (the unit of scorer work),
    not requests — one 64-image request costs what 64 singles cost.
    ``deadline_ms`` 0 disables deadlines (embedding/test default; the
    CLI defaults it on). ``batch_window_ms`` is the tradeoff dial: the
    most latency an under-filled batch waits for company.
    """

    queue_depth: int = 64
    batch_window_ms: float = 5.0
    deadline_ms: float = 0.0
    drain_timeout_s: float = 10.0
    decode_workers: int = 2


class ServingScheduler:
    """Cross-request dynamic batching between HTTP and the scorer."""

    def __init__(self, predictor, config: SchedulerConfig | None = None, *,
                 lifecycle: Lifecycle | None = None):
        self.predictor = predictor
        self.config = config or SchedulerConfig()
        self.lifecycle = lifecycle or Lifecycle()
        self.micro_batch = int(getattr(predictor, "micro_batch", 8))

        self._queue_gauge = telemetry.gauge(
            "serving_queue_depth",
            "images admitted and not yet scored (or dropped)",
        )
        self._time_in_queue = telemetry.histogram(
            "serving_time_in_queue_seconds",
            "admission to batch-assembly wait per image",
        )
        self._batch_fill = telemetry.histogram(
            "serving_batch_fill",
            "images per scored batch (micro_batch is a full ride)",
            buckets=FILL_BUCKETS,
        )
        self._rejected = telemetry.counter(
            "serving_admission_rejected_total",
            "requests refused 429 at the admission gate",
        )
        self._expired = telemetry.counter(
            "serving_deadline_expired_total",
            "requests 503'd past their deadline instead of scored late",
        )
        self._batches = telemetry.counter(
            "serving_batches_total", "scored micro-batches"
        )
        # The admission controller's internal model, exported as live
        # gauges: the service-rate EWMA and the queue-wait estimate that
        # a 429's Retry-After is computed from.
        self._svc_rate_gauge = telemetry.gauge(
            "admission_service_rate_ewma",
            "admission controller's EWMA of scorer seconds per image",
        )
        self._queue_wait_gauge = telemetry.gauge(
            "admission_est_queue_wait_ms",
            "estimated queue wait for a newly admitted image "
            "(pending x service-rate EWMA)",
        )

        self._admission = AdmissionController(
            self.config.queue_depth, on_depth=self._queue_gauge.set
        )
        if self.config.deadline_ms > 0:
            # Arm the latency objective with the real budget: the SLO
            # plane judges requests against the deadline clients see.
            from ..telemetry import slo as slo_mod

            slo_mod.get_engine().set_latency_budget(
                self.config.deadline_ms / 1000.0
            )
        self._decode_q: queue.Queue = queue.Queue()
        self._batch_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()

        if hasattr(predictor, "decode") and hasattr(predictor, "score"):
            # Decode jobs are per REQUEST, so a multi-image request
            # keeps the transform spec's vectorized decode (one call
            # over N images, not N calls of 1); batching stays per
            # IMAGE downstream.
            self._decode_many = predictor.decode
            self._score_items = lambda items: predictor.score(
                np.stack([it.image for it in items])
            )
        else:
            # predict()-only predictors: payloads pass through decode
            # untouched and score as one coalesced predict() call.
            self._decode_many = lambda payloads: payloads
            self._score_items = lambda items: predictor.predict(
                [it.image for it in items]
            )

        self._pool = DecodePool(
            decode=self._decode_many,
            in_q=self._decode_q,
            out_q=self._batch_q,
            on_skip=self._skip_item,
            on_error=self._fail_job,
            stop=self._stop,
            workers=self.config.decode_workers,
            trace=self._decode_trace,
        )
        self._batcher = Batcher(
            in_q=self._batch_q,
            micro_batch=self.micro_batch,
            window_s=self.config.batch_window_ms / 1000.0,
            run_batch=self._run_batch,
            on_skip=self._skip_item,
            stop=self._stop,
        )
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingScheduler":
        if not self._started:
            self._started = True
            self._pool.start()
            self._batcher.start()
        return self

    @property
    def pending(self) -> int:
        return self._admission.pending

    def drain(self, timeout_s: float | None = None) -> None:
        """Finish admitted work (bounded), then stop the worker threads.

        Callers flip the lifecycle to DRAINING first so admission stops
        feeding the queues and the wait below converges.
        """
        if timeout_s is None:
            timeout_s = self.config.drain_timeout_s
        end = time.monotonic() + timeout_s
        while self._admission.pending > 0 and time.monotonic() < end:
            time.sleep(0.02)
        self.stop()

    def stop(self) -> None:
        """Hard stop: workers exit, anything still queued fails cleanly."""
        self._stop.set()
        self._pool.join()
        self._batcher.join()
        for q in (self._decode_q, self._batch_q):
            while True:
                try:
                    entry = q.get_nowait()
                except queue.Empty:
                    break
                # decode queue holds per-request jobs (lists); batch
                # queue holds single items.
                items = entry if isinstance(entry, list) else [entry]
                for item in items:
                    item.request.fail(NotAccepting("serving stopped"))
                    self._retire(item)
        self.lifecycle.mark_stopped()

    # -- the client-facing call -------------------------------------------

    def submit(self, payloads: list, info: dict | None = None) -> list:
        """Score ``payloads`` through the shared batch pipeline.

        Blocks the calling (HTTP handler) thread until its request
        settles; raises the scheduler refusal or the pipeline's own
        error, exactly as the synchronous path would have.

        ``info`` (optional dict) is populated with per-request
        accounting on the way out — ``queue_ms`` (admission to
        settlement) and ``batch_fill`` (size of the micro-batch the
        request scored in) — the structured-access-log side channel.
        """
        if not payloads:
            raise ValueError("empty batch")
        if len(payloads) > self.config.queue_depth:
            # Admission is all-or-nothing, so a request wider than the
            # whole queue could NEVER be admitted — a 429 here would
            # send a well-behaved client into a forever-retry loop.
            # ValueError is the client's permanent 400.
            raise ValueError(
                f"request of {len(payloads)} images exceeds the "
                f"admission queue depth {self.config.queue_depth}; "
                "send smaller batches"
            )
        if not self.lifecycle.accepting:
            raise NotAccepting(
                f"not accepting requests (state={self.lifecycle.state})"
            )
        try:
            self._admission.admit(len(payloads))
        except Exception:
            self._rejected.inc()
            raise
        cfg = self.config
        deadline = (
            time.monotonic() + cfg.deadline_ms / 1000.0
            if cfg.deadline_ms > 0 else None
        )
        req = Request(len(payloads), deadline)
        # The submitting thread's trace rides the request: the decode
        # pool and batcher adopt it around their spans, so one
        # request_id follows admission → decode → score across threads.
        req.trace = tracecontext.Handoff.capture()
        # One decode job per request (vectorized decode); the pool
        # fans the decoded items out per image for the batcher.
        self._decode_q.put(
            [WorkItem(req, i, payload) for i, payload in enumerate(payloads)]
        )

        while not req.settled:
            timeout = 0.1  # cap only bounds stop-detection; done wakes now
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._expire(req)
                    break
                timeout = min(timeout, left)
            if req.wait(timeout):
                break
            if self._stop.is_set():
                req.fail(NotAccepting("serving stopped"))
                break
        if info is not None:
            info["queue_ms"] = round(
                (time.monotonic() - req.t_admit) * 1000.0, 3
            )
            info["batch_fill"] = req.batch_fill
        # One locked snapshot instead of direct error/results reads: the
        # deadline/stop exits reach here while a worker may still be
        # settling the request.
        error, results = req.outcome()
        if error is not None:
            raise error
        return results

    # -- worker callbacks --------------------------------------------------

    @contextlib.contextmanager
    def _decode_trace(self, job: list):
        """Decode-pool hook: the decode runs under the owning request's
        trace, as a ``serve.decode`` span on the worker thread."""
        handoff = job[0].request.trace or tracecontext.Handoff(None)
        with handoff.activate(), telemetry.span(
            "serve.decode", images=len(job)
        ):
            yield

    def _expire(self, req: Request) -> None:
        if req.fail(DeadlineExceeded(
            f"deadline of {self.config.deadline_ms:g} ms passed before "
            "scoring"
        )):
            self._expired.inc()

    def _retire(self, item: WorkItem) -> None:
        if item.retire():
            self._admission.release(1)

    def _skip_item(self, item: WorkItem) -> None:
        req = item.request
        if not req.settled and req.expired():
            self._expire(req)
        self._retire(item)

    def _fail_job(self, items: list, exc: Exception) -> None:
        items[0].request.fail(exc)
        for item in items:
            self._retire(item)

    def _run_batch(self, items: list) -> None:
        now = time.monotonic()
        for item in items:
            self._time_in_queue.observe(now - item.request.t_admit)
        t0_wall = time.time()
        t0 = time.perf_counter()
        try:
            rows = self._score_items(items)
        except Exception as exc:
            # A scorer fault fails the batch's requests (their handlers
            # answer 500) but never the scheduler: the next batch runs.
            for item in items:
                item.request.fail(exc)
                self._retire(item)
            return
        score_dur = time.perf_counter() - t0
        self._admission.note_service_rate(score_dur / len(items))
        # Sampled exactly where the EWMA is fed: the gauges track the
        # controller's model batch-for-batch, no separate poller.
        self._svc_rate_gauge.set(self._admission.service_rate_ewma)
        self._queue_wait_gauge.set(
            self._admission.est_queue_wait_s * 1000.0
        )
        self._batch_fill.observe(len(items))
        self._batches.inc()
        # One coalesced batch serves many requests; each traced request
        # gets its OWN serve.score span (same wall window, its trace id)
        # on this batcher thread — the third thread hop of the request's
        # flow chain. Recorded BEFORE completion so the handler thread
        # observes batch_fill after settlement.
        by_request: dict[int, tuple] = {}
        for item in items:
            by_request.setdefault(id(item.request), (item.request, []))[
                1
            ].append(item)
        span_log = telemetry.get_span_log()
        for req, req_items in by_request.values():
            req.batch_fill = len(items)
            handoff = req.trace
            if handoff is not None and handoff.ctx is not None:
                span_log.record(
                    "serve.score", t0_wall, score_dur,
                    trace=handoff.ctx,
                    images=len(req_items), batch_fill=len(items),
                )
        for item, row in zip(items, rows):
            item.request.complete_item(item.index, row)
            self._retire(item)
