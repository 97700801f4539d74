"""Decode pool and cross-request batcher threads.

Port of ``dss_ml_at_scale_tpu/serving/batcher.py``: the two worker stages
between admission and the scorer.

- :class:`DecodePool` — N threads turning raw JPEG bytes into decoded
  arrays *off* the scoring thread, so host-side libjpeg work overlaps
  the card's scoring instead of serializing in front of it (the serving
  analogue of the training reader's decode workers).
- :class:`Batcher` — ONE thread that coalesces decoded images *across
  requests* into the fixed micro-batch shape: take the first
  waiting image, then keep gathering until the batch is full or the
  batch window elapses, whichever comes first. Sixteen concurrent
  single-image requests ride one padded scorer call instead of
  sixteen; a lone request waits at most the window.

Both stages are policy-free plumbing: what "decode", "score", "skip"
and "expired" mean is injected by the scheduler, so this module never
imports a predictor, telemetry, or HTTP anything — and the unit tests
can drive it with plain lists.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time


def _NULL_TRACE(job):
    return contextlib.nullcontext()


class DecodePool:
    """N daemon threads: decode-queue → (decode) → batch-queue.

    The decode queue carries *jobs* — each a list of one request's
    :class:`~.admission.WorkItem`\\ s — so a multi-image request keeps
    its vectorized decode (ONE ``decode`` call over N payloads, not N
    calls of 1); the decoded items then fan out per image into the
    batch queue, where cross-request coalescing is per-image again.

    Jobs whose request already settled (deadline hit while waiting,
    sibling image failed) are skipped via ``on_skip`` (per item)
    without paying the decode. A decode raise fails the whole request
    via ``on_error`` — one broken image makes the request's response an
    error, matching the synchronous path's semantics.
    """

    def __init__(self, *, decode, in_q: queue.Queue, out_q: queue.Queue,
                 on_skip, on_error, stop: threading.Event,
                 workers: int = 2, poll_s: float = 0.05, trace=None):
        if workers < 1:
            raise ValueError(f"decode workers must be >= 1, got {workers}")
        self._decode = decode
        self._in_q = in_q
        self._out_q = out_q
        self._on_skip = on_skip
        self._on_error = on_error
        self._stop = stop
        self._poll_s = poll_s
        # Optional tracing hook: a callable(job) returning a context
        # manager the decode runs inside (the scheduler injects the
        # request's trace handoff + span there — this module stays
        # policy- and telemetry-free).
        self._trace = trace if trace is not None else _NULL_TRACE
        self._threads = [
            threading.Thread(
                target=self._run, name=f"dsst-serve-decode-{i}", daemon=True
            )
            for i in range(workers)
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def join(self, timeout: float = 2.0) -> None:
        for t in self._threads:
            t.join(timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._in_q.get(timeout=self._poll_s)
            except queue.Empty:
                continue
            req = job[0].request
            if req.settled or req.expired():
                for item in job:
                    self._on_skip(item)
                continue
            try:
                with self._trace(job):
                    images = self._decode([item.payload for item in job])
            except Exception as exc:
                self._on_error(job, exc)
                continue
            for item, image in zip(job, images):
                item.image = image
                self._out_q.put(item)


class Batcher:
    """ONE thread: batch-queue → (coalesce) → ``run_batch``.

    The fill policy is wait-up-to-window *after the first image*, so an
    idle server adds zero latency floor beyond the window, and a busy
    server's batches fill instantly from the queue without waiting at
    all. Expired/settled items discovered at assembly time are dropped
    via ``on_skip`` — the scorer never runs for a client that
    already got its 503.
    """

    def __init__(self, *, in_q: queue.Queue, micro_batch: int,
                 window_s: float, run_batch, on_skip,
                 stop: threading.Event, poll_s: float = 0.05):
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        self._in_q = in_q
        self._micro_batch = micro_batch
        self._window_s = max(window_s, 0.0)
        self._run_batch = run_batch
        self._on_skip = on_skip
        self._stop = stop
        self._poll_s = poll_s
        self._thread = threading.Thread(
            target=self._run, name="dsst-serve-batcher", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: float = 2.0) -> None:
        self._thread.join(timeout)

    def _gather(self, first) -> list:
        """``first`` plus whatever arrives before full-or-window."""
        batch = [first]
        window_end = time.monotonic() + self._window_s
        while len(batch) < self._micro_batch:
            left = window_end - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self._in_q.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._in_q.get(timeout=self._poll_s)
            except queue.Empty:
                continue
            batch = self._gather(first)
            live = []
            for item in batch:
                if item.request.settled or item.request.expired():
                    self._on_skip(item)
                else:
                    live.append(item)
            if live:
                self._run_batch(live)
