"""Admission control for the serving scheduler.

Port of ``dss_ml_at_scale_tpu/serving/admission.py``. The front door of
the cross-request batching pipeline: a bounded count of
admitted-but-unfinished images. Admission is *counted*, not queued — the
actual work items flow through the decode/batch queues — so the bound
covers everything the process has promised to score, wherever it
currently sits (waiting for decode, decoded and waiting for a batch slot,
or mid-score on the device). The LM engine admits one unit per
generation through the same gate.

Design points:

- **Reject at the door, not mid-pipeline**: a request either fits under
  ``depth`` whole or is refused with :class:`QueueFull` before any of
  its images enter a queue — no partial admissions to unwind.
- **Retry-After from measured service rate**: the controller keeps an
  EWMA of seconds-per-image observed by the batcher, so the 429 a
  client sees carries an honest estimate of when capacity frees up
  instead of a magic constant.
- **Deadlines settle requests, never threads**: an expired
  :class:`Request` is *settled* (client unblocked with
  :class:`DeadlineExceeded`) while its items are still in the queues;
  workers recognize settled requests and retire the items lazily. No
  scan-and-remove over queue internals, no lock ordering between the
  queues and the request.
"""

from __future__ import annotations

import math
import threading
import time


class SchedulerError(Exception):
    """Base of every scheduler-surfaced refusal (never a server fault)."""


class QueueFull(SchedulerError):
    """Admission refused: the pending-image bound is hit (HTTP 429).

    ``retry_after`` is whole seconds (ceil, >= 1) — the unit the HTTP
    ``Retry-After`` header speaks.
    """

    def __init__(self, depth: int, pending: int, retry_after: float = 1.0):
        self.depth = depth
        self.pending = pending
        self.retry_after = max(1, int(math.ceil(retry_after)))
        super().__init__(
            f"admission queue full ({pending}/{depth} images pending)"
        )


class DeadlineExceeded(SchedulerError):
    """The request's deadline passed before scoring finished (HTTP 503).

    The work is *dropped*, not scored late: items of an expired request
    are skipped by the decode pool and batcher, so a backed-up server
    sheds load instead of burning scorer time on answers nobody is
    waiting for.
    """


class NotAccepting(SchedulerError):
    """The scheduler is draining or stopped (HTTP 503)."""


class Request:
    """One client request: ``n`` images in, ``n`` result rows out.

    Settles exactly once — either every item completes (``results`` is
    full) or :meth:`fail` records the first error (deadline, decode
    failure, scorer fault). Completions after settlement are no-ops, so
    a batch that finishes scoring just as the deadline fires cannot
    corrupt the already-delivered 503.
    """

    __slots__ = ("n", "deadline", "t_admit", "results", "error",
                 "trace", "batch_fill", "_remaining", "_done", "_lock")

    # Lock contract: settlement state is written by whichever worker
    # thread ends the request — always under _lock. (Readers outside this class consume it only after
    # the _done event, which publishes the writes.)
    _guarded_by_lock = ("results", "error", "_remaining")

    def __init__(self, n: int, deadline: float | None = None):
        self.n = n
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.t_admit = time.monotonic()
        self.results: list = [None] * n
        self.error: BaseException | None = None
        # Causal identity, attached by the scheduler: the submitting
        # thread's trace handoff (workers adopt it around decode/score
        # spans). This module stays telemetry-free — it only carries
        # the object.
        self.trace = None
        # Fill of the micro-batch this request last scored in (written
        # by the batcher thread before completion, read by the handler
        # after settlement — the _done event publishes the write).
        self.batch_fill: int | None = None
        self._remaining = n
        self._done = threading.Event()
        self._lock = threading.Lock()

    @property
    def settled(self) -> bool:
        return self._done.is_set()

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def complete_item(self, index: int, row) -> None:
        with self._lock:
            if self._done.is_set():
                return  # settled (expired/failed) — result discarded
            self.results[index] = row
            self._remaining -= 1
            if self._remaining == 0:
                self._done.set()

    def fail(self, exc: BaseException) -> bool:
        """Settle with ``exc``; True only for the call that settled it."""
        with self._lock:
            if self._done.is_set():
                return False
            self.error = exc
            self._done.set()
            return True

    def outcome(self) -> tuple[BaseException | None, list]:
        """Settlement snapshot ``(error, results)``, read under the
        lock: the timeout/stop paths read them while a worker thread can
        still be settling the request. One locked snapshot serves every
        exit path."""
        with self._lock:
            return self.error, list(self.results)

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)


class WorkItem:
    """One image of one request, as it flows decode-queue → batch-queue.

    ``retire()`` is the single accounting point: whichever worker ends
    the item's life (scored, skipped, failed, or flushed at stop) calls
    it, and only the first caller releases the admission slot.
    """

    __slots__ = ("request", "index", "payload", "image", "_retired")

    def __init__(self, request: Request, index: int, payload):
        self.request = request
        self.index = index
        self.payload = payload  # raw bytes in
        self.image = None       # decoded array out of the decode pool
        self._retired = False

    def retire(self) -> bool:
        """True only for the first caller (under the request's lock)."""
        with self.request._lock:
            if self._retired:
                return False
            self._retired = True
            return True


class AdmissionController:
    """The bounded gate: at most ``depth`` images pending at once."""

    # Lock contract: HTTP handler threads admit, worker threads release,
    # the batcher feeds the service-rate EWMA — all under _lock.
    _guarded_by_lock = ("_pending", "_seconds_per_image")

    def __init__(self, depth: int, on_depth=None):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._pending = 0
        self._lock = threading.Lock()
        self._on_depth = on_depth or (lambda n: None)
        # Seed pessimistically (50 ms/image ≈ a cold CPU scorer); real
        # measurements from the batcher replace it within one batch.
        self._seconds_per_image = 0.05

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    @property
    def service_rate_ewma(self) -> float:
        """The measured seconds-per-image EWMA (what Retry-After is
        computed from), exported as a gauge."""
        with self._lock:
            return self._seconds_per_image

    @property
    def est_queue_wait_s(self) -> float:
        """Estimated wait for a newly admitted image: everything
        already pending, at the measured service rate."""
        with self._lock:
            return self._pending * self._seconds_per_image

    def note_service_rate(self, seconds_per_image: float) -> None:
        """EWMA of measured scoring cost, feeding Retry-After."""
        with self._lock:
            self._seconds_per_image = (
                0.7 * self._seconds_per_image + 0.3 * max(seconds_per_image, 0.0)
            )

    def admit(self, n: int) -> None:
        """Reserve ``n`` slots or raise :class:`QueueFull` (all or nothing)."""
        with self._lock:
            if self._pending + n > self.depth:
                raise QueueFull(
                    self.depth, self._pending,
                    retry_after=self._pending * self._seconds_per_image,
                )
            self._pending += n
            depth_now = self._pending
        self._on_depth(depth_now)

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._pending -= n
            depth_now = self._pending
        self._on_depth(depth_now)
