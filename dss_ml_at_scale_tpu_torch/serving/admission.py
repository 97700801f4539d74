"""Admission control for the serving tiers.

Port copy of ``dss_ml_at_scale_tpu/serving/admission.py``, cut to what the
LM engine uses: the counted admission gate and the refusals the HTTP layer
maps to status codes. The image tier's ``Request``/``WorkItem`` come with
the image-serving slice.

A bounded count of admitted-but-unfinished work, rejected at the door
(:class:`QueueFull`, HTTP 429) with a ``Retry-After`` taken from the
measured service rate, never mid-pipeline. The LM engine admits one unit
per generation and releases it when the generation settles.
"""

from __future__ import annotations

import math
import threading


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
