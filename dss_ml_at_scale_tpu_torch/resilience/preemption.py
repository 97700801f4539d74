"""Preemption-safe training: the SIGTERM seam.

Port of ``dss_ml_at_scale_tpu/resilience/preemption.py``. Spot and
preemptible cards announce eviction with SIGTERM and a short grace
window. The default Python behavior — die
mid-step with whatever the last epoch-boundary checkpoint happened to
be — throws away up to an epoch of work. :class:`PreemptionGuard` turns
the signal into a flag the training loop polls once per step: finish
the in-flight step, save a resumable checkpoint, and return a
``FitResult`` marked ``preempted=True`` so a follow-up ``--resume``
continues exactly where the evictor cut in.

Signal handlers only install on the main thread; off it (a fit driven
from a worker thread) the guard degrades to an inert flag rather than
raising — library code must not make embedding impossible.
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager: SIGTERM → a poll-able flag instead of death."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self.installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        """Manual trigger (tests, cooperative shutdown paths)."""
        self._event.set()

    def _handler(self, signum, frame) -> None:
        # Async-signal-safety: the handler runs on the main thread at an
        # arbitrary bytecode boundary — possibly while that same thread
        # holds the telemetry registry lock or a logging lock. Touching
        # either here would self-deadlock (non-reentrant locks), hanging
        # the process through the eviction grace window with NO
        # checkpoint. Set the event and nothing else; the polling loop
        # meters and logs after it observes `triggered`.
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self  # inert off the main thread; .trigger() still works
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
            self.installed = True
        except (ValueError, OSError):  # exotic embedders; stay inert
            self._previous.clear()
        return self

    def __exit__(self, *exc) -> bool:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                log.warning("could not restore handler for signal %d", sig)
        self._previous.clear()
        self.installed = False
        return False
