"""A worker pool with liveness accounting and heartbeat re-admission.

Port of ``dss_ml_at_scale_tpu/resilience/workers.py``. The SparkTrials
property it keeps: work of a lost executor is rescheduled, and the
executor is welcomed back when it rejoins.

- ``get`` and ``put`` block on a condition and wake at once (a re-admitted
  or returned worker wakes a waiter; no polling);
- ``drop`` takes a worker out of the live set and starts a background
  heartbeat probe; when the probe succeeds the worker is re-admitted and
  ``worker_readmitted_total`` goes up;
- with no worker live, ``get`` waits only a short ``dead_grace`` for a
  heartbeat recovery, so a sweep whose workers are all dead fails fast
  instead of serializing a full timeout per trial.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Iterable

from .. import telemetry

log = logging.getLogger(__name__)


class WorkerPool:
    """A thread-safe pool of worker identities with drop, heartbeat and
    re-admission. ``_idle``, ``_live``, ``_probing``, ``_closed`` and
    ``_threads`` are shared by trial threads, heartbeat probes and the
    sweep's waiter: every access outside ``__init__`` holds ``_cond``."""

    def __init__(self, workers: Iterable, *, probe: Callable | None = None,
                 heartbeat_interval: float = 0.5, dead_grace: float = 1.0):
        workers = list(workers)
        self._cond = threading.Condition()
        self._idle: deque = deque(workers)
        self._live: set = set(workers)
        self._probing: set = set()
        self._probe = probe
        self.heartbeat_interval = heartbeat_interval
        self.dead_grace = dead_grace
        self._closed = False
        # Heartbeats wait on their own event, not on _cond: a put() wakeup
        # must never be taken by a prober while a get() waiter sleeps out
        # its whole timeout beside an idle worker.
        self._closed_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self._readmitted = telemetry.counter(
            "worker_readmitted_total", "dropped workers re-admitted after a heartbeat recovery")

    def get(self, timeout: float):
        """An idle worker, or None on timeout or when the pool is dead.

        While workers are live (even if all checked out), waits up to
        ``timeout``; with none live, at most ``dead_grace`` for a heartbeat
        re-admission, waking as soon as one lands.
        """
        deadline = time.monotonic() + timeout
        empty_since: float | None = None
        with self._cond:
            while True:
                if self._idle:
                    return self._idle.popleft()
                if self._closed:
                    return None
                now = time.monotonic()
                if self._live:
                    empty_since = None
                    limit = deadline
                else:
                    if not self._probing:
                        return None  # nothing live, nothing recovering
                    if empty_since is None:
                        empty_since = now
                    limit = min(deadline, empty_since + self.dead_grace)
                if now >= limit:
                    return None
                self._cond.wait(limit - now)

    def put(self, worker) -> None:
        """Return a checked-out worker; wakes one waiter."""
        with self._cond:
            self._idle.append(worker)
            self._cond.notify()

    def drop(self, worker, cooldown: float = 0.0) -> None:
        """Take a checked-out worker out of the live set, and start a
        heartbeat that re-admits it when its probe succeeds, the first probe
        ``cooldown`` seconds on: a worker dropped for a timeout is likely
        still computing the abandoned work and would answer a ping at once
        (its server is threaded). Wakes every waiter, so that the last live
        worker's death does not leave them waiting out a full timeout."""
        with self._cond:
            self._live.discard(worker)
            if self._probe is not None and not self._closed and worker not in self._probing:
                self._probing.add(worker)
                t = threading.Thread(target=self._heartbeat, args=(worker, cooldown),
                                     daemon=True, name=f"worker-heartbeat-{worker}")
                # Finished heartbeats are pruned, so a flapping worker does
                # not grow the list; the thread starts under the lock, so a
                # racing close() never joins one that has not started.
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
                t.start()
            self._cond.notify_all()

    def readmit(self, worker) -> None:
        with self._cond:
            if self._closed or worker in self._live:
                return
            self._live.add(worker)
            self._idle.append(worker)
            self._probing.discard(worker)
            self._cond.notify_all()
        self._readmitted.inc()
        log.warning("worker %s recovered; re-admitted to the pool", worker)

    def _heartbeat(self, worker, cooldown: float = 0.0) -> None:
        if cooldown > 0.0 and self._closed_event.wait(cooldown):
            return
        while not self._closed_event.wait(self.heartbeat_interval):
            with self._cond:
                if self._closed or worker not in self._probing:
                    return
            try:
                self._probe(worker)
            except Exception:
                continue  # still down; keep probing
            self.readmit(worker)
            return

    @property
    def probing_count(self) -> int:
        with self._cond:
            return len(self._probing)

    def close(self) -> None:
        """Stop the heartbeats and wake every waiter (they get None)."""
        with self._cond:
            self._closed = True
            self._probing.clear()
            self._cond.notify_all()
            # Joined outside the lock: a heartbeat re-checks _probing under
            # _cond, so joining while holding it would deadlock.
            threads, self._threads = self._threads, []
        self._closed_event.set()
        for t in threads:
            t.join(timeout=2.0)
