"""Named workloads ``sanitize`` runs under instrumentation.

Port of ``dss_ml_at_scale_tpu/analysis/sanitize/workloads.py``, on the
port's subsystems. Each workload is a small, deterministic,
self-contained exercise of one of the port's thread families: the feeder
(:class:`~..data.prefetch.Feeder`, which on a card copies through pinned
memory on its side stream), the serving scheduler, the HPO worker pool,
the crash-only run journal and the trace handoffs. They build their
subsystems *inside* the armed scope (instrumentation covers objects
constructed while armed) and tear everything down before returning, so
the scope-exit checks (unjoined threads, leaked locks) judge real
hygiene, not harness noise.

Workloads are sized for seconds, not realism: the sanitizer's evidence
is lock *orderings* and guarded-attribute *access sites*, which a few
hundred operations expose as well as a soak would. ``device`` is where
the feeder places its batches (``cpu`` or a card); the other workloads
are host work.
"""

from __future__ import annotations

import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

_WORKLOADS: dict[str, tuple[str, Callable[[str], None]]] = {}


def _workload(name: str, description: str):
    def deco(fn):
        # dsst: ignore[lock-discipline] import-time registration: decorators run while the module body executes, single-threaded by the import lock
        _WORKLOADS[name] = (description, fn)
        return fn
    return deco


def workload_names() -> list[str]:
    return sorted(_WORKLOADS)


def workload_catalog() -> list[tuple[str, str]]:
    return [(n, _WORKLOADS[n][0]) for n in sorted(_WORKLOADS)]


def run_workloads(names: list[str], device: str = "cpu") -> list[str]:
    """Run the named workloads (must be called inside an armed scope);
    returns the names run. Unknown names raise KeyError — the CLI maps
    that to a usage error."""
    for name in names:
        if name not in _WORKLOADS:
            raise KeyError(name)
    for name in names:
        _WORKLOADS[name][1](device)
    return list(names)


# -- the workloads ------------------------------------------------------------


@_workload("feeder", "feeder pipeline: source pull, staging (pinned memory "
           "and the side stream on a card), bounded queue handoff, "
           "consumer step spans")
def _feeder(device: str) -> None:
    import numpy as np

    from ... import telemetry
    from ...data.prefetch import Feeder

    def source():
        for i in range(24):
            yield {
                "image": np.full((4, 8, 8, 3), i % 7, dtype=np.uint8),
                "label": np.arange(4, dtype=np.int32),
            }

    feeder = Feeder(source(), device, depth=2, name="sanitize")
    try:
        for batch, _prov in feeder:
            with feeder.last_handoff.activate(), telemetry.span(
                "train_step"
            ):
                _ = batch["image"].sum()
    finally:
        feeder.close()


class _StubPredictor:
    """predict()-only predictor: payloads pass straight through to one
    coalesced scoring call (the scheduler's duck-typed fallback)."""

    micro_batch = 4

    def predict(self, payloads: list) -> list:
        time.sleep(0.002)  # a visible scoring window for coalescing
        return [{"score": float(len(p))} for p in payloads]


@_workload("serving", "serving scheduler: admission gate, decode pool, "
           "cross-request batcher, request settlement from 4 client "
           "threads")
def _serving(device: str) -> None:
    from ...serving.lifecycle import Lifecycle
    from ...serving.scheduler import SchedulerConfig, ServingScheduler

    lifecycle = Lifecycle()
    sched = ServingScheduler(
        _StubPredictor(),
        SchedulerConfig(
            queue_depth=32, batch_window_ms=2.0, deadline_ms=2000.0,
            decode_workers=2,
        ),
        lifecycle=lifecycle,
    ).start()
    lifecycle.mark_ready()
    errors: list[BaseException] = []

    def client(k: int) -> None:
        for i in range(6):
            try:
                sched.submit([b"x" * (1 + (k + i) % 3)])
            except BaseException as e:  # collected, re-raised on the driver
                errors.append(e)

    threads = [
        threading.Thread(target=client, args=(k,), name=f"san-client-{k}")
        for k in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    lifecycle.start_drain()
    sched.drain(timeout_s=5.0)
    if errors:
        raise errors[0]


@_workload("workers", "HPO worker pool: checkout/return under the "
           "condition, drop -> heartbeat probe -> readmit churn")
def _workers(device: str) -> None:
    from ...resilience.workers import WorkerPool

    pool = WorkerPool(
        ["w0", "w1", "w2"], probe=lambda w: None,
        heartbeat_interval=0.02, dead_grace=0.5,
    )
    try:
        def churn(k: int) -> None:
            for i in range(10):
                w = pool.get(timeout=5.0)
                if w is None:
                    return
                if (k + i) % 5 == 0:
                    pool.drop(w)
                    # The heartbeat probe always succeeds, so the
                    # worker re-enters the idle set shortly.
                    deadline = time.monotonic() + 5.0
                    while (
                        pool.probing_count and time.monotonic() < deadline
                    ):
                        time.sleep(0.005)
                else:
                    pool.put(w)

        threads = [
            threading.Thread(target=churn, args=(k,), name=f"san-trial-{k}")
            for k in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        pool.close()


@_workload("journal", "crash-only run journal: concurrent metric "
           "logging, journal events, read-back, idempotent finish")
def _journal(device: str) -> None:
    from ...tracking.store import RunStore

    with tempfile.TemporaryDirectory(prefix="dsst_sanitize_") as tmp:
        store = RunStore(Path(tmp), "sanitize", run_name="sanitize")
        try:
            def logger(k: int) -> None:
                for i in range(20):
                    store.log_metrics({f"m{k}": float(i)}, step=i)
                store.journal_event("trial", tid=k, loss=0.0)

            threads = [
                threading.Thread(
                    target=logger, args=(k,), name=f"san-journal-{k}"
                )
                for k in range(3)
            ]
            for t in threads:
                t.start()
            # Concurrent read-back while writers are live: the metrics()
            # flush path shares _journal_lock with finish().
            for _ in range(5):
                store.metrics()
                time.sleep(0.005)
            for t in threads:
                t.join(timeout=30)
        finally:
            store.finish()


@_workload("trace", "trace handoffs: spans minted on a driver thread, "
           "adopted across worker threads, span-log tee + flight "
           "recorder write-through")
def _trace(device: str) -> None:
    from ... import telemetry
    from ...telemetry import flightrec, spans, tracecontext

    with tempfile.TemporaryDirectory(prefix="dsst_sanitize_") as tmp:
        tail = Path(tmp) / "flightrec.jsonl"
        flightrec.enable(tail)
        log = spans.SpanLog(path=Path(tmp) / "spans.jsonl")
        try:
            def worker(handoff: tracecontext.Handoff, k: int) -> None:
                with handoff.activate(), telemetry.span("trial", tid=k):
                    with log.span("trial", tid=k):
                        time.sleep(0.001)

            threads = []
            for k in range(4):
                handoff = tracecontext.Handoff.root(kind="trial")
                threads.append(threading.Thread(
                    target=worker, args=(handoff, k),
                    name=f"san-trace-{k}",
                ))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            flightrec.get_recorder().tail(16)
        finally:
            log.close()
            flightrec.disable(tail)
