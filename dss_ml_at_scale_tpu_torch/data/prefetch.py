"""Background feeder: host-to-device input work off the step loop.

Port of ``dss_ml_at_scale_tpu/data/prefetch.py::Feeder``. A feeder thread
pulls host batches (dicts of numpy arrays) from the reader, turns them into
tensors on the device, and hands them to the step loop through a bounded
queue, so staging and transfer overlap the steps and at most ``depth``
batches are held beyond the one in use.

On a CUDA device each array is copied into pinned host memory and sent with
a non-blocking copy on a side stream of the feeder's own; the batch rides
the queue with an event recorded on that stream. The consumer makes its
current stream wait on the event (the device waits, not the host) and marks
each tensor with ``record_stream`` so the caching allocator does not hand
its memory out again before the consuming stream is done with it. On the
CPU the feeder is a plain bounded queue of ``torch.from_numpy`` tensors.

Iterating yields ``(batch, provenance)`` pairs: the reader's row
provenance (:func:`split_provenance`) is host metadata that never reaches
the device, and it rides the queue with its batch, so the supervised
loop quarantines exactly the rows of the step it discards.

``wait_seconds`` accumulates the consumer's time blocked on the queue: the
step loop's data wait.

Tracing and metrics (the JAX feeder's): the feeder thread opens one step
trace per batch, so the ``reader.next`` pull and the ``feeder.place`` copy
share a trace id, and the batch's :class:`~..telemetry.tracecontext.Handoff`
rides the queue with it; the consumer activates :attr:`Feeder.last_handoff`
around its step, so the step's own spans join the batch's trace. The
feeder meters ``feeder_batches_total``, ``feeder_depth``,
``feeder_occupancy``, ``feeder_stage_seconds``,
``feeder_stall_seconds_total`` and the ``feeder_stall_window_seconds``
window (all labeled by feeder name), and feeds each wait to the SLO
engine's feeder-stall objective.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator, Mapping

import numpy as np
import torch

from .. import telemetry
from ..resilience.rollback import PROVENANCE_KEY
from ..telemetry import tracecontext

_SENTINEL = object()


def split_provenance(batch) -> tuple[Any, Any]:
    """``(batch without its provenance, provenance)``: the provenance is
    None for a batch that carries none."""
    if isinstance(batch, Mapping) and PROVENANCE_KEY in batch:
        return {k: v for k, v in batch.items() if k != PROVENANCE_KEY}, batch[PROVENANCE_KEY]
    return batch, None


class _FeederFailure:
    """An exception raised in the feeder thread, for re-raise in the consumer."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


# dsst: ignore[lock-discipline] no lock-guarded state: every producer/consumer crossing rides the bounded Queue or the stop Event; the consumer-side attributes are single-consumer-thread by the iterator contract
class Feeder:
    """Feeder thread for one consumer; iterating yields ``(batch,
    provenance)``, the batch a dict of tensors on ``device``, in source
    order. Close it (or use it as a context manager) so
    the thread never outlives its loop. ``wait_observer``, when given, is
    called with each consumer wait (the trainer's data-wait histogram)."""

    def __init__(self, source: Iterable[Mapping[str, np.ndarray]], device, *,
                 depth: int = 2, name: str = "feeder", wait_observer=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.device = torch.device(device)
        self.depth = depth
        self.name = name
        self.wait_seconds = 0.0
        self._source = iter(source)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._last_handoff = tracecontext.Handoff(None)
        self._empty_exc = queue.Empty
        self._full_exc = queue.Full
        self._wait_observer = wait_observer
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        # Handles bound once: the per-batch cost on both sides is plain
        # method calls on resolved children.
        self._depth_gauge = telemetry.gauge(
            "feeder_depth", "configured bound of the feeder's on-device batch queue",
            labels=("feeder",)).labels(feeder=name)
        self._depth_gauge.set(depth)
        self._occupancy = telemetry.gauge(
            "feeder_occupancy", "on-device batches queued at last consumer read",
            labels=("feeder",)).labels(feeder=name)
        self._stall_total = telemetry.counter(
            "feeder_stall_seconds_total", "cumulative consumer wait on the feeder queue",
            labels=("feeder",)).labels(feeder=name)
        self._batches_total = telemetry.counter(
            "feeder_batches_total", "batches staged and enqueued by the feeder thread",
            labels=("feeder",)).labels(feeder=name)
        self._stage_hist = telemetry.histogram(
            "feeder_stage_seconds", "feeder-thread time to stage + copy + enqueue one batch",
            labels=("feeder",)).labels(feeder=name)
        self._stall_window = telemetry.window(
            "feeder_stall_window_seconds", "windowed consumer waits on the feeder queue",
            labels=("feeder",)).labels(feeder=name)
        self._slo_note_wait = telemetry.slo.get_engine().note_feeder_wait
        self._thread = threading.Thread(target=self._run, daemon=True, name=f"feeder-{name}")
        self._thread.start()

    # -- producer (feeder thread) -----------------------------------------

    def _place(self, batch: Mapping[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return host, None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            placed = {k: v.pin_memory().to(self.device, non_blocking=True)
                      for k, v in host.items()}
            ready = torch.cuda.Event()
            # dsst: ignore[span-discipline] torch.cuda.Event.record: a CUDA event marker on the side stream, not a span record
            ready.record(self._stream)
        return placed, ready

    # dsst: hotpath — feeder-thread stage cost is what overlaps step dispatch
    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                # One step trace per batch, born here: the feeder is the
                # first thread to touch a step's data, so the trace covers
                # the reader pull, the copy and (through the handoff riding
                # the queue) the consumer's step.
                with tracecontext.trace(kind="step") as tctx:
                    with telemetry.span("reader.next", feeder=self.name):
                        raw = next(self._source, _SENTINEL)
                    if raw is _SENTINEL:
                        break
                    t0 = time.perf_counter()
                    batch, prov = split_provenance(raw)
                    with telemetry.span("feeder.place", feeder=self.name):
                        placed, ready = self._place(batch)
                    self._stage_hist.observe(time.perf_counter() - t0)
                if not self._put((placed, prov, ready, tracecontext.Handoff(tctx))):
                    return  # closed while blocked on a full queue
                self._batches_total.inc()
        except BaseException as e:
            self._put(_FeederFailure(e))
        finally:
            self._put(_SENTINEL)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except self._full_exc:
                continue
        return False

    # -- consumer -----------------------------------------------------------

    @property
    def last_handoff(self) -> tracecontext.Handoff:
        """The step-trace handoff of the batch the last ``next()`` returned:
        the consumer activates it around its step, so the step's spans join
        the batch's trace. Read it before the next ``next()`` (one consumer,
        as for the iterator itself)."""
        return self._last_handoff

    def __iter__(self) -> Iterator[tuple[dict[str, torch.Tensor], Any]]:
        return self

    # dsst: hotpath — the consumer's entire per-batch cost: one queue.get
    def __next__(self) -> tuple[dict[str, torch.Tensor], Any]:
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except self._empty_exc:
                if self._stop.is_set():
                    self._done = True
                    raise StopIteration from None
        wait = time.perf_counter() - t0
        self.wait_seconds += wait
        self._stall_total.inc(wait)
        self._stall_window.observe(wait)
        self._slo_note_wait(wait)
        if self._wait_observer is not None:
            self._wait_observer(wait)
        self._occupancy.set(self._queue.qsize())
        if item is _SENTINEL:
            self._done = True
            self._thread.join(timeout=5)
            raise StopIteration
        if isinstance(item, _FeederFailure):
            self._done = True
            self._thread.join(timeout=5)
            raise item.error
        batch, prov, ready, self._last_handoff = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for v in batch.values():
                v.record_stream(consumer)
        return batch, prov

    def close(self) -> None:
        """Stop the feeder thread and join it. Idempotent."""
        self._done = True
        self._stop.set()
        for _ in range(2):  # drain, join, drain what the thread put last
            try:
                while True:
                    self._queue.get_nowait()
            except self._empty_exc:
                pass
            self._thread.join(timeout=5)

    def __enter__(self) -> "Feeder":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
