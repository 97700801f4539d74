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

``wait_seconds`` accumulates the consumer's time blocked on the queue: the
step loop's data wait.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch

_SENTINEL = object()


class _FeederFailure:
    """An exception raised in the feeder thread, for re-raise in the consumer."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class Feeder:
    """Feeder thread for one consumer; iterating yields dicts of tensors on
    ``device`` in source order. Close it (or use it as a context manager) so
    the thread never outlives its loop."""

    def __init__(self, source: Iterable[Mapping[str, np.ndarray]], device, *,
                 depth: int = 2, name: str = "feeder"):
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
        self._empty_exc = queue.Empty
        self._full_exc = queue.Full
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
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
            ready.record(self._stream)
        return placed, ready

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                raw = next(self._source, _SENTINEL)
                if raw is _SENTINEL:
                    break
                if not self._put(self._place(raw)):
                    return  # closed while blocked on a full queue
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

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
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
        self.wait_seconds += time.perf_counter() - t0
        if item is _SENTINEL:
            self._done = True
            self._thread.join(timeout=5)
            raise StopIteration
        if isinstance(item, _FeederFailure):
            self._done = True
            self._thread.join(timeout=5)
            raise item.error
        batch, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for v in batch.values():
                v.record_stream(consumer)
        return batch

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
