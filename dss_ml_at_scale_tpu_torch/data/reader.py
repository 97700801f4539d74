"""Sharded streaming Parquet reader with a host decode pool.

Port of ``dss_ml_at_scale_tpu/data/reader.py``: the same row-group order
(a seeded per-epoch permutation, round-robin over shards, see
:mod:`.sharding`), ``workers_count`` decode threads feeding a results queue
bounded at ``results_queue_size`` row groups, ``num_epochs=None`` streaming
forever (epoch boundaries are the trainer's, by step count), fixed-size
batches with the partial tail dropped. One worker gives the row-group
order exactly; several workers yield row groups as they finish, as in JAX.

Not ported yet (they wait for the port's resilience and telemetry layers):
the fault-injection sites, the read retry, the poison-row quarantine, row
provenance, and the reader's telemetry gauges.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import pyarrow.parquet as pq

from .sharding import RowGroupUnit, list_row_groups, shard_units
from .transform import TransformSpec

_SENTINEL = object()


class _WorkerError:
    """An exception raised in a decode worker, for re-raise in the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class ParquetShardReader:
    """Background-threaded, sharded, optionally infinite batch reader."""

    def __init__(
        self,
        paths: Sequence[str],
        *,
        batch_size: int,
        cur_shard: int = 0,
        shard_count: int = 1,
        workers_count: int = 2,
        results_queue_size: int = 20,
        num_epochs: int | None = None,
        transform_spec: TransformSpec | None = None,
        shuffle_row_groups: bool = True,
        seed: int = 0,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._units = list_row_groups(list(paths))
        if len(self._units) < shard_count:
            raise ValueError(
                f"{len(self._units)} row groups cannot feed {shard_count} shards; "
                f"write the dataset with smaller row groups or fewer shards"
            )
        self.batch_size = batch_size
        self.cur_shard = cur_shard
        self.shard_count = shard_count
        self.workers_count = max(1, workers_count)
        self.results_queue_size = results_queue_size
        self.num_epochs = num_epochs
        self.transform_spec = transform_spec
        self.shuffle_row_groups = shuffle_row_groups
        self.seed = seed
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._results: queue.Queue | None = None
        self._empty_exc = queue.Empty
        self._local = threading.local()

    def _unit_stream(self) -> Iterator[RowGroupUnit]:
        epochs = itertools.count() if self.num_epochs is None else range(self.num_epochs)
        for epoch in epochs:
            yield from shard_units(
                self._units, self.cur_shard, self.shard_count, epoch=epoch,
                shuffle=self.shuffle_row_groups, seed=self.seed,
            )

    def _load_unit(self, unit: RowGroupUnit) -> dict[str, np.ndarray]:
        """Read and transform one row group. One ParquetFile handle per
        (worker thread, path): footers parse once per worker."""
        cache = self._local.__dict__.setdefault("files", {})
        pf = cache.get(unit.path)
        if pf is None:
            pf = cache[unit.path] = pq.ParquetFile(unit.path)
        table = pf.read_row_group(unit.row_group)
        cols = {name: _column_to_numpy(table.column(i))
                for i, name in enumerate(table.column_names)}
        if self.transform_spec is not None and cols and _num_rows(cols):
            cols = self.transform_spec(cols)
        return cols

    def _worker(self, work: Iterator[RowGroupUnit], lock: threading.Lock,
                results: queue.Queue) -> None:
        def _put(item) -> None:
            while not self._stop.is_set():
                try:
                    results.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        try:
            while not self._stop.is_set():
                with lock:
                    unit = next(work, _SENTINEL)
                if unit is _SENTINEL:
                    break
                _put(self._load_unit(unit))
        except BaseException as e:  # propagate to the consumer, don't die silently
            _put(_WorkerError(e))
        finally:
            _put(_SENTINEL)

    def _row_groups(self) -> Iterator[dict[str, np.ndarray]]:
        self._results = results = queue.Queue(maxsize=self.results_queue_size)
        work = self._unit_stream()
        lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, args=(work, lock, results), daemon=True,
                             name=f"reader-worker-{i}")
            for i in range(self.workers_count)
        ]
        for t in self._threads:
            t.start()
        live = len(self._threads)
        try:
            while live:
                item = results.get()
                if item is _SENTINEL:
                    live -= 1
                    continue
                if isinstance(item, _WorkerError):
                    raise RuntimeError("reader worker failed while decoding") from item.error
                yield item
        finally:
            try:
                self.stop()
            except BaseException:  # generator finalizer at interpreter shutdown
                pass

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if self._threads and any(t.is_alive() for t in self._threads):
            raise RuntimeError(
                "reader is already being iterated; create a second reader "
                "for concurrent streams"
            )
        self._stop.clear()
        buf: list[dict[str, np.ndarray]] = []
        buffered = 0
        for group in self._row_groups():
            if not group or _num_rows(group) == 0:
                continue
            buf.append(group)
            buffered += _num_rows(group)
            while buffered >= self.batch_size:
                batch, buf, buffered = _take(buf, self.batch_size)
                yield batch

    def stop(self) -> None:
        self._stop.set()
        if self._results is not None:
            try:
                while True:
                    self._results.get_nowait()
            except self._empty_exc:
                pass
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _num_rows(group: dict[str, np.ndarray]) -> int:
    return len(next(iter(group.values())))


def _take(buf, n):
    """Split the buffered row groups into one n-row batch and the rest."""
    taken: dict[str, list[np.ndarray]] = {}
    need = n
    rest: list[dict[str, np.ndarray]] = []
    for group in buf:
        if need == 0:
            rest.append(group)
            continue
        rows = _num_rows(group)
        use = min(rows, need)
        for k, v in group.items():
            taken.setdefault(k, []).append(v[:use])
        if use < rows:
            rest.append({k: v[use:] for k, v in group.items()})
        need -= use
    batch = {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in taken.items()}
    return batch, rest, sum(_num_rows(g) for g in rest)


def _column_to_numpy(col) -> np.ndarray:
    """Arrow column -> numpy; binary/string columns become object arrays."""
    import pyarrow as pa

    combined = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if (pa.types.is_binary(combined.type) or pa.types.is_large_binary(combined.type)
            or pa.types.is_string(combined.type) or pa.types.is_large_string(combined.type)):
        return np.array(combined.to_pylist(), dtype=object)
    return combined.to_numpy(zero_copy_only=False)


def make_batch_reader(table, **kwargs) -> ParquetShardReader:
    """A reader over a :class:`~.delta.DeltaTable` or the path of one
    (petastorm's ``make_batch_reader`` over the files the Delta log lists)."""
    from .delta import DeltaTable

    if not isinstance(table, DeltaTable):
        table = DeltaTable(table)
    return ParquetShardReader(table.file_uris(), **kwargs)


@contextlib.contextmanager
def batch_loader(table, **kwargs):
    """Context-managed reader guaranteeing worker teardown."""
    reader = make_batch_reader(table, **kwargs)
    try:
        yield reader
    finally:
        reader.stop()
