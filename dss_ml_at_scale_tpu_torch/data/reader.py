"""Sharded streaming Parquet reader with a host decode pool.

Port of ``dss_ml_at_scale_tpu/data/reader.py``: the same row-group order
(a seeded per-epoch permutation, round-robin over shards, see
:mod:`.sharding`), ``workers_count`` decode threads feeding a results queue
bounded at ``results_queue_size`` row groups, ``num_epochs=None`` streaming
forever (epoch boundaries are the trainer's, by step count), fixed-size
batches with the partial tail dropped. One worker gives the row-group
order exactly; several workers yield row groups as they finish, as in JAX.

The resilience hooks are the JAX reader's: a row-group load retries
transient failures (site ``reader.next``, :data:`_READ_RETRY`); a
``quarantine`` blocklist drops its rows before decode at every iteration
start; ``emit_provenance`` tags each batch with the rows that built it
(under :data:`~..resilience.rollback.PROVENANCE_KEY`); and
``on_corrupt="quarantine"`` isolates a row whose decode raises (site
``sample.corrupt`` injects one), counts it on ``corrupt_samples_total``,
quarantines it and goes on. The decode pipeline's health is on two
series, as in JAX: ``reader_queue_depth`` (decoded row groups waiting at the
consumer's last read: whether the workers keep ahead) and
``reader_stall_seconds_total`` (the consumer's cumulative wait on the
queue: what it costs when they don't).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import threading
import time
from typing import Iterator, Sequence

import numpy as np
import pyarrow.parquet as pq

from ..resilience.faults import fault_fires, maybe_fail
from ..resilience.retry import RetryPolicy, call_with_retry
from ..resilience.rollback import PROVENANCE_KEY, QuarantineList, compress_rows
from .sharding import RowGroupUnit, list_row_groups, shard_units
from .transform import TransformSpec

log = logging.getLogger(__name__)

_SENTINEL = object()

# Transient-read retry shape: two quick retries cover a filesystem blip
# without meaningfully delaying a genuinely failed epoch.
_READ_RETRY = RetryPolicy(max_retries=2, base_delay=0.05, max_delay=0.5)


class _WorkerError:
    """An exception raised in a decode worker, for re-raise in the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


# dsst: ignore[lock-discipline] no lock-guarded state: worker results cross threads only via the bounded results Queue and stop Event; _threads/_results are consumer-thread-only (a second concurrent iteration raises), per-thread file handles live in a threading.local
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
        quarantine: "QuarantineList | str | None" = None,
        emit_provenance: bool = False,
        on_corrupt: str = "raise",
        drop_last: bool = True,
    ):
        """``quarantine``: a poison-row blocklist (path or QuarantineList)
        consulted at every iteration start. ``emit_provenance``: tag each
        batch with the RowRanges that built it. ``on_corrupt``:
        ``"raise"`` (fail fast) or ``"quarantine"`` (isolate, count,
        quarantine and skip a row whose transform raises). ``drop_last``
        False: a finite stream ends with its short batch (scoring every
        row, as ``predict`` does)."""
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if on_corrupt not in ("raise", "quarantine"):
            raise ValueError(f"on_corrupt must be 'raise' or 'quarantine', got {on_corrupt!r}")
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
        self.emit_provenance = emit_provenance
        self.on_corrupt = on_corrupt
        self.drop_last = drop_last
        self.quarantine = (QuarantineList(quarantine)
                           if isinstance(quarantine, (str, bytes)) or hasattr(quarantine, "__fspath__")
                           else quarantine)
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

    def _load_unit(self, unit: RowGroupUnit) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Read and transform one row group: ``(cols, orig_rows)``, where
        ``orig_rows`` maps each surviving row back to its index in the
        group (the provenance spine). Quarantined rows are dropped before
        decode. One ParquetFile handle per (worker thread, path): footers
        parse once per worker."""
        maybe_fail("reader.next")
        cache = self._local.__dict__.setdefault("files", {})
        pf = cache.get(unit.path)
        if pf is None:
            pf = cache[unit.path] = pq.ParquetFile(unit.path)
        table = pf.read_row_group(unit.row_group)
        cols = {name: _column_to_numpy(table.column(i))
                for i, name in enumerate(table.column_names)}
        orig_rows = np.arange(_num_rows(cols) if cols else 0, dtype=np.int64)
        if self.quarantine is not None:
            mask = self.quarantine.keep_mask(unit.path, unit.row_group, len(orig_rows))
            if mask is not None:
                cols = {k: v[mask] for k, v in cols.items()}
                orig_rows = orig_rows[mask]
        if fault_fires("sample.corrupt"):
            cols = _corrupt_first_sample(cols)
        if self.transform_spec is not None and len(orig_rows):
            try:
                cols = self.transform_spec(cols)
            except Exception:
                if self.on_corrupt != "quarantine":
                    raise
                cols, orig_rows = self._isolate_corrupt_rows(unit, cols, orig_rows)
            else:
                n_out = _num_rows(cols) if cols else 0
                if n_out != len(orig_rows):
                    if self.emit_provenance or self.quarantine is not None:
                        raise ValueError(
                            f"transform changed the row count ({len(orig_rows)} -> {n_out}) "
                            f"in {unit.path}[rg={unit.row_group}]; provenance/quarantine "
                            "require a row-preserving transform")
                    orig_rows = np.arange(n_out, dtype=np.int64)
        return cols, orig_rows

    def _isolate_corrupt_rows(self, unit: RowGroupUnit, cols, orig_rows):
        """Per-row transform of a failed group: good rows survive, each
        corrupt row is counted, quarantined and dropped."""
        from .. import telemetry

        good: list[dict[str, np.ndarray]] = []
        good_rows: list[int] = []
        bad_rows: list[int] = []
        last_error = "?"
        for i in range(len(orig_rows)):
            row = {k: v[i:i + 1] for k, v in cols.items()}
            try:
                good.append(self.transform_spec(row))
                good_rows.append(int(orig_rows[i]))
            except Exception as e:
                bad_rows.append(int(orig_rows[i]))
                last_error = f"{type(e).__name__}: {e}"
        telemetry.counter(
            "corrupt_samples_total",
            "undecodable samples skipped (and quarantined) by the reader",
        ).inc(len(bad_rows))
        log.warning("reader: %d corrupt sample(s) in %s[rg=%d] skipped (last error: %s)",
                    len(bad_rows), unit.path, unit.row_group, last_error)
        if self.quarantine is not None and bad_rows:
            self.quarantine.add(compress_rows(unit.path, unit.row_group, bad_rows),
                                reason=f"undecodable sample ({last_error})")
        if not good:
            return {}, np.empty(0, np.int64)
        return ({k: np.concatenate([g[k] for g in good]) for k in good[0]},
                np.asarray(good_rows, np.int64))

    def _load_unit_with_retry(self, unit: RowGroupUnit):
        """A transient read failure costs a short backoff, not the epoch;
        the cached handle of the path is closed and dropped before each
        retry (a stale handle would replay the failure)."""
        def evict_handle(attempt, exc, delay) -> None:
            stale = self._local.__dict__.setdefault("files", {}).pop(unit.path, None)
            if stale is not None:
                try:
                    stale.close()
                except Exception as close_exc:
                    log.debug("closing evicted reader handle: %r", close_exc)

        return call_with_retry(self._load_unit, unit, policy=_READ_RETRY, site="reader.next",
                               on_retry=evict_handle)

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
                _put((self._load_unit_with_retry(unit), unit))
        except BaseException as e:  # propagate to the consumer, don't die silently
            _put(_WorkerError(e))
        finally:
            _put(_SENTINEL)

    def _telemetry_handles(self):
        """The decode pipeline's gauge and counter, bound once per reader."""
        handles = getattr(self, "_telemetry", None)
        if handles is None:
            from .. import telemetry

            handles = self._telemetry = (
                telemetry.gauge(
                    "reader_queue_depth",
                    "decoded row groups waiting in the results queue at "
                    "last consumer read",
                ),
                telemetry.counter(
                    "reader_stall_seconds_total",
                    "cumulative consumer wait on the decode queue",
                ),
            )
        return handles

    def _row_groups(self):
        """Stream ``((cols, orig_rows), unit)`` in arrival order."""
        self._results = results = queue.Queue(maxsize=self.results_queue_size)
        work = self._unit_stream()
        lock = threading.Lock()
        queue_gauge, stall_total = self._telemetry_handles()
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
                wait_t0 = time.perf_counter()
                item = results.get()
                stall_total.inc(time.perf_counter() - wait_t0)
                queue_gauge.set(results.qsize())
                if item is _SENTINEL:
                    live -= 1
                    continue
                if isinstance(item, _WorkerError):
                    raise RuntimeError("reader worker failed while decoding") from item.error
                yield item
        finally:
            try:
                self.stop()
            # dsst: ignore[bare-except] generator finalizer at interpreter shutdown: nothing raised here is actionable
            except BaseException:  # generator finalizer at interpreter shutdown
                pass

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        if self._threads and any(t.is_alive() for t in self._threads):
            raise RuntimeError(
                "reader is already being iterated; create a second reader "
                "for concurrent streams"
            )
        if self.quarantine is not None:
            # A fresh iteration sees the whole blocklist, rows another
            # process quarantined since this reader was built included.
            self.quarantine.refresh()
        self._stop.clear()
        # (cols, path, row_group, orig_rows): provenance slices with the rows.
        buf: list[tuple] = []
        buffered = 0
        for (group, orig_rows), unit in self._row_groups():
            if not group or len(orig_rows) == 0:
                continue  # a fully quarantined or fully corrupt group
            buf.append((group, unit.path, unit.row_group, orig_rows))
            buffered += _num_rows(group)
            while buffered >= self.batch_size:
                batch, prov, buf, buffered = _take(buf, self.batch_size)
                yield self._finish_batch(batch, prov)
        if buffered and not self.drop_last:
            batch, prov, _, _ = _take(buf, buffered)
            yield self._finish_batch(batch, prov)

    def _finish_batch(self, batch, prov) -> dict[str, np.ndarray]:
        if self.emit_provenance:
            batch[PROVENANCE_KEY] = [r for path, rg, rows in prov
                                     for r in compress_rows(path, rg, rows)]
        return batch

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
    """Split the buffered row groups into one n-row batch and the rest;
    ``prov`` mirrors the batch as ``(path, row_group, rows)`` triples."""
    taken: dict[str, list[np.ndarray]] = {}
    prov: list[tuple[str, int, np.ndarray]] = []
    need = n
    rest: list[tuple] = []
    for group, path, row_group, orig_rows in buf:
        if need == 0:
            rest.append((group, path, row_group, orig_rows))
            continue
        rows = _num_rows(group)
        use = min(rows, need)
        for k, v in group.items():
            taken.setdefault(k, []).append(v[:use])
        prov.append((path, row_group, orig_rows[:use]))
        if use < rows:
            rest.append(({k: v[use:] for k, v in group.items()}, path, row_group,
                         orig_rows[use:]))
        need -= use
    batch = {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in taken.items()}
    return batch, prov, rest, sum(_num_rows(g) for g, *_ in rest)


def _corrupt_first_sample(cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``sample.corrupt`` fault: truncate the first byte-valued cell (a
    torn read of a record); a table with no byte column gets a NaN in its
    first float cell instead."""
    for k, v in cols.items():
        if v.dtype == object and len(v) and isinstance(v[0], (bytes, bytearray)):
            v = v.copy()
            v[0] = bytes(v[0])[: max(1, len(v[0]) // 2)]
            return {**cols, k: v}
    for k, v in cols.items():
        if np.issubdtype(v.dtype, np.floating) and len(v):
            v = v.copy()
            v[0] = np.nan
            return {**cols, k: v}
    log.warning("sample.corrupt fired but no corruptible column found")
    return cols


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
