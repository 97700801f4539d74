"""Group-apply engine: the ``groupBy().applyInPandas()`` replacement.

Port of ``dss_ml_at_scale_tpu/parallel/group_apply.py`` over pyarrow
Tables (the port has no pandas). Two execution paths:

1. :func:`group_apply`, the **host path**: groups hash-sharded across
   processes and a worker pool within each process, running any Python
   function per group (``Table -> Table``), exactly like
   ``applyInPandas``.
2. :func:`pad_groups` + :func:`grid_fit_panel`, the **device path**:
   groups padded to a rectangle and fit-tune-scored over the full
   ``(p, d, q)`` order grid in bounded chunks, each chunk one batch of
   (group x order x start) lanes on the card with the per-group argmin
   taken there (:func:`..ops.sarimax.sarimax_fit_grid`).
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, NamedTuple, Sequence

import numpy as np
import pyarrow as pa
import torch

from .. import telemetry


def stable_group_hash(key: tuple) -> int:
    """Deterministic cross-process hash of a group key (Spark-shuffle-like)."""
    digest = hashlib.md5(repr(key).encode()).digest()
    return int.from_bytes(digest[:8], "little")


def shard_of(key: tuple, process_count: int) -> int:
    return stable_group_hash(key) % process_count


def function_ref(fn: Callable) -> str:
    """``module:qualname`` of a module-level function, for process workers;
    raises for closures and lambdas, which do not import by name."""
    qualname = getattr(fn, "__qualname__", "")
    module = getattr(fn, "__module__", None)
    if not module or "<" in qualname or module == "__main__":
        raise ValueError(
            f"executor='process' needs a module-level function importable by "
            f"reference; got {fn!r}")
    return f"{module}:{qualname}"


def _run_group_by_ref(args):
    """Process worker: resolve ``fn`` by module:qualname and run it on the
    group (the table ships pickled, the function as a name)."""
    ref, group, on_error = args
    import importlib

    module, _, qualname = ref.partition(":")
    fn = importlib.import_module(module)
    for part in qualname.split("."):
        fn = getattr(fn, part)
    try:
        return fn(group)
    except Exception:
        if on_error == "raise":
            raise
        return None


def _group_codes(table: pa.Table, keys: list[str]):
    """Per-row group codes in sorted key order, the rows kept (null keys
    dropped, as ``DataFrame.groupby`` drops them) and the key columns as
    numpy arrays of the kept rows."""
    cols = [table.column(k) for k in keys]
    keep = np.ones(table.num_rows, bool)
    for c in cols:
        keep &= ~np.asarray(c.is_null())
    values = [np.asarray(c.to_numpy(zero_copy_only=False))[keep] for c in cols]
    if not keep.any():
        return np.zeros(0, np.int64), keep, values
    inverses = [np.unique(v, return_inverse=True)[1].reshape(-1) for v in values]
    _, codes = np.unique(np.stack(inverses, 1), axis=0, return_inverse=True)
    return codes.reshape(-1).astype(np.int64), keep, values


def _group_tables(table: pa.Table, keys: list[str]) -> list[tuple[tuple, pa.Table]]:
    """``(key, rows)`` per group in sorted key order, rows in table order."""
    codes, keep, values = _group_codes(table, keys)
    kept = table.filter(pa.array(keep))
    order = np.argsort(codes, kind="stable")
    bounds = np.flatnonzero(np.diff(codes[order])) + 1
    out = []
    for idx in np.split(order, bounds) if len(order) else []:
        # numpy scalars, as pandas' group keys: their repr is the hash input.
        out.append((tuple(v[idx[0]] for v in values), kept.take(pa.array(idx))))
    return out


def group_apply(
    table: pa.Table,
    keys: str | Sequence[str],
    fn: Callable[[pa.Table], pa.Table],
    *,
    num_workers: int | None = None,
    process_index: int = 0,
    process_count: int = 1,
    on_error: str = "raise",
    executor: str = "thread",
) -> pa.Table:
    """Apply ``fn`` to each key-group of ``table``; concatenate the results.

    Each process runs only the groups its key hash assigns it; callers
    concatenate per-process outputs. ``on_error='skip'`` drops a failing
    group and goes on. ``executor``: ``"thread"`` (default; right for
    functions that release the GIL, such as torch ops), ``"process"`` (one
    subprocess per worker; ``fn`` must be importable by reference) or
    ``"inline"`` (sequential).
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    if executor not in ("thread", "process", "inline"):
        raise ValueError(
            f"executor must be 'thread', 'process', or 'inline', got {executor!r}")
    keys = [keys] if isinstance(keys, str) else list(keys)
    mine = [(k, g) for k, g in _group_tables(table, keys)
            if shard_of(k, process_count) == process_index]

    def run(item):
        _, g = item
        try:
            return fn(g)
        except Exception:
            if on_error == "raise":
                raise
            return None

    if executor == "process":
        import multiprocessing

        ref = function_ref(fn)  # raises early on closures/lambdas
        # spawn, not fork: forking a process whose runtime threads may hold
        # locks can deadlock the child.
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            outs = list(pool.map(_run_group_by_ref, [(ref, g, on_error) for _, g in mine]))
    elif executor == "thread" and (num_workers is None or num_workers > 1):
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            outs = list(pool.map(run, mine))
    else:
        outs = [run(item) for item in mine]
    outs = [o for o in outs if o is not None]
    if not outs:
        return pa.table({})
    return pa.concat_tables(outs)


# -- device path: pad -> stack -> fit ----------------------------------------


class PaddedGroups(NamedTuple):
    """A rectangularized group panel ready for a batched fit."""

    values: dict[str, np.ndarray]  # column -> (G, L) float32, zero-padded
    n_valid: np.ndarray  # (G,) true length per group
    keys: pa.Table  # (G, len(keys)) group keys, row i = group i
    n_groups: int  # true group count (before any chunk padding)
    order: np.ndarray  # row indices of the kept rows, grouped and sorted


def pad_groups(
    table: pa.Table,
    keys: str | Sequence[str],
    columns: Sequence[str],
    sort_by: str | None = None,
    max_len: int | None = None,
) -> PaddedGroups:
    """Stack per-group columns into (G, L) arrays with validity lengths.

    Groups come in sorted key order; rows with a null key are dropped. The
    tail is zero-padded; consumers use ``n_valid``. ``sort_by`` orders rows
    within a group (stably), as the reference sorts by Date. One scatter
    per column over group codes and within-group positions.
    ``order`` indexes the table's rows in the panel's (group, position)
    order, for reassembling a long table from the panel.
    """
    keys = [keys] if isinstance(keys, str) else list(keys)
    with telemetry.span("panel.build"):
        codes, keep, _ = _group_codes(table, keys)
        n = len(codes)
        if n == 0:
            raise ValueError("pad_groups: empty table has no groups")
        rows = np.flatnonzero(keep)
        G = int(codes.max()) + 1
        if sort_by is not None:
            col = table.column(sort_by).to_numpy(zero_copy_only=False)[rows]
            order = np.lexsort((col, codes))
        else:
            order = np.lexsort((np.arange(n), codes))
        codes_s = codes[order]
        lengths = np.bincount(codes_s, minlength=G)
        L = int(max_len or lengths.max())
        if (lengths > L).any():
            raise ValueError(f"group length {lengths.max()} exceeds max_len {L}")
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        pos = np.arange(n) - starts[codes_s]
        values = {}
        for c in columns:
            buf = np.zeros((G, L), np.float32)
            col = table.column(c).to_numpy(zero_copy_only=False)
            buf[codes_s, pos] = np.asarray(col, np.float32)[rows][order]
            values[c] = buf
        key_table = table.select(keys).take(pa.array(rows[order[starts]]))
    return PaddedGroups(values, lengths, key_table, G, rows[order])


def pad_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad axis 0 with copies of row 0 up to a multiple of ``multiple``:
    every chunk has the same shape; the duplicates are discarded work."""
    g = arr.shape[0]
    pad = (-g) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], pad, axis=0)], axis=0)


# -- grid-fused group fit: chunk -> one batch per chunk ----------------------

# Bound on groups per chunk: a chunk holds chunk_size x K x 3 simultaneous
# fits on the card, and every chunk, the ragged tail included, is padded
# to exactly this many groups.
DEFAULT_GRID_CHUNK = 1024


class GridPanelResult(NamedTuple):
    """Host-side (G, ...) results of a chunked grid-fused panel fit."""

    order: np.ndarray  # (G, 3) winning (p, d, q) per group
    params: np.ndarray  # (G, n_params) packed params at the winner
    loss: np.ndarray  # (G,) selection score at the winner
    loglike: np.ndarray  # (G,) exact loglike of the winning fit
    pred: np.ndarray  # (G, L) full-range predictions at the winner
    n_iter: np.ndarray  # (G,) NM iterations summed over the grid
    converged: np.ndarray  # (G,) winning fit convergence
    chunks: int  # chunks it took


def grid_fit_panel(
    cfg,
    y: np.ndarray,
    exog: np.ndarray,
    n_train: np.ndarray,
    n_valid: np.ndarray,
    *,
    orders: np.ndarray | None = None,
    select: str = "mse",
    chunk_size: int | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> GridPanelResult:
    """Fit-tune-score every group over the full order grid in bounded
    chunks: the host loop of the grid-fused engine.

    ``ceil(G / chunk_size)`` chunks, each padded to the one chunk shape
    (duplicating its first group), moved to ``device`` in ``dtype`` and
    fitted by :func:`..ops.sarimax.sarimax_fit_grid` (the JAX package's
    ``make_grid_fit``). Orders default to the full
    :func:`..ops.sarimax.grid_orders` grid of ``cfg``.
    """
    from ..ops.sarimax import grid_orders, sarimax_fit_grid

    G = int(y.shape[0])
    if not (len(exog) == len(n_train) == len(n_valid) == G):
        raise ValueError(
            f"group-axis mismatch: y {G}, exog {len(exog)}, "
            f"n_train {len(n_train)}, n_valid {len(n_valid)}")
    C = int(chunk_size or min(G, DEFAULT_GRID_CHUNK))
    order_grid = np.asarray(grid_orders(cfg) if orders is None else orders, np.int32)
    orders_dev = torch.as_tensor(order_grid, device=device).long()
    fitted_counter = telemetry.counter(
        "skus_fitted_total", "groups fitted by the grid-fused engine")
    outs: list[tuple] = []
    for lo in range(0, G, C):
        hi = min(lo + C, G)
        yc, ec, ntc, nvc = (pad_to_multiple(a[lo:hi], C) for a in (y, exog, n_train, n_valid))
        with telemetry.span("grid.chunk", groups=hi - lo, orders=len(order_grid)):
            res = sarimax_fit_grid(
                cfg, torch.as_tensor(yc, device=device, dtype=dtype),
                torch.as_tensor(ec, device=device, dtype=dtype), orders_dev,
                torch.as_tensor(ntc, device=device).long(),
                torch.as_tensor(nvc, device=device).long(), select=select)
            outs.append(tuple(leaf[: hi - lo].cpu().numpy() for leaf in res))
        fitted_counter.inc(hi - lo)
    return GridPanelResult(*(np.concatenate(parts) for parts in zip(*outs)), chunks=len(outs))
