"""Shard-assignment math for the streaming reader.

Port copy of ``dss_ml_at_scale_tpu/data/sharding.py``: the same permuted
round-robin, so the port's reader visits row groups in the JAX reader's
order.

Petastorm shards by handing each reader ``cur_shard``/``shard_count`` and
interleaving row groups (reference
``deep_learning/2.distributed-data-loading-petastorm.py:249-250`` passes
``cur_shard=device_id, shard_count=device_count``). The unit of work here
is likewise the Parquet **row group** — the natural Arrow read granule —
assigned round-robin after a seeded per-epoch shuffle so every shard sees
a disjoint, load-balanced, epoch-varying slice.

Kept as pure functions so the assignment is unit-testable without IO
(SURVEY.md §4 calls out "shard assignment math" as a required unit test).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import pyarrow.parquet as pq


@dataclasses.dataclass(frozen=True)
class RowGroupUnit:
    """One schedulable unit: a row group within a parquet file."""

    path: str
    row_group: int
    num_rows: int


def list_row_groups(paths: Sequence[str]) -> list[RowGroupUnit]:
    """Enumerate row groups across files (metadata-only reads)."""
    units: list[RowGroupUnit] = []
    for path in paths:
        meta = pq.ParquetFile(path).metadata
        for rg in range(meta.num_row_groups):
            units.append(RowGroupUnit(path, rg, meta.row_group(rg).num_rows))
    return units


def shard_units(
    units: Sequence[RowGroupUnit],
    cur_shard: int,
    shard_count: int,
    *,
    epoch: int = 0,
    shuffle: bool = True,
    seed: int = 0,
) -> list[RowGroupUnit]:
    """This shard's work list for one epoch.

    Deterministic across processes: every shard computes the same permuted
    order (seeded by ``(seed, epoch)``) and takes an interleaved slice, so
    shards are disjoint and together cover all units. With
    ``shuffle=False`` the order is file order (for validation readers).
    """
    if not 0 <= cur_shard < shard_count:
        raise ValueError(f"cur_shard {cur_shard} out of range for {shard_count} shards")
    order = np.arange(len(units))
    if shuffle:
        order = np.random.default_rng((seed, epoch)).permutation(order)
    return [units[i] for i in order[cur_shard::shard_count]]


def shard_row_count(
    units: Sequence[RowGroupUnit], cur_shard: int, shard_count: int
) -> int:
    """Rows this shard will see per epoch (lower bound across epochs).

    Because assignment is by permuted round-robin, per-epoch counts vary
    slightly; epoch accounting should use the *global* row count via
    ``Topology.steps_per_epoch`` (rows // (batch × world)) exactly like
    the reference (``deep_learning/2...py:387-388``). This helper exists
    for diagnostics.
    """
    per = [u.num_rows for u in units]
    return sum(sorted(per)[cur_shard::shard_count])
