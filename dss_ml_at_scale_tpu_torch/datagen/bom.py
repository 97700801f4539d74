"""Synthetic bill-of-materials DAG generator.

Port of ``dss_ml_at_scale_tpu/datagen/bom.py`` over pyarrow Tables: a pool
of random 5-char material ids, a 3-level random DAG per SKU (fan-out 2-4,
at most 3 nodes extended per level), edge quantities (1 for edges into
SKUs, else 1-3), then the split into the ``bom`` edge table and the
``sku_mapper`` (final material -> SKU) table by SKU-prefix pattern.

The JAX generator builds a ``networkx.DiGraph`` only to drop duplicate
edges and list the rest; the port builds the same list in plain Python
(:func:`digraph_edge_order`), so it runs where networkx is not installed.
The same seed draws the same ids and quantities, in the same order, so
the tables equal JAX's row for row.
"""

from __future__ import annotations

import re
import string
from typing import NamedTuple, Sequence

import numpy as np
import pyarrow as pa

_SKU_PATTERN = re.compile(r"SRL|LRL|CAM|SRR|LRR_.*")


class BomTables(NamedTuple):
    bom: pa.Table  # material_in -> material_out edges with qty
    sku_mapper: pa.Table  # final_mat_number -> sku
    # The deduplicated (source, target) edges in the graph's order; the
    # JAX package's third field is the networkx.DiGraph itself.
    edges: list[tuple[str, str]]


def _material_ids(rng: np.random.Generator, n: int) -> list[str]:
    chars = string.ascii_uppercase + string.digits
    seen: set[str] = set()
    out: list[str] = []
    while len(out) < n:
        mid = "".join(chars[i] for i in rng.integers(0, len(chars), 5))
        if mid not in seen:
            seen.add(mid)
            out.append(mid)
    return out


def digraph_edge_order(edges: Sequence[tuple[str, str]]) -> list[tuple[str, str]]:
    """The edges a ``networkx.DiGraph`` built from ``edges`` lists: grouped
    by source, sources in the order each node first appeared as EITHER end
    of an edge, each source's targets in first-insertion order, duplicates
    dropped."""
    nodes: dict[str, dict[str, None]] = {}
    for u, v in edges:
        nodes.setdefault(u, {})
        nodes.setdefault(v, {})
        nodes[u][v] = None
    return [(u, v) for u, succ in nodes.items() for v in succ]


def generate_bom(skus: Sequence[str], depth: int = 3, seed: int = 123) -> BomTables:
    """Build the per-SKU 3-level DAG and split bom / sku_mapper tables."""
    rng = np.random.default_rng(seed)
    # Worst case per SKU: 1 head + 3 levels x 3 extended x 4 children.
    pool = iter(_material_ids(rng, len(skus) * (1 + 3 * 4 + 3 * 4) + 16))

    edges: list[tuple[str, str]] = []
    for sku in skus:
        frontier: list[str] = []
        for level in range(1, depth + 1):
            if level == 1:
                head = next(pool)
                edges.append((head, sku))
                frontier = [head]
            else:
                new_frontier: list[str] = []
                for node in frontier[:3]:  # the reference extends at most 3
                    for _ in range(int(rng.integers(2, 5))):  # fan-out 2-4
                        child = next(pool)
                        edges.append((child, node))
                        new_frontier.append(child)
                frontier = new_frontier

    listed = digraph_edge_order(edges)
    source = [u for u, _ in listed]
    target = [v for _, v in listed]
    # qty: 1 into a SKU (targets of length 10), else uniform 1-3.
    draws = rng.integers(1, 4, size=len(listed))
    qty = np.where(np.array([len(t) == 10 for t in target], bool), 1, draws)
    into_sku = np.array([_SKU_PATTERN.match(t) is not None for t in target], bool)
    rows = np.arange(len(listed))
    mapper_rows, bom_rows = rows[into_sku], rows[~into_sku]
    sku_mapper = pa.table({
        "final_mat_number": pa.array([source[i] for i in mapper_rows], pa.string()),
        "sku": pa.array([target[i] for i in mapper_rows], pa.string()),
    })
    bom = pa.table({
        "material_in": pa.array([source[i] for i in bom_rows], pa.string()),
        "material_out": pa.array([target[i] for i in bom_rows], pa.string()),
        "qty": pa.array(qty[bom_rows].astype(np.int64), pa.int64()),
    })
    return BomTables(bom, sku_mapper, listed)


def write_bom_delta(tables: BomTables, bom_path, mapper_path) -> tuple[str, str]:
    """Persist both tables as Delta."""
    from ..data.delta import write_delta

    write_delta(tables.bom, bom_path, mode="overwrite")
    write_delta(tables.sku_mapper, mapper_path, mode="overwrite")
    return str(bom_path), str(mapper_path)
