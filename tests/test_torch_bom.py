"""The port's BoM generator (``datagen/bom.py``, ``datagen bom``) against
the JAX package's.

- ``generate_bom`` equals JAX's row for row (bom and sku_mapper, every
  column, and the edge list against the networkx graph's) at 3 seeds x
  depths 2/3 x SKU counts 1/7/50, on the SKUs of a demand table, and on
  the SKUs of the table ``pipelines/demand_forecasting.json`` makes.
- It runs with networkx blocked (``sys.modules["networkx"] = None``):
  the port builds networkx's edge order in plain Python.
- The Delta round trip, and ``datagen bom`` through the CLI.
"""

import contextlib
import importlib
import io
import sys

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from dss_ml_at_scale_tpu.datagen.bom import generate_bom as jax_generate_bom
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.data.delta import DeltaTable
from dss_ml_at_scale_tpu_torch.datagen import bom
from dss_ml_at_scale_tpu_torch.datagen.demand import DemandConfig, generate_demand


@pytest.fixture(scope="module")
def skus():
    table = generate_demand(DemandConfig(n_skus_per_product=10, ts_length_years=1))
    return sorted(set(table.column("SKU").to_pylist()))


def _assert_equal(got, want):
    assert got.bom.column_names == list(want.bom.columns)
    assert got.sku_mapper.column_names == list(want.sku_mapper.columns)
    assert got.bom.to_pydict() == want.bom.to_dict("list")
    assert got.sku_mapper.to_pydict() == want.sku_mapper.to_dict("list")
    assert got.edges == list(want.graph.edges())


@pytest.mark.parametrize("n", [1, 7, 50])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_generate_bom_equals_jax_row_for_row(skus, seed, depth, n):
    assert len(skus) == 50
    _assert_equal(bom.generate_bom(skus[:n], depth=depth, seed=seed),
                  jax_generate_bom(skus[:n], depth=depth, seed=seed))


def test_demand_forecasting_pipelines_bom_equals_jax():
    """``datagen demand`` at its defaults (the spec's first task), then
    ``datagen bom`` at its defaults: the table the pipeline writes."""
    skus = sorted(set(generate_demand(DemandConfig()).column("SKU").to_pylist()))
    got = bom.generate_bom(skus)
    _assert_equal(got, jax_generate_bom(skus))
    assert got.bom.num_rows > 0 and got.sku_mapper.num_rows == len(skus)
    assert set(got.bom.column("qty").to_pylist()) <= {1, 2, 3}


def test_edge_order_is_networkx_adjacency_order():
    nx = pytest.importorskip("networkx")
    edges = [("a", "s1"), ("b", "a"), ("c", "a"), ("a", "s1"), ("s1", "z"), ("b", "c"),
             ("d", "b"), ("c", "a")]
    g = nx.DiGraph()
    g.add_edges_from(edges)
    assert bom.digraph_edge_order(edges) == list(g.edges())


def test_generate_bom_runs_without_networkx(monkeypatch, skus):
    monkeypatch.setitem(sys.modules, "networkx", None)  # any import of it now fails
    with pytest.raises(ImportError):
        importlib.import_module("networkx")
    fresh = importlib.reload(bom)
    got = fresh.generate_bom(skus[:7], seed=3)
    monkeypatch.undo()
    _assert_equal(got, jax_generate_bom(skus[:7], seed=3))


def test_bom_delta_round_trip(tmp_path, skus):
    tables = bom.generate_bom(skus[:7])
    out = bom.write_bom_delta(tables, tmp_path / "bom", tmp_path / "sku_mapper")
    assert out == (str(tmp_path / "bom"), str(tmp_path / "sku_mapper"))
    for name, want in (("bom", tables.bom), ("sku_mapper", tables.sku_mapper)):
        table = DeltaTable(tmp_path / name)
        assert table.num_records() == want.num_rows
        got = pa.concat_tables(pq.read_table(u) for u in table.file_uris())
        assert got.to_pydict() == want.to_pydict()


def test_datagen_bom_command(tmp_path):
    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        return rc, out.getvalue()

    rc, _ = run(["datagen", "demand", "--out", str(tmp_path / "d"), "--skus-per-product", "1",
                 "--years", "1", "--device", "cpu"])
    assert rc == 0
    rc, text = run(["datagen", "bom", "--demand", str(tmp_path / "d"), "--out",
                    str(tmp_path / "b"), "--mapper-out", str(tmp_path / "m"), "--seed", "5"])
    assert rc == 0
    skus = sorted(set(generate_demand(DemandConfig(n_skus_per_product=1, ts_length_years=1))
                      .column("SKU").to_pylist()))
    want = bom.generate_bom(skus, seed=5)
    assert text.strip() == (f"bom: {want.bom.num_rows} edges, 5 sku mappings -> "
                            f"{tmp_path / 'b'}, {tmp_path / 'm'}")
    got = pa.concat_tables(pq.read_table(u) for u in DeltaTable(tmp_path / "b").file_uris())
    assert got.to_pydict() == want.bom.to_pydict()
