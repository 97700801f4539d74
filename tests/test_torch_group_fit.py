"""The port's group-fit track vs the JAX package's (``ops/sarimax.py``
``sarimax_fit_grid``, ``parallel/group_apply.py``,
``workloads/forecasting.py``, the ``datagen demand`` and ``forecast``
commands).

- ``sarimax_fit_grid`` with ``select`` mse and loglike (max orders 1/1/1,
  float64): the same winning order per group as JAX's, ``pred`` within
  1e-6.
- ``tune_and_forecast_panel`` on a 6-SKU panel built like
  ``tests/test_group_apply.py``'s ``_demand_frame``: keys, dates and demand
  row for row with JAX's frame, Demand_Fitted within JAX's host-vs-device
  tolerance (rtol 1e-4, atol 1e-3) of JAX's device path in float64.
- Chunk size does not change the fit; null-key rows are dropped; the host
  path (``group_apply`` of ``build_tune_and_score_model``) equals the
  device path; ``pad_groups`` and the group hash equal JAX's.
- The CLI: ``datagen demand`` then ``forecast --device cpu`` at small
  bounds write the API's table; ``--device cuda`` without a card is an
  error; ``--search tpe``, ``--max-evals`` and ``--rstate`` run (the last
  two ignored under grid), logging ``max_evals``.
  ``scripts/golden_fit_sweep_torch.py`` needs a card unless ``--device
  cpu`` is given.
- TPE (``search="tpe"``, max orders 1/1/1, 3 rounds, float64): the
  per-group histories (points and losses) and best orders equal JAX's
  ``_tpe_tune_predict``'s, Demand_Fitted within rtol 1e-4 / atol 1e-3;
  the grid beats TPE on the holdout; ``forecast --search tpe`` through the
  CLI writes the API's table.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from dss_ml_at_scale_tpu.ops import sarimax as jax_sx
from dss_ml_at_scale_tpu.workloads import forecasting as jax_fc
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.data.delta import DeltaTable
from dss_ml_at_scale_tpu_torch.ops import sarimax as sx
from dss_ml_at_scale_tpu_torch.parallel import group_apply as ga
from dss_ml_at_scale_tpu_torch.workloads import forecasting as fc

# The JAX package's parallel/__init__ re-exports the function under the
# module's name.
jax_ga = importlib.import_module("dss_ml_at_scale_tpu.parallel.group_apply")

CFG = dict(max_p=1, max_d=1, max_q=1, k_exog=3, max_iter=20, bfgs_iter=3)
HORIZON = 8
F64 = dict(device="cpu", dtype=torch.float64)


def _demand_frame(rng, n_sku=6, weeks=36):
    """``tests/test_group_apply.py``'s panel: a trend plus noise per SKU."""
    dates = pd.date_range("2019-06-03", periods=weeks, freq="W-MON")
    rows = []
    for s in range(n_sku):
        demand = 100 + 10 * s + 0.4 * np.arange(weeks) + rng.normal(0, 3, weeks)
        rows.append(pd.DataFrame({"Date": dates, "Product": f"P{s % 2}", "SKU": f"SKU{s}",
                                  "Demand": demand.astype(np.float32)}))
    return pd.concat(rows, ignore_index=True)


@pytest.fixture(scope="module")
def frame():
    df = _demand_frame(np.random.default_rng(3))
    # Shuffle the rows: the panel must sort them into groups and dates.
    return df.sample(frac=1.0, random_state=0).reset_index(drop=True)


def _arrow(df: pd.DataFrame) -> pa.Table:
    return pa.Table.from_pandas(df, preserve_index=False)


@pytest.fixture(scope="module")
def jax_panel(frame):
    """JAX's device path on the panel, in float64: its own pad_groups and
    grid_fit_panel, and its frame reassembly."""
    df = jax_fc.add_exo_variables(frame)
    padded = jax_ga.pad_groups(df, ["Product", "SKU"], ["Demand", *jax_fc.EXO_FIELDS],
                               sort_by="Date")
    y = padded.values["Demand"].astype(np.float64)
    exog = np.stack([padded.values[f] for f in jax_fc.EXO_FIELDS], -1).astype(np.float64)
    n_valid = padded.n_valid.astype(np.int32)
    n_train = np.maximum(n_valid - HORIZON, 1).astype(np.int32)
    with jax.enable_x64(True):
        res = jax_ga.grid_fit_panel(jax_sx.SarimaxConfig(**CFG), y, exog, n_train, n_valid,
                                    donate=False)
    out = df.sort_values(["Product", "SKU", "Date"])[["Product", "SKU", "Date", "Demand"]]
    out = out.assign(Demand_Fitted=np.concatenate(
        [res.pred[i, : n_valid[i]] for i in range(padded.n_groups)])).reset_index(drop=True)
    return out, res, (y, exog, n_train, n_valid)


@pytest.fixture(scope="module")
def port_panel(frame):
    return fc.tune_and_forecast_panel(fc.add_exo_variables(_arrow(frame)),
                                      forecast_horizon=HORIZON, cfg=sx.SarimaxConfig(**CFG),
                                      **F64)


@pytest.mark.parametrize("select", ["mse", "loglike"])
def test_sarimax_fit_grid_picks_jax_winner(jax_panel, select):
    _, res, (y, exog, n_train, n_valid) = jax_panel
    cfg = sx.SarimaxConfig(**CFG)
    orders = sx.grid_orders(cfg)
    if select == "mse":  # JAX's panel is its grid fit of every group with select="mse"
        want = [res._replace(**{f: getattr(res, f)[g] for f in res._fields if f != "chunks"})
                for g in range(2)]
    else:
        with jax.enable_x64(True):
            want = [jax_sx.sarimax_fit_grid(jax_sx.SarimaxConfig(**CFG), y[g], exog[g],
                                            jnp.asarray(orders), n_train[g], n_valid[g],
                                            select=select) for g in range(2)]
    got = sx.sarimax_fit_grid(cfg, torch.tensor(y[:2]), torch.tensor(exog[:2]), orders,
                              torch.tensor(n_train[:2]), torch.tensor(n_valid[:2]),
                              select=select)
    for g, w in enumerate(want):
        np.testing.assert_array_equal(got.order[g].numpy(), np.asarray(w.order))
        np.testing.assert_allclose(got.pred[g].numpy(), np.asarray(w.pred), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got.params[g].numpy(), np.asarray(w.params), rtol=1e-6,
                                   atol=1e-6)
        assert float(got.loss[g]) == pytest.approx(float(w.loss), rel=1e-6)
        assert int(got.n_iter[g]) == int(w.n_iter)
    with pytest.raises(ValueError, match="select"):
        sx.sarimax_fit_grid(cfg, torch.tensor(y[:1]), torch.tensor(exog[:1]), orders,
                            torch.tensor(n_train[:1]), select="aic")


def test_panel_matches_jax_row_for_row(jax_panel, port_panel):
    want, res, _ = jax_panel
    got = port_panel
    assert got.column_names == ["Product", "SKU", "Date", "Demand", "Demand_Fitted"]
    assert got.num_rows == len(want)
    for col in ("Product", "SKU"):
        assert got.column(col).to_pylist() == want[col].tolist()
    np.testing.assert_array_equal(got.column("Date").to_numpy().astype("datetime64[us]"),
                                  want["Date"].to_numpy().astype("datetime64[us]"))
    np.testing.assert_array_equal(got.column("Demand").to_numpy(), want["Demand"].to_numpy())
    fitted = got.column("Demand_Fitted").to_numpy()
    assert fitted.dtype == np.float32 and np.isfinite(fitted).all()
    np.testing.assert_allclose(fitted, want["Demand_Fitted"].to_numpy(), rtol=1e-4, atol=1e-3)
    assert res.chunks == 1


def test_panel_chunk_size_does_not_change_the_fit(frame, port_panel):
    stats = {}
    chunked = fc.tune_and_forecast_panel(
        fc.add_exo_variables(_arrow(frame)), forecast_horizon=HORIZON,
        cfg=sx.SarimaxConfig(**CFG), chunk_size=4, stats=stats, **F64)
    assert stats["grid_chunks"] == 2 and stats["groups_fitted"] == 6
    assert chunked.to_pydict() == port_panel.to_pydict()


def test_panel_drops_null_key_rows(frame, port_panel):
    junk = frame.head(5).copy()
    junk["SKU"] = None
    table = _arrow(pd.concat([frame, junk], ignore_index=True))
    got = fc.tune_and_forecast_panel(fc.add_exo_variables(table), forecast_horizon=HORIZON,
                                     cfg=sx.SarimaxConfig(**CFG), **F64)
    assert got.to_pydict() == port_panel.to_pydict()


def test_host_path_equals_device_path(frame, port_panel):
    cfg = sx.SarimaxConfig(**CFG)
    host = ga.group_apply(
        fc.add_exo_variables(_arrow(frame)), ["Product", "SKU"],
        lambda g: fc.build_tune_and_score_model(g, forecast_horizon=HORIZON, cfg=cfg, **F64),
        executor="inline")
    assert host.column_names == port_panel.column_names
    for col in ("Product", "SKU", "Date", "Demand"):
        assert host.column(col).equals(port_panel.column(col))
    np.testing.assert_allclose(host.column("Demand_Fitted").to_numpy(),
                               port_panel.column("Demand_Fitted").to_numpy(), rtol=1e-4,
                               atol=1e-3)


# -- the engine's pieces vs JAX's ---------------------------------------------


def test_pad_groups_matches_jax(frame):
    df = frame.copy()
    df.loc[3, "SKU"] = None
    want = jax_ga.pad_groups(df, ["Product", "SKU"], ["Demand"], sort_by="Date")
    got = ga.pad_groups(_arrow(df), ["Product", "SKU"], ["Demand"], sort_by="Date")
    assert got.n_groups == want.n_groups
    np.testing.assert_array_equal(got.n_valid, want.n_valid)
    np.testing.assert_array_equal(got.values["Demand"], want.values["Demand"])
    assert got.keys.to_pydict() == {k: want.keys[k].tolist() for k in want.keys.columns}
    np.testing.assert_array_equal(ga.pad_to_multiple(np.arange(5), 4),
                                  jax_ga.pad_to_multiple(np.arange(5), 4))


def test_group_hash_and_shards_match_jax(frame):
    for key in [("P0", "SKU0"), ("P1", "SKU17"), ("Camera", "CAM_ABC123")]:
        assert ga.stable_group_hash(key) == jax_ga.stable_group_hash(key)
        assert ga.shard_of(key, 3) == jax_ga.shard_of(key, 3)
    parts = [ga.group_apply(_arrow(frame), ["Product", "SKU"],
                            lambda g: g.slice(0, 1).select(["Product", "SKU"]),
                            process_index=i, process_count=3) for i in range(3)]
    union = pa.concat_tables([p for p in parts if p.num_rows])
    assert union.num_rows == 6 and sorted(union.column("SKU").to_pylist()) == [
        f"SKU{i}" for i in range(6)]
    for i, p in enumerate(parts):
        for key in zip(p.column("Product").to_pylist(), p.column("SKU").to_pylist()):
            assert jax_ga.shard_of(key, 3) == i


def test_group_apply_failure_isolation_and_executors(frame):
    table = _arrow(frame)

    def fn(g):
        if g.column("SKU")[0].as_py() == "SKU2":
            raise RuntimeError("boom")
        return g.slice(0, 1).select(["SKU"])

    with pytest.raises(RuntimeError):
        ga.group_apply(table, "SKU", fn)
    out = ga.group_apply(table, "SKU", fn, on_error="skip", num_workers=2)
    assert sorted(out.column("SKU").to_pylist()) == ["SKU0", "SKU1", "SKU3", "SKU4", "SKU5"]
    with pytest.raises(ValueError, match="module-level"):
        ga.group_apply(table, "SKU", lambda g: g, executor="process")
    with pytest.raises(ValueError, match="executor"):
        ga.group_apply(table, "SKU", fn, executor="dask")


def test_add_exo_variables_matches_jax(frame):
    df = frame.copy()
    df["Date"] = pd.date_range("2019-12-02", periods=len(df), freq="W-MON")
    want = jax_fc.add_exo_variables(df)
    got = fc.add_exo_variables(_arrow(df))
    assert got.column_names == list(want.columns)
    for f in fc.EXO_FIELDS:
        np.testing.assert_array_equal(got.column(f).to_numpy(), want[f].to_numpy(), err_msg=f)
    assert got.column("covid").to_numpy().any() and got.column("christmas").to_numpy().any()
    head, tail = fc.split_train_score_data(got, 40)
    assert head.num_rows == len(df) - 40 and tail.num_rows == 40
    assert tail.column("Date").equals(got.slice(len(df) - 40).column("Date"))


# -- the CLI ------------------------------------------------------------------


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_cli_datagen_demand_then_forecast_equals_the_api(tmp_path, monkeypatch):
    monkeypatch.setenv("DSST_TRACKING_ROOT", str(tmp_path / "runs"))
    rc, text = _run(["datagen", "demand", "--out", str(tmp_path / "d"), "--skus-per-product",
                     "1", "--years", "1", "--seed", "2", "--device", "cpu"])
    assert rc == 0 and "5 SKUs × 53 weeks = 265 rows" in text
    rc, text = _run(["forecast", "--data", str(tmp_path / "d"), "--out", str(tmp_path / "f"),
                     "--max-p", "1", "--max-d", "1", "--max-q", "0", "--max-iter", "4",
                     "--horizon", "10", "--no-mesh", "--device", "cpu",
                     "--tracking-root", str(tmp_path / "runs")])
    assert rc == 0, text
    last = text.strip().splitlines()[-1]
    assert last.startswith("forecast: 5 groups, 265 rows, mse ")
    assert "run -> " in text
    import pyarrow.parquet as pq

    written = pa.concat_tables(pq.read_table(u) for u in DeltaTable(tmp_path / "f").file_uris())
    from dss_ml_at_scale_tpu_torch.datagen.demand import DemandConfig, generate_demand

    demand = generate_demand(DemandConfig(n_skus_per_product=1, ts_length_years=1, seed=2))
    cfg = sx.SarimaxConfig(max_p=1, max_d=1, max_q=0, k_exog=3, max_iter=4)
    api = fc.tune_and_forecast_panel(fc.add_exo_variables(demand), forecast_horizon=10,
                                     cfg=cfg, device="cpu")
    assert written.equals(api)
    assert np.isfinite(written.column("Demand_Fitted").to_numpy()).all()
    runs = list((tmp_path / "runs" / "forecasting").iterdir())
    assert len(runs) == 1
    meta = json.loads((runs[0] / "meta.json").read_text())
    assert meta["status"] == "FINISHED"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
@pytest.mark.parametrize("argv", [["datagen", "demand", "--out", "x"],
                                  ["forecast", "--data", "x", "--out", "y"]],
                         ids=["datagen", "forecast"])
def test_cuda_without_a_card_is_an_error(argv):
    rc, text = _run(argv)
    assert rc == 1
    assert "no CUDA device" in json.loads(text.strip().splitlines()[-1])["error"]


def _sweep(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location(
        "golden_fit_sweep_torch", Path(__file__).parents[1] / "scripts" / "golden_fit_sweep_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["golden_fit_sweep_torch.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main()
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
def test_golden_sweep_script_needs_a_card_by_default(monkeypatch):
    rc, line = _sweep(monkeypatch, [])
    assert rc == 1 and "no CUDA device" in line["error"]


def test_golden_sweep_script_on_the_cpu_fits_every_copy(monkeypatch):
    rc, line = _sweep(monkeypatch, ["--device", "cpu", "--orders", "0,1,0", "--max-iter", "5",
                                    "--perturb", "1"])
    assert rc == 0 and line["device"] == "cpu" and line["copies"] == 2
    (short,) = line["shortfall"].values()
    assert len(short) == 2 and all(np.isfinite(short))


@pytest.mark.parametrize("flags", [["--search", "tpe"], ["--max-evals", "10"],
                                   ["--rstate", "123"]], ids=["tpe", "max-evals", "rstate"])
def test_tpe_flags_are_refused_naming_the_roadmap_item(tmp_path, monkeypatch, flags):
    """Once refused, the TPE flags now run: ``--search tpe`` searches, and
    ``--max-evals``/``--rstate`` alone are accepted and ignored under grid
    (as in JAX); each run logs ``max_evals`` with its params."""
    monkeypatch.setenv("DSST_TRACKING_ROOT", str(tmp_path / "runs"))
    rc, _ = _run(["datagen", "demand", "--out", str(tmp_path / "d"), "--skus-per-product", "1",
                  "--years", "1", "--seed", "2", "--device", "cpu"])
    assert rc == 0
    small = ["--max-p", "1", "--max-d", "0", "--max-q", "0", "--max-iter", "3", "--horizon", "10"]
    rc, text = _run(["forecast", "--data", str(tmp_path / "d"), "--out", str(tmp_path / "o"),
                     "--device", "cpu", *small, *flags, "--max-evals", "2"]
                    if flags[0] != "--max-evals" else
                    ["forecast", "--data", str(tmp_path / "d"), "--out", str(tmp_path / "o"),
                     "--device", "cpu", *small, *flags])
    assert rc == 0, text
    assert text.strip().splitlines()[-1].startswith("forecast: 5 groups, 265 rows, mse ")
    (run,) = (tmp_path / "runs" / "forecasting").iterdir()
    params = json.loads((run / "params.json").read_text())
    assert params["search"] == ("tpe" if flags == ["--search", "tpe"] else "grid")
    assert params["max_evals"] == (10 if flags[0] == "--max-evals" else 2)
    assert json.loads((run / "meta.json").read_text())["status"] == "FINISHED"


# -- TPE search vs JAX's ----------------------------------------------------------

TPE_EVALS = 3


@pytest.fixture(scope="module")
def jax_tpe(jax_panel):
    """JAX's ``_tpe_tune_predict`` on the panel in float64, its per-group
    histories recorded from its ``batched_fmin``."""
    _, _, (y, exog, n_train, n_valid) = jax_panel
    seen = {}

    def recording(*args, **kwargs):
        best, hist = jax_ga.batched_fmin(*args, **kwargs)
        seen.update(best=best, histories=hist)
        return best, hist

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_fc, "batched_fmin", recording)
        preds = jax_fc._tpe_tune_predict(jax_sx.SarimaxConfig(**CFG), y, exog, n_train, n_valid,
                                         len(y), max_evals=TPE_EVALS, rstate=123, mesh=None,
                                         axis_name="data")
    return np.asarray(preds), seen


@pytest.fixture(scope="module")
def port_tpe(frame):
    stats = {}
    out = fc.tune_and_forecast_panel(fc.add_exo_variables(_arrow(frame)),
                                     forecast_horizon=HORIZON, cfg=sx.SarimaxConfig(**CFG),
                                     search="tpe", max_evals=TPE_EVALS, rstate=123, stats=stats,
                                     **F64)
    return out, stats


def test_tpe_panel_matches_jax_histories_and_forecast(jax_panel, jax_tpe, port_tpe):
    """float64 on the CPU: the same (p, d, q) per group per round, the same
    losses to 1e-6, the same best orders; Demand_Fitted within the panel
    bar (rtol 1e-4, atol 1e-3)."""
    want_frame, _, (_, _, _, n_valid) = jax_panel
    preds, seen = jax_tpe
    got, stats = port_tpe
    assert stats["tpe_rounds"] == TPE_EVALS and len(stats["round_seconds"]) == TPE_EVALS
    assert len(stats["histories"]) == len(seen["histories"]) == 6
    for g, (mine, theirs) in enumerate(zip(stats["histories"], seen["histories"])):
        assert [pt for pt, _ in mine] == [pt for pt, _ in theirs], f"group {g}"
        np.testing.assert_allclose([l for _, l in mine], [l for _, l in theirs], rtol=1e-6)
    assert stats["best_orders"] == [(b["p"], b["d"], b["q"]) for b in seen["best"]]
    want = np.concatenate([preds[i, : n_valid[i]] for i in range(6)])
    fitted = got.column("Demand_Fitted").to_numpy()
    assert np.isfinite(fitted).all()
    np.testing.assert_allclose(fitted, want, rtol=1e-4, atol=1e-3)
    for col in ("Product", "SKU", "Demand"):
        assert got.column(col).to_pylist() == want_frame[col].tolist()


def test_grid_beats_tpe_on_holdout():
    """Twin of ``tests/test_group_apply.py``'s: per group, the grid's exact
    argmin scores at least as well on the holdout as TPE's 3 samples."""
    cfg = sx.SarimaxConfig(max_p=1, max_d=1, max_q=1, k_exog=3, max_iter=20, bfgs_iter=0)
    table = fc.add_exo_variables(_arrow(_demand_frame(np.random.default_rng(0), n_sku=3,
                                                      weeks=40)))
    kw = dict(forecast_horizon=8, cfg=cfg, **F64)
    grid = fc.tune_and_forecast_panel(table, **kw)
    tpe = fc.tune_and_forecast_panel(table, max_evals=3, search="tpe", **kw)
    assert grid.num_rows == tpe.num_rows == table.num_rows
    sku = np.array(grid.column("SKU").to_pylist())
    for s in np.unique(sku):
        idx = np.flatnonzero(sku == s)[-8:]
        mse = [float(np.mean((t.column("Demand").to_numpy()[idx].astype(np.float64)
                              - t.column("Demand_Fitted").to_numpy()[idx]) ** 2))
               for t in (grid, tpe)]
        assert mse[0] <= mse[1] + 1e-2, (s, mse)
    with pytest.raises(ValueError, match="search"):
        fc.tune_and_forecast_panel(table, search="bogus", **kw)


def test_tpe_forecast_through_the_cli_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("DSST_TRACKING_ROOT", str(tmp_path / "runs"))
    rc, _ = _run(["datagen", "demand", "--out", str(tmp_path / "d"), "--skus-per-product", "1",
                  "--years", "1", "--seed", "2", "--device", "cpu"])
    assert rc == 0
    rc, text = _run(["forecast", "--data", str(tmp_path / "d"), "--out", str(tmp_path / "f"),
                     "--search", "tpe", "--max-evals", "2", "--rstate", "7", "--max-p", "1",
                     "--max-d", "1", "--max-q", "0", "--max-iter", "4", "--horizon", "10",
                     "--device", "cpu"])
    assert rc == 0, text
    import pyarrow.parquet as pq

    from dss_ml_at_scale_tpu_torch.datagen.demand import DemandConfig, generate_demand

    written = pa.concat_tables(pq.read_table(u) for u in DeltaTable(tmp_path / "f").file_uris())
    demand = generate_demand(DemandConfig(n_skus_per_product=1, ts_length_years=1, seed=2))
    cfg = sx.SarimaxConfig(max_p=1, max_d=1, max_q=0, k_exog=3, max_iter=4)
    api = fc.tune_and_forecast_panel(fc.add_exo_variables(demand), forecast_horizon=10,
                                     cfg=cfg, search="tpe", max_evals=2, rstate=7, device="cpu")
    assert written.equals(api) and written.num_rows == 265
    assert np.isfinite(written.column("Demand_Fitted").to_numpy()).all()
