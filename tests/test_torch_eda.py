"""The port's single-SKU EDA (``workloads/eda.py``, the ``eda`` command)
against the JAX package's.

- ``extract_sku_series``: twins of ``tests/test_eda.py`` (first SKU by
  default, date order, missing SKU or product raise, product without SKU).
- ``run_eda`` at ``parallelism=1`` against JAX's on the same SKU of the
  same demand table, at a config that runs in tier-1 time (max orders
  1/1/1, max_iter 20, seasonal_periods 13, horizon 13, max_evals 2), both
  float32 as JAX's workload casts: the same model names in the same row
  order and the same tuned order. Per-row mse: Holt-Winters rows within
  rtol 1e-3 (measured 4e-6 to 5e-5), SARIMAX rows within rtol 1e-2
  (measured 0 to 3.1e-3): float32 Nelder-Mead over different kernels
  (XLA's fused while loops, torch's batched lanes) takes different steps
  near the optimum, and the k_exog=0 fit's flat ridge moves its holdout
  mse most.
- ``polish=True`` and ``return_curves=True``: finite rows, curves over
  the holdout, ``plot`` writes a PNG.
- The ``eda`` command with ``--device cpu --plot``.
"""

import contextlib
import io
import json

import numpy as np
import pyarrow as pa
import pytest
import torch

from dss_ml_at_scale_tpu.datagen.demand import DemandConfig as JaxDemandConfig
from dss_ml_at_scale_tpu.datagen.demand import generate_demand as jax_generate_demand
from dss_ml_at_scale_tpu.ops.sarimax import SarimaxConfig as JaxConfig
from dss_ml_at_scale_tpu.workloads import eda as jax_eda
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.ops.sarimax import SarimaxConfig
from dss_ml_at_scale_tpu_torch.workloads import eda

SMALL = dict(max_p=1, max_d=1, max_q=1, k_exog=3, max_iter=20)
KW = dict(horizon=13, seasonal_periods=13, max_evals=2, parallelism=1)
HW_RTOL, SARIMAX_RTOL = 1e-3, 1e-2


@pytest.fixture(scope="module")
def demand_df():
    return jax_generate_demand(JaxDemandConfig(n_skus_per_product=1, ts_length_years=1,
                                               seed=2))


@pytest.fixture(scope="module")
def demand(demand_df):
    return pa.Table.from_pandas(demand_df, preserve_index=False)


def test_extract_sku_series_defaults_to_first(demand, demand_df):
    s = eda.extract_sku_series(demand)
    want = jax_eda.extract_sku_series(demand_df)
    assert len(set(s.column("SKU").to_pylist())) == 1
    assert s.column("SKU").to_pylist() == want["SKU"].tolist()
    dates = s.column("Date").to_numpy().astype("datetime64[us]")
    assert (np.diff(dates) > np.timedelta64(0)).all()
    np.testing.assert_array_equal(s.column("Demand").to_numpy(), want["Demand"].to_numpy())
    with pytest.raises(ValueError, match="no rows"):
        eda.extract_sku_series(demand, sku="NOPE")


def test_extract_sku_respects_product_without_sku():
    dates = np.array(["2021-01-04", "2021-01-11"] * 2, dtype="datetime64[us]")
    table = pa.table({"Product": ["A", "A", "B", "B"], "SKU": ["a1", "a1", "b1", "b1"],
                      "Date": pa.array(dates), "Demand": [1.0, 2.0, 3.0, 4.0]})
    s = eda.extract_sku_series(table, product="B")
    assert set(s.column("SKU").to_pylist()) == {"b1"}
    with pytest.raises(ValueError, match="Product='C'"):
        eda.extract_sku_series(table, product="C")


def test_run_eda_short_series_raises(demand):
    small = eda.extract_sku_series(demand).slice(0, 30)
    with pytest.raises(ValueError, match="holdout"):
        eda.run_eda(small, horizon=40, cfg=SarimaxConfig(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def jax_report(demand_df):
    return jax_eda.run_eda(demand_df, cfg=JaxConfig(**SMALL), **KW)


@pytest.fixture(scope="module")
def port_report(demand):
    return eda.run_eda(demand, cfg=SarimaxConfig(**SMALL), device="cpu", **KW)


def test_run_eda_matches_jax(jax_report, port_report):
    want, got = jax_report, port_report
    assert (got.product, got.sku) == (want.product, want.sku)
    models = got.scores.column("model").to_pylist()
    assert models == want.scores["model"].tolist()
    assert got.best_order == want.best_order
    assert got.scores.column_names == ["model", "mse"]
    for name, mse, ref in zip(models, got.scores.column("mse").to_pylist(),
                              want.scores["mse"].tolist()):
        rtol = HW_RTOL if name.startswith("hw_") else SARIMAX_RTOL
        assert mse == pytest.approx(ref, rel=rtol), name
        assert np.isfinite(mse) and mse > 0
    assert got.best_order_mse == pytest.approx(want.best_order_mse, rel=SARIMAX_RTOL)
    frame = got.to_frame()
    assert frame.column_names[:2] == ["Product", "SKU"] and frame.num_rows == 7
    assert set(got.seconds) == {"holt_winters", "sarimax", "tpe"}


def test_run_eda_polish_and_curves(demand, tmp_path):
    report = eda.run_eda(demand, cfg=SarimaxConfig(**SMALL), device="cpu", polish=True,
                         return_curves=True, **{**KW, "parallelism": 2})
    by_model = dict(zip(report.scores.column("model").to_pylist(),
                        report.scores.column("mse").to_pylist()))
    assert len(by_model) == 7 and all(np.isfinite(v) and v > 0 for v in by_model.values())
    models = report.curves.column("model").to_pylist()
    assert {"sarimax_exog", "sarimax_no_exog"} <= set(models)
    assert any(m.startswith("sarimax_tuned") for m in models)
    assert all(models.count(m) == KW["horizon"] for m in set(models))
    assert np.isfinite(report.curves.column("prediction").to_numpy()).all()
    assert report.series.column_names == ["Date", "Demand"]
    out = tmp_path / "eda.png"
    report.plot(str(out))
    assert out.exists() and out.stat().st_size > 5_000
    bare = eda.EdaReport(report.product, report.sku, report.scores, report.best_order,
                         report.best_order_mse)
    with pytest.raises(ValueError, match="return_curves"):
        bare.plot(str(out))


def test_eda_command_on_the_cpu_writes_the_figure(tmp_path, monkeypatch, demand):
    from dss_ml_at_scale_tpu_torch.data.delta import write_delta

    monkeypatch.setenv("DSST_TRACKING_ROOT", str(tmp_path / "runs"))
    write_delta(demand, tmp_path / "d", mode="overwrite")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["eda", "--data", str(tmp_path / "d"), "--horizon", "13",
                       "--seasonal-periods", "13", "--max-evals", "2", "--parallelism", "2",
                       "--max-iter", "10", "--device", "cpu", "--plot",
                       str(tmp_path / "eda.png")])
    text = out.getvalue()
    assert rc == 0, text
    lines = text.strip().splitlines()
    assert lines[0].startswith("EDA for Product=") and "(holdout 13 weeks)" in lines[0]
    assert lines[1].split() == ["model", "mse"] and len([ln for ln in lines if ln.strip()
                                                          .startswith(("hw_", "sarimax"))]) == 7
    assert any(ln.startswith("best SARIMAX order: (") for ln in lines)
    assert f"comparison figure -> {tmp_path / 'eda.png'}" in lines
    assert (tmp_path / "eda.png").stat().st_size > 5_000
    seconds = json.loads(lines[-1])
    assert seconds["eda_seconds"] > 0 and "tpe" in seconds
    (run,) = (tmp_path / "runs" / "eda").iterdir()
    assert json.loads((run / "meta.json").read_text())["status"] == "FINISHED"
    journal = [json.loads(x) for x in (run / "journal.jsonl").read_text().splitlines()]
    assert sum(e.get("event") == "trial" for e in journal) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
def test_eda_command_needs_a_card_by_default(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["eda", "--data", str(tmp_path), "--no-tracking"])
    assert rc == 1 and "no CUDA device" in json.loads(out.getvalue().strip())["error"]
