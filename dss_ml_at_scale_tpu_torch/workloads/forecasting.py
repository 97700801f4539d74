"""Fine-grained demand forecasting: per-SKU SARIMAX fit-tune-score.

Port of ``dss_ml_at_scale_tpu/workloads/forecasting.py`` (the grid
search), over pyarrow Tables with the JAX frames' columns and row order:

- :func:`add_exo_variables`: covid / christmas / new-year exogenous flags
  with the reference's breakpoints.
- :func:`split_train_score_data`: the 40-week holdout.
- :func:`tune_and_forecast_panel`: the device path, the JAX function's
  ``search="grid"`` (TPE waits for the port's ``hpo/``). The discrete
  5 x 3 x 5 = 75-order space the reference's Hyperopt samples is
  enumerated: bounded chunks of groups, each chunk one batch of (group x
  order x start) lanes on the card, each group's argmin by holdout MSE
  taken there.
- :func:`build_tune_and_score_model`: the same for one group, for the
  host path (:func:`..parallel.group_apply.group_apply`).
"""

from __future__ import annotations

import datetime as dt

import numpy as np
import pyarrow as pa
import torch

from ..ops.sarimax import SarimaxConfig
from ..parallel.group_apply import grid_fit_panel, pad_groups

EXO_FIELDS = ["covid", "christmas", "new_year"]
FORECAST_HORIZON = 40  # weeks

_COVID_BREAKPOINT = np.datetime64(dt.datetime(2020, 3, 1), "us")


def add_exo_variables(table: pa.Table) -> pa.Table:
    """Business-knowledge exogenous flags, vectorized over the table:
    covid from the breakpoint on, christmas in ISO weeks 51-52, new_year in
    ISO weeks 1-4. Columns: Date, Product, SKU, Demand, *EXO_FIELDS."""
    from ..datagen.demand import iso_week

    dates = table.column("Date").to_numpy(zero_copy_only=False).astype("datetime64[us]")
    week = iso_week(dates)
    flags = {
        "covid": dates >= _COVID_BREAKPOINT,
        "christmas": (week >= 51) & (week <= 52),
        "new_year": (week >= 1) & (week <= 4),
    }
    out = table.select(["Date", "Product", "SKU", "Demand"])
    for name in EXO_FIELDS:
        out = out.append_column(name, pa.array(flags[name].astype(np.float32), pa.float32()))
    return out


def split_train_score_data(data: pa.Table, forecast_horizon: int = FORECAST_HORIZON):
    """The last ``forecast_horizon`` rows are the scoring window."""
    n = data.num_rows - forecast_horizon
    return data.slice(0, n), data.slice(n)


def tune_and_forecast_panel(
    table: pa.Table,
    keys=("Product", "SKU"),
    forecast_horizon: int = FORECAST_HORIZON,
    cfg: SarimaxConfig | None = None,
    chunk_size: int | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
    stats: dict | None = None,
) -> pa.Table:
    """Tune + fit + full-range-predict every group.

    Returns Product, SKU, Date, Demand, Demand_Fitted (the reference's
    ``tuning_schema``), one row per valid (group, date), groups in sorted
    key order and dates in order. The full order grid of ``cfg`` is fitted
    in ``ceil(G / chunk_size)`` chunks on ``device``, in ``dtype``; the
    winning fit's predictions are the forecast. ``stats``, when given,
    receives ``grid_chunks``, ``groups_fitted`` and ``nm_iterations``.
    """
    cfg = cfg or SarimaxConfig(k_exog=len(EXO_FIELDS))
    keys = list(keys)
    padded = pad_groups(table, keys, ["Demand", *EXO_FIELDS], sort_by="Date")
    y = padded.values["Demand"]
    exog = np.stack([padded.values[f] for f in EXO_FIELDS], axis=-1)
    n_valid = padded.n_valid.astype(np.int32)
    n_train = np.maximum(n_valid - forecast_horizon, 1).astype(np.int32)
    res = grid_fit_panel(cfg, y, exog, n_train, n_valid, chunk_size=chunk_size,
                         device=device, dtype=dtype)

    # The long table: one row per (group, valid timestep), in panel order.
    rows = pa.array(padded.order)
    out = table.select([*keys, "Date", "Demand"]).take(rows)
    fitted = np.concatenate([res.pred[i, : padded.n_valid[i]] for i in range(padded.n_groups)])
    out = out.append_column("Demand_Fitted", pa.array(fitted.astype(np.float32), pa.float32()))
    if stats is not None:
        stats.update(grid_chunks=res.chunks, groups_fitted=padded.n_groups,
                     nm_iterations=int(res.n_iter.sum()))
    return out


def build_tune_and_score_model(
    sku_table: pa.Table,
    forecast_horizon: int = FORECAST_HORIZON,
    cfg: SarimaxConfig | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> pa.Table:
    """Single-group fit-tune-score, for the host path:
    ``group_apply(table, ["Product", "SKU"], build_tune_and_score_model)``.
    A one-group panel through the same code, so host-path and device-path
    results agree."""
    return tune_and_forecast_panel(sku_table, forecast_horizon=forecast_horizon, cfg=cfg,
                                   device=device, dtype=dtype)
