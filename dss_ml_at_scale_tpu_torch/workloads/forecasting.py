"""Fine-grained demand forecasting: per-SKU SARIMAX fit-tune-score.

Port of ``dss_ml_at_scale_tpu/workloads/forecasting.py``, over pyarrow
Tables with the JAX frames' columns and row order:

- :func:`add_exo_variables`: covid / christmas / new-year exogenous flags
  with the reference's breakpoints.
- :func:`split_train_score_data`: the 40-week holdout.
- :func:`tune_and_forecast_panel`: the device path. ``search="grid"``
  (default): the discrete 5 x 3 x 5 = 75-order space the reference's
  Hyperopt samples is enumerated: bounded chunks of groups, each chunk one
  batch of (group x order x start) lanes on the card, each group's argmin
  by holdout MSE taken there. ``search="tpe"``: the reference's per-SKU
  TPE, every group's own search (:func:`..parallel.group_apply.
  batched_fmin`), each round's proposals scored in one batched fit of all
  groups, then one batched refit of the winners.
- :func:`build_tune_and_score_model`: the same for one group, for the
  host path (:func:`..parallel.group_apply.group_apply`).
"""

from __future__ import annotations

import datetime as dt

import time

import numpy as np
import pyarrow as pa
import torch

from .. import telemetry
from ..hpo import hp
from ..hpo.hp import scope
from ..ops.sarimax import SarimaxConfig, sarimax_fit, sarimax_predict
from ..parallel.group_apply import batched_fmin, grid_fit_panel, pad_groups

EXO_FIELDS = ["covid", "christmas", "new_year"]
FORECAST_HORIZON = 40  # weeks

# p in [0,4], d in [0,2], q in [0,4]: the reference's space, whatever the
# config's bounds (as in the JAX package). The TPE path samples it; the
# grid path enumerates the config's own grid.
SEARCH_SPACE = {
    "p": scope.int(hp.quniform("p", 0, 4, 1)),
    "d": scope.int(hp.quniform("d", 0, 2, 1)),
    "q": scope.int(hp.quniform("q", 0, 4, 1)),
}

# The bench geometry of the grid-fused group-fit chunk (JAX's): the
# ``bench`` ``group_fit`` tier-1 gate fits 32 groups x 40 weeks over the
# full order grid of these reduced bounds in one chunk. bfgs_iter=0: the
# gradient polish is not part of the measured launch.
GROUP_FIT_BENCH_GROUPS = 32
GROUP_FIT_BENCH_WEEKS = 40
GROUP_FIT_BENCH_HORIZON = 20
GROUP_FIT_BENCH_CFG = SarimaxConfig(
    k_exog=len(EXO_FIELDS), max_p=1, max_d=1, max_q=1, max_iter=40,
    bfgs_iter=0,
)

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
    max_evals: int = 10,
    forecast_horizon: int = FORECAST_HORIZON,
    rstate=123,
    cfg: SarimaxConfig | None = None,
    search: str = "grid",
    chunk_size: int | None = None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
    stats: dict | None = None,
) -> pa.Table:
    """Tune + fit + full-range-predict every group.

    Returns Product, SKU, Date, Demand, Demand_Fitted (the reference's
    ``tuning_schema``), one row per valid (group, date), groups in sorted
    key order and dates in order, fitted on ``device`` in ``dtype``.

    ``search="grid"``: the full order grid of ``cfg`` in
    ``ceil(G / chunk_size)`` chunks; the winning fit's predictions are the
    forecast. ``search="tpe"``: ``max_evals`` rounds of per-group TPE
    seeded by ``rstate`` (see :func:`..parallel.group_apply.batched_fmin`),
    each one batched fit scored by holdout MSE, then one batched refit of
    each group's best order. ``stats``, when given, receives
    ``groups_fitted``; the grid adds ``grid_chunks`` and ``nm_iterations``,
    TPE ``tpe_rounds``, ``round_seconds``, ``best_orders`` and
    ``histories``.
    """
    if search not in ("grid", "tpe"):
        raise ValueError(f"search must be 'grid' or 'tpe', got {search!r}")
    cfg = cfg or SarimaxConfig(k_exog=len(EXO_FIELDS))
    keys = list(keys)
    padded = pad_groups(table, keys, ["Demand", *EXO_FIELDS], sort_by="Date")
    G = padded.n_groups
    y = padded.values["Demand"]
    exog = np.stack([padded.values[f] for f in EXO_FIELDS], axis=-1)
    n_valid = padded.n_valid.astype(np.int32)
    n_train = np.maximum(n_valid - forecast_horizon, 1).astype(np.int32)
    info: dict = {"groups_fitted": G}
    if search == "grid":
        res = grid_fit_panel(cfg, y, exog, n_train, n_valid, chunk_size=chunk_size,
                             device=device, dtype=dtype)
        preds = res.pred
        info.update(grid_chunks=res.chunks, nm_iterations=int(res.n_iter.sum()))
    else:
        preds = _tpe_tune_predict(cfg, y, exog, n_train, n_valid, max_evals=max_evals,
                                  rstate=rstate, device=device, dtype=dtype, info=info)

    # The long table: one row per (group, valid timestep), in panel order.
    rows = pa.array(padded.order)
    out = table.select([*keys, "Date", "Demand"]).take(rows)
    fitted = np.concatenate([preds[i, : padded.n_valid[i]] for i in range(G)])
    out = out.append_column("Demand_Fitted", pa.array(fitted.astype(np.float32), pa.float32()))
    if stats is not None:
        stats.update(info)
    return out


def _tpe_tune_predict(cfg, y, exog, n_train, n_valid, *, max_evals, rstate, device, dtype,
                      info):
    """The per-round batched TPE path: one batched fit of every group per
    round (the JAX package's vmapped ``_fit_predict_mse_fn``), scored by
    the holdout MSE on ``[n_train, n_valid)``, then one batched refit and
    predict of each group's best order (``_final_fit_predict_fn``)."""
    G = y.shape[0]
    yt = torch.as_tensor(y, device=device, dtype=dtype)
    et = torch.as_tensor(exog, device=device, dtype=dtype)
    nt = torch.as_tensor(n_train, device=device).long()
    nv = torch.as_tensor(n_valid, device=device).long()
    t = torch.arange(yt.shape[-1], device=yt.device)
    score_mask = (t >= nt[:, None]) & (t < nv[:, None])
    round_s: list[float] = []

    def orders_of(points):
        return torch.tensor([[pt["p"], pt["d"], pt["q"]] for pt in points], device=yt.device)

    def evaluate(points):
        t0 = time.perf_counter()
        with telemetry.span("tpe.round", groups=G):
            o = orders_of(points)
            fit = sarimax_fit(cfg, yt, et, o, nt)
            with torch.no_grad():
                pred = sarimax_predict(cfg, fit.params, yt, et, o, nt)
                err = torch.where(score_mask, yt - pred, 0.0)
                mse = (err * err).sum(-1) / torch.clamp_min(score_mask.sum(-1), 1)
            losses = mse.cpu().numpy()
        round_s.append(time.perf_counter() - t0)
        return losses

    best, histories = batched_fmin(evaluate, SEARCH_SPACE, max_evals, G, rstate=rstate)
    o = orders_of(best)
    with telemetry.span("tpe.refit", groups=G):
        fit = sarimax_fit(cfg, yt, et, o, nt)
        with torch.no_grad():
            preds = sarimax_predict(cfg, fit.params, yt, et, o, nt).cpu().numpy()
    info.update(tpe_rounds=len(round_s), round_seconds=round_s,
                best_orders=[(b["p"], b["d"], b["q"]) for b in best], histories=histories)
    return preds


def build_tune_and_score_model(
    sku_table: pa.Table,
    max_evals: int = 10,
    forecast_horizon: int = FORECAST_HORIZON,
    rstate=123,
    cfg: SarimaxConfig | None = None,
    search: str = "grid",
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> pa.Table:
    """Single-group fit-tune-score, for the host path:
    ``group_apply(table, ["Product", "SKU"], build_tune_and_score_model)``.
    A one-group panel through the same code, so host-path and device-path
    results agree."""
    return tune_and_forecast_panel(sku_table, max_evals=max_evals,
                                   forecast_horizon=forecast_horizon, rstate=rstate, cfg=cfg,
                                   search=search, device=device, dtype=dtype)
