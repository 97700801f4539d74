"""Single-SKU EDA and model selection (the reference's exploration notebook).

Port of ``dss_ml_at_scale_tpu/workloads/eda.py`` over pyarrow Tables (the
port has no pandas): extract one SKU's series, hold out the last
``horizon`` weeks, then compare

- four Holt-Winters variants, {additive, multiplicative} seasonal x
  {damped, undamped}, Box-Cox on;
- SARIMAX with and without the exogenous regressors;
- a TPE search over SARIMAX ``(p, d, q)`` on the parallel trials executor
  (the reference's ``SparkTrials(parallelism=10)`` with a seeded rstate),

all scored by holdout MSE, on ``device`` in ``dtype`` (float32 by
default, as the JAX workload casts the series). The report holds the
scores table, the tuned order and, on request, the curves behind the
notebook's comparison plot.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..hpo import fmin, hp
from ..hpo.hp import scope
from ..ops.holt_winters import holt_winters_fit, holt_winters_forecast
from ..ops.sarimax import SarimaxConfig, sarimax_fit, sarimax_predict
from .forecasting import EXO_FIELDS, add_exo_variables

HW_VARIANTS = {
    "hw_add": dict(seasonal="add", damped=False),
    "hw_add_damped": dict(seasonal="add", damped=True),
    "hw_mul": dict(seasonal="mul", damped=False),
    "hw_mul_damped": dict(seasonal="mul", damped=True),
}


@dataclasses.dataclass
class EdaReport:
    """Model-comparison results for one SKU."""

    product: str
    sku: str
    scores: pa.Table  # columns: model, mse (and note, where a model could not fit)
    best_order: tuple[int, int, int]
    best_order_mse: float
    # Long-format holdout predictions (Date, model, prediction) when
    # run_eda(return_curves=True): the data behind the notebook's plots.
    curves: pa.Table | None = None
    # The SKU's actual series (Date, Demand), for plotting context.
    series: pa.Table | None = None
    # Wall seconds per family: holt_winters, sarimax, tpe, refit.
    seconds: dict = dataclasses.field(default_factory=dict)

    def to_frame(self) -> pa.Table:
        n = self.scores.num_rows
        return pa.table({"Product": [self.product] * n, "SKU": [self.sku] * n,
                         **{c: self.scores.column(c) for c in self.scores.column_names}})

    def to_string(self) -> str:
        """The scores as an aligned text table (what ``eda`` prints)."""
        cols = self.scores.column_names
        cells = [[f"{v:.4f}" if isinstance(v, float) else "" if v is None else str(v)
                  for v in self.scores.column(c).to_pylist()] for c in cols]
        widths = [max([len(c)] + [len(v) for v in col]) for c, col in zip(cols, cells)]
        lines = [" ".join(c.rjust(w) for c, w in zip(cols, widths))]
        for i in range(self.scores.num_rows):
            lines.append(" ".join(col[i].rjust(w) for col, w in zip(cells, widths)))
        return "\n".join(lines)

    def plot(self, path: str, top_k: int = 3) -> None:
        """Write the reference-style comparison figure: the actual series
        with the ``top_k`` best models' holdout predictions overlaid."""
        if self.curves is None or self.series is None:
            raise ValueError("plot needs run_eda(..., return_curves=True)")
        # Object-oriented figure on an Agg canvas: no pyplot, so a caller's
        # interactive backend is never touched.
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        fig = Figure(figsize=(11, 5))
        FigureCanvasAgg(fig)
        ax = fig.add_subplot(111)
        ax.plot(_dates(self.series), self.series.column("Demand").to_numpy(),
                color="black", lw=1.2, label="actual")
        curve_models = self.curves.column("model").to_pylist()
        mse = dict(zip(self.scores.column("model").to_pylist(),
                       self.scores.column("mse").to_pylist()))
        ranked = [m for m in self.scores.column("model").to_pylist()
                  if m in set(curve_models)][:top_k]
        dates = _dates(self.curves)
        pred = self.curves.column("prediction").to_numpy()
        for name in ranked:
            sel = np.array([m == name for m in curve_models])
            ax.plot(dates[sel], pred[sel], lw=1.0, label=f"{name} (mse {mse[name]:.1f})")
        ax.axvline(dates.min(), color="gray", ls="--", lw=0.8)
        ax.set_title(f"{self.product} / {self.sku} — holdout comparison")
        ax.legend(loc="best", fontsize=8)
        fig.autofmt_xdate()
        fig.tight_layout()
        fig.savefig(path, dpi=120)


def _dates(table: pa.Table) -> np.ndarray:
    return table.column("Date").to_numpy(zero_copy_only=False).astype("datetime64[us]")


def extract_sku_series(table: pa.Table, product: str | None = None,
                       sku: str | None = None) -> pa.Table:
    """One SKU's weekly series, date-sorted.

    Defaults to the first (Product, SKU) pair in row order (of ``product``
    when given): the notebook hand-picks one; any works for model
    selection."""
    if sku is None:
        pool = table if product is None else table.filter(pc.equal(table["Product"], product))
        if pool.num_rows == 0:
            raise ValueError(f"no rows for Product={product!r}")
        product, sku = pool["Product"][0].as_py(), pool["SKU"][0].as_py()
    mask = pc.equal(table["SKU"], sku)
    if product is not None:
        mask = pc.and_(mask, pc.equal(table["Product"], product))
    sel = table.filter(pc.fill_null(mask, False))
    if sel.num_rows == 0:
        raise ValueError(f"no rows for Product={product!r} SKU={sku!r}")
    order = np.argsort(_dates(sel), kind="stable")
    return sel.take(pa.array(order))


def _holdout_mse(pred: np.ndarray, actual: np.ndarray) -> float:
    return float(np.mean((np.asarray(pred) - np.asarray(actual)) ** 2))


def run_eda(
    table: pa.Table,
    product: str | None = None,
    sku: str | None = None,
    *,
    horizon: int = 40,
    seasonal_periods: int = 52,
    sarimax_order: tuple[int, int, int] = (1, 0, 1),
    max_evals: int = 10,
    parallelism: int = 10,
    rstate: int = 123,
    cfg: SarimaxConfig | None = None,
    polish: bool = False,
    return_curves: bool = False,
    tracker=None,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> EdaReport:
    """Fit every candidate model on one SKU and score the holdout window.

    ``tracker`` (a :class:`..tracking.RunStore`) logs every TPE trial as it
    completes. The trials run ``parallelism`` at a time on
    :class:`..parallel.trials.DeviceTrials`, unpinned: each fits on
    ``device``.

    ``polish=True`` refines the ranked SARIMAX fits with the host-side
    float64 Nelder-Mead polish (:func:`..ops.polish.sarimax_polish`)
    before predicting: the two fixed-order fits and the tuned winner's
    final refit (the TPE candidates stay unpolished, for speed).
    """
    from ..parallel.trials import DeviceTrials

    seconds: dict = {}
    series = extract_sku_series(table, product, sku)
    if "covid" not in series.column_names:
        series = add_exo_variables(series)
    if series.num_rows <= horizon:
        raise ValueError(
            f"series has {series.num_rows} points, holdout of {horizon} leaves no train")
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    y = series.column("Demand").to_numpy().astype(np_dtype)
    exog = np.stack([series.column(f).to_numpy() for f in EXO_FIELDS], -1).astype(np_dtype)
    n = len(y)
    n_train = n - horizon
    y_score = y[n_train:]
    yt = torch.as_tensor(y, device=device)
    rows: list[dict] = []
    curves: dict[str, np.ndarray] = {}

    # -- Holt-Winters variants (Box-Cox on, as in the notebook) ----------
    t0 = time.perf_counter()
    for name, kw in HW_VARIANTS.items():
        try:
            fit = holt_winters_fit(yt[:n_train], seasonal_periods, use_boxcox=True, **kw)
            fc = holt_winters_forecast(fit, horizon).cpu().numpy()
            rows.append({"model": name, "mse": _holdout_mse(fc, y_score)})
            curves[name] = fc
        except ValueError as e:  # too short for 2 seasons
            rows.append({"model": name, "mse": float("nan"), "note": str(e)})
    seconds["holt_winters"] = time.perf_counter() - t0

    # -- SARIMAX with / without exog -------------------------------------
    cfg = cfg or SarimaxConfig(k_exog=len(EXO_FIELDS))
    # The no-exog variant gets a k_exog=0 config: a zero exog matrix under
    # k_exog=3 would leave beta a flat likelihood direction to drag along.
    cfg_no_exog = dataclasses.replace(cfg, k_exog=0)

    def _maybe_polish(c, params, ex, o):
        if not polish:
            return params
        from ..ops.polish import sarimax_polish

        refined, _ = sarimax_polish(c, params.cpu().numpy(), y[:n_train], ex[:n_train], o)
        return torch.as_tensor(refined, dtype=params.dtype, device=params.device)

    def fit_predict(c, ex, o, refine):
        ext = torch.as_tensor(ex, device=device)
        fit = sarimax_fit(c, yt, ext, torch.as_tensor(o, device=device), n_train)
        params = _maybe_polish(c, fit.params, ex, o) if refine else fit.params
        with torch.no_grad():
            pred = sarimax_predict(c, params, yt, ext, torch.as_tensor(o, device=device),
                                   n_train)
        return pred.cpu().numpy()[n_train:]

    t0 = time.perf_counter()
    order = np.asarray(sarimax_order, np.int64)
    for name, use_exog in (("sarimax_exog", True), ("sarimax_no_exog", False)):
        c = cfg if use_exog else cfg_no_exog
        ex = exog if use_exog else np.zeros((n, 0), np_dtype)
        pred = fit_predict(c, ex, order, refine=True)
        rows.append({"model": name, "mse": _holdout_mse(pred, y_score)})
        curves[name] = pred
    seconds["sarimax"] = time.perf_counter() - t0

    # -- TPE over (p, d, q) on the parallel executor ---------------------
    space = {
        "p": scope.int(hp.quniform("p", 0, cfg.max_p, 1)),
        "d": scope.int(hp.quniform("d", 0, cfg.max_d, 1)),
        "q": scope.int(hp.quniform("q", 0, cfg.max_q, 1)),
    }

    def objective(point):
        o = np.asarray([point["p"], point["d"], point["q"]], np.int64)
        return {"loss": _holdout_mse(fit_predict(cfg, exog, o, refine=False), y_score),
                "status": "ok"}

    t0 = time.perf_counter()
    trials = DeviceTrials(parallelism=parallelism, pin_devices=False)
    best = fmin(objective, space, max_evals=max_evals, trials=trials,
                rstate=np.random.default_rng(rstate), tracker=tracker)
    seconds["tpe"] = time.perf_counter() - t0
    best_order = (int(best["p"]), int(best["d"]), int(best["q"]))
    best_mse = float(trials.best_trial["result"]["loss"])
    tuned_name = f"sarimax_tuned{best_order}"
    if polish or return_curves:
        # Candidates are scored unpolished (speed); the WINNER is refit
        # (and with polish=True f64-refined), so the tuned row ranks on
        # the same footing and has a prediction curve to report.
        t0 = time.perf_counter()
        pred = fit_predict(cfg, exog, np.asarray(best_order, np.int64), refine=True)
        curves[tuned_name] = pred
        if polish:
            best_mse = _holdout_mse(pred, y_score)
        seconds["refit"] = time.perf_counter() - t0
    rows.append({"model": tuned_name, "mse": best_mse})

    # Sorted by mse, NaN last.
    mses = np.array([r["mse"] for r in rows], float)
    rows = [rows[i] for i in np.argsort(np.where(np.isnan(mses), np.inf, mses), kind="stable")]
    scores = {"model": [r["model"] for r in rows], "mse": [r["mse"] for r in rows]}
    if any("note" in r for r in rows):
        scores["note"] = [r.get("note") for r in rows]
    curves_table = series_table = None
    if return_curves:
        score_dates = series.column("Date").slice(n_train)
        curves_table = pa.concat_tables([
            pa.table({"Date": score_dates, "model": [name] * horizon,
                      "prediction": np.asarray(pred, np.float64)})
            for name, pred in curves.items()])
        series_table = series.select(["Date", "Demand"])
    return EdaReport(
        product=str(series.column("Product")[0].as_py()),
        sku=str(series.column("SKU")[0].as_py()),
        scores=pa.table(scores),
        best_order=best_order,
        best_order_mse=best_mse,
        curves=curves_table,
        series=series_table,
        seconds=seconds,
    )
