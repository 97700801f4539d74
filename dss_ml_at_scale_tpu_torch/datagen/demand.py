"""Synthetic weekly parts-demand generator.

Port of ``dss_ml_at_scale_tpu/datagen/demand.py``: 5 products x n SKUs, a
Monday-aligned weekly spine, per-product ARMA parameters from seeded numpy
draws, one ARMA series per SKU, then the factor algebra (COVID decline
ramp from 20% to 7% after 2020-03-01, Christmas / New-Year weekly factors,
a pre-COVID ``100 * sqrt(t)`` trend), rounded.

The panel is the JAX package's, row for row: the same SKU ids, dates and
per-SKU keys (``jax.random.split(jax.random.key(seed), G)``), the normal
draws bit for bit (:meth:`..data.augment.ThreefryKey.normal`), the filter
in XLA's float32 arithmetic (:func:`..ops.arma.lfilter`) and the factor
algebra in the same float64 numpy operations. The table is a pyarrow
``Table`` with the JAX frame's columns and types (Product and SKU
strings, Date ``timestamp[us]``, Demand float32); the port has no pandas.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import string

import numpy as np
import pyarrow as pa

PRODUCTS = [
    ("Long Range Lidar", "LRL"),
    ("Short Range Lidar", "SRL"),
    ("Camera", "CAM"),
    ("Long Range Radar", "LRR"),
    ("Short Range Radar", "SRR"),
]

_XMAS_FACTORS = {51: 0.85, 52: 0.8, 1: 1.1, 2: 1.15, 3: 1.1, 4: 1.05}


@dataclasses.dataclass(frozen=True)
class DemandConfig:
    """Knobs of the generator (the reference's parameter cell)."""

    n_skus_per_product: int = 10
    ts_length_years: int = 3
    end_date: dt.date = dt.date(2021, 7, 19)
    corona_breakpoint: dt.date = dt.date(2020, 3, 1)
    pct_decrease_from: float = 20.0
    pct_decrease_to: float = 7.0
    trend_factor_before_corona: float = 100.0
    seed: int = 123
    max_arma_order: int = 3  # AR/MA lengths drawn in [1, 3]


def iso_week(dates: np.ndarray) -> np.ndarray:
    """ISO-8601 week numbers of ``datetime64`` dates."""
    days = dates.astype("datetime64[D]").astype(object)
    return np.array([d.isocalendar()[1] for d in days], np.int64)


def weekly_date_spine(cfg: DemandConfig = DemandConfig()) -> dict[str, np.ndarray]:
    """The common Monday-aligned weekly spine and its factor columns:
    ``Date`` (``datetime64[us]``), ``Corona_Breakpoint_Helper``,
    ``Corona_Factor``, ``Week`` and ``Factor_XMas``."""
    end = cfg.end_date - dt.timedelta(days=cfg.end_date.weekday())  # Monday on/before
    start = end - dt.timedelta(weeks=52 * cfg.ts_length_years)
    n = (end - start).days // 7 + 1
    dates = np.datetime64(start, "us") + np.arange(n) * np.timedelta64(7, "D")

    # COVID helper: 0 before the breakpoint, then 0,1,2,... counting up,
    # in closed form from the breakpoint's (possibly out-of-range) week
    # index, so a short spine starting after the breakpoint continues the
    # ramp.
    delta_days = (cfg.corona_breakpoint - start).days
    b = -(-delta_days // 7)  # ceil; index of the first spine Monday >= breakpoint
    helper = np.maximum(0, np.arange(n) - b + 1)
    span = max(helper.max(), 1)
    pct = np.where(
        helper > 0,
        cfg.pct_decrease_from
        - (cfg.pct_decrease_from - cfg.pct_decrease_to) / span * helper,
        0.0,
    )
    week = iso_week(dates)
    return {
        "Date": dates,
        "Corona_Breakpoint_Helper": helper,
        "Corona_Factor": np.where(helper == 0, 1.0, (100.0 - pct) / 100.0),
        "Week": week,
        "Factor_XMas": np.array([_XMAS_FACTORS.get(int(w), 1.0) for w in week]),
    }


def _id_generator(rng: np.random.Generator, size: int = 6) -> str:
    chars = string.ascii_uppercase + string.digits
    return "".join(chars[i] for i in rng.integers(0, len(chars), size))


def product_hierarchy(cfg: DemandConfig = DemandConfig()) -> list[tuple[str, str]]:
    """Product -> SKU pairs: ``{PREFIX}_{6-char id}`` per SKU."""
    rng = np.random.default_rng(cfg.seed)
    rows = []
    for product, prefix in PRODUCTS:
        seen: set[str] = set()
        while len(seen) < cfg.n_skus_per_product:
            seen.add(_id_generator(rng))
        rows += [(product, f"{prefix}_{postfix}") for postfix in sorted(seen)]
    return rows


def _arma_product_params(cfg: DemandConfig, rng: np.random.Generator):
    """Per-product variance/offset/AR/MA draws."""
    n = len(PRODUCTS)
    variance = np.abs(rng.normal(100, 50, n))
    offset = np.maximum(np.abs(rng.normal(10000, 5000, n)), 4000)
    ar_len = rng.integers(1, cfg.max_arma_order + 1, n)
    ma_len = rng.integers(1, cfg.max_arma_order + 1, n)
    ar = [rng.uniform(0.1, 0.9, k) for k in ar_len]
    ma = [rng.uniform(0.1, 0.9, k) for k in ma_len]
    return variance, offset, ar, ma


def generate_demand(cfg: DemandConfig = DemandConfig()) -> pa.Table:
    """The full demand panel: the long ``[Product, SKU, Date, Demand]`` table."""
    from ..data.augment import ThreefryKey
    from ..ops.arma import arma_generate_sample

    spine = weekly_date_spine(cfg)
    hierarchy = product_hierarchy(cfg)
    rng = np.random.default_rng(cfg.seed)
    variance, offset, ar, ma = _arma_product_params(cfg, rng)

    n_weeks = len(spine["Date"])
    m = cfg.max_arma_order
    # Per-product lag polynomials ([1, a1..ak], statsmodels' np.r_[1, params]
    # convention) padded to one length, one row per SKU.
    G = len(hierarchy)
    index = {p: i for i, (p, _) in enumerate(PRODUCTS)}
    prod_idx = np.array([index[p] for p, _ in hierarchy], np.int64)
    ar_poly = np.zeros((G, m + 1), np.float32)
    ma_poly = np.zeros((G, m + 1), np.float32)
    for g, pi in enumerate(prod_idx):
        ar_poly[g, 0] = ma_poly[g, 0] = 1.0
        ar_poly[g, 1 : 1 + len(ar[pi])] = ar[pi]
        ma_poly[g, 1 : 1 + len(ma[pi])] = ma[pi]
    scale = variance[prod_idx].astype(np.float32)
    off = offset[prod_idx].astype(np.float32)

    keys = ThreefryKey.from_seed(cfg.seed).split(G)
    panel = arma_generate_sample(keys, ar_poly, ma_poly, n_weeks, scale=scale, burnin=3000)
    panel = panel + off[:, None]

    # Factor algebra: COVID decline, pre-COVID sqrt trend, Christmas /
    # New-Year factors, rounding.
    helper = spine["Corona_Breakpoint_Helper"]
    rows = np.arange(n_weeks)
    panel = panel * spine["Corona_Factor"][None, :]
    pre = helper == 0
    panel[:, pre] += cfg.trend_factor_before_corona * np.sqrt(rows[pre])[None, :]
    panel = np.round(panel * spine["Factor_XMas"][None, :])

    products = [p for p, _ in hierarchy]
    skus = [s for _, s in hierarchy]
    out = pa.table({
        "Product": pa.array(np.repeat(np.array(products, object), n_weeks), pa.string()),
        "SKU": pa.array(np.repeat(np.array(skus, object), n_weeks), pa.string()),
        "Date": pa.array(np.tile(spine["Date"], G), pa.timestamp("us")),
        "Demand": pa.array(panel.reshape(-1).astype(np.float32), pa.float32()),
    })
    assert out.num_rows == G * n_weeks, "row-count invariant"
    return out


def write_demand_delta(table: pa.Table, path) -> str:
    """Persist the panel as a Delta table."""
    from ..data.delta import write_delta

    write_delta(table, path, mode="overwrite")
    return str(path)
