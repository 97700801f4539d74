"""The port's Holt-Winters (``ops/holt_winters.py``) against the golden
fixture and the JAX package's functions.

- Against ``tests/fixtures/hw_golden.json`` (read, never regenerated), at
  the tolerances of ``tests/test_hw_golden.py``: the recursion at pinned
  parameters (fitted rtol 2e-4 / atol 2e-2, SSE and level rel 2e-4, trend
  rel 2e-3 / abs 1e-3, season rtol/atol 2e-3), the forecast from pinned
  states (rtol 5e-4 / atol 5e-2), the Box-Cox lambda (abs 0.05), and the
  fit's SSE within 1.05 x the oracle's best per variant.
- Against JAX's functions in float64: the recursion at pinned parameters
  and the forecast from its states within 1e-10 relative, the Box-Cox
  lambda within 1e-6 (the golden-section search compares likelihoods that
  differ in the last bits near the optimum), and each variant's Box-Cox
  fit (the EDA's) with fitted values and forecast within 1e-6 relative.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.ops import holt_winters as jax_hw
from dss_ml_at_scale_tpu_torch.ops import holt_winters as hw

FIXTURE = Path(__file__).parent / "fixtures" / "hw_golden.json"
GOLDEN = json.loads(FIXTURE.read_text())
NAMES = list(GOLDEN["variants"])


def _pinned(var, dtype):
    pin = var["pinned"]
    return tuple(torch.tensor(pin[k], dtype=dtype) for k in ("alpha", "beta", "gamma", "phi"))


@pytest.mark.parametrize("name", NAMES)
def test_recursion_matches_oracle_at_pinned_params(name):
    var, m = GOLDEN["variants"][name], GOLDEN["m"]
    y = torch.tensor(GOLDEN["y"], dtype=torch.float32)
    init = hw._heuristic_init(y, m, var["seasonal"])
    sse, fitted, level, trend, season = hw._smooth(y, _pinned(var, torch.float32), init, m,
                                                   var["seasonal"], var["damped"])
    np.testing.assert_allclose(fitted.numpy(), var["fitted"], rtol=2e-4, atol=2e-2)
    assert float(sse) == pytest.approx(var["sse"], rel=2e-4)
    assert float(level) == pytest.approx(var["level"], rel=2e-4)
    assert float(trend) == pytest.approx(var["trend"], rel=2e-3, abs=1e-3)
    np.testing.assert_allclose(season.numpy(), var["season"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", NAMES)
def test_recursion_matches_jax_in_float64(name):
    var, m = GOLDEN["variants"][name], GOLDEN["m"]
    y = np.asarray(GOLDEN["y"], np.float64)
    pin = var["pinned"]
    with jax.enable_x64(True):
        yj = jnp.asarray(y)
        want = jax_hw._smooth(yj, tuple(jnp.float64(pin[k]) for k in ("alpha", "beta", "gamma",
                                                                       "phi")),
                              jax_hw._heuristic_init(yj, m, var["seasonal"]), m,
                              var["seasonal"], var["damped"])
        want = [np.asarray(w) for w in want]
    yt = torch.tensor(y)
    got = hw._smooth(yt, _pinned(var, torch.float64), hw._heuristic_init(yt, m, var["seasonal"]),
                     m, var["seasonal"], var["damped"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", NAMES)
def test_forecast_matches_oracle_from_pinned_states(name):
    var = GOLDEN["variants"][name]
    pin = var["pinned"]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    result = hw.HoltWintersResult(
        alpha=f32(pin["alpha"]), beta=f32(pin["beta"]), gamma=f32(pin["gamma"]),
        phi=f32(pin["phi"]), boxcox_lambda=f32(1.0), use_boxcox=False,
        seasonal_code=hw._SEASONAL_CODES[var["seasonal"]], level=f32(var["level"]),
        trend=f32(var["trend"]), season=f32(var["season"]), fittedvalues=torch.zeros(1),
        sse=f32(0.0))
    fc = hw.holt_winters_forecast(result, GOLDEN["h_max"])
    np.testing.assert_allclose(fc.numpy(), var["forecast"], rtol=5e-4, atol=5e-2)


def test_boxcox_lambda_matches_scipy_mle_and_jax():
    assert GOLDEN["boxcox_lambda_interior"]
    lam = float(hw.boxcox_mle_lambda(torch.tensor(GOLDEN["y"], dtype=torch.float32)))
    assert lam == pytest.approx(GOLDEN["boxcox_lambda"], abs=0.05)
    with jax.enable_x64(True):
        want = float(jax_hw.boxcox_mle_lambda(jnp.asarray(GOLDEN["y"], jnp.float64)))
    got = float(hw.boxcox_mle_lambda(torch.tensor(GOLDEN["y"], dtype=torch.float64)))
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_fit_quality_vs_oracle_best(name):
    var = GOLDEN["variants"][name]
    res = hw.holt_winters_fit(torch.tensor(GOLDEN["y"], dtype=torch.float32), GOLDEN["m"],
                              seasonal=var["seasonal"], damped=var["damped"], use_boxcox=False,
                              max_iter=600)
    # The oracle's best comes from multi-start bounded L-BFGS-B (f64); the
    # f32 Nelder-Mead must land within 5% SSE of it.
    assert float(res.sse) <= var["best_sse"] * 1.05
    assert torch.isfinite(res.fittedvalues).all()


@pytest.mark.parametrize("name", NAMES)
def test_boxcox_fit_and_forecast_match_jax_in_float64(name):
    """The EDA's fit (Box-Cox on, max_iter 200) of each variant."""
    var, m = GOLDEN["variants"][name], GOLDEN["m"]
    y = np.asarray(GOLDEN["y"], np.float64)
    kw = dict(seasonal=var["seasonal"], damped=var["damped"], use_boxcox=True, max_iter=200)
    with jax.enable_x64(True):
        want = jax_hw.holt_winters_fit(jnp.asarray(y), m, **kw)
        want_fc = np.asarray(jax_hw.holt_winters_forecast(want, 12))
        want_fit = np.asarray(want.fittedvalues)
    got = hw.holt_winters_fit(torch.tensor(y), m, **kw)
    scale = np.abs(y).max()
    np.testing.assert_allclose(got.fittedvalues.numpy(), want_fit, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(hw.holt_winters_forecast(got, 12).numpy(), want_fc, rtol=1e-6,
                               atol=1e-6 * scale)
    assert got.use_boxcox and got.seasonal_code == hw._SEASONAL_CODES[var["seasonal"]]


def test_fit_needs_two_seasons():
    with pytest.raises(ValueError, match="2 full seasons"):
        hw.holt_winters_fit(torch.ones(20), 13)
