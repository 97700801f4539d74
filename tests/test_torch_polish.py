"""The port's host-side float64 SARIMAX polish (``ops/polish.py``) against
the JAX package's: the same scipy Nelder-Mead on the same f64 Kalman
likelihood, so the polished params and loglike agree to 1e-10 for d = 0
and d >= 1, from the same packed start, and the exact loglike agrees at
fixed params (including an explosive candidate, which both reject)."""

import numpy as np
import pytest

from dss_ml_at_scale_tpu.ops import polish as jax_polish
from dss_ml_at_scale_tpu.ops.sarimax import SarimaxConfig as JaxConfig
from dss_ml_at_scale_tpu_torch.ops import polish
from dss_ml_at_scale_tpu_torch.ops.sarimax import SarimaxConfig

CFG = dict(max_p=2, max_d=2, max_q=2, k_exog=2)


def _series(seed=0, n=80):
    rng = np.random.default_rng(seed)
    exog = rng.normal(size=(n, 2))
    e = rng.normal(size=n)
    w = np.zeros(n)
    for t in range(1, n):
        w[t] = 0.6 * w[t - 1] + e[t] + 0.3 * e[t - 1]
    y = 50 + exog @ np.array([1.5, -0.7]) + np.cumsum(w) * 0.2 + w
    return y, exog


# Packed [beta (2), phi (max_p 2), theta (max_q 2), log_sigma2]: a rough
# start, as an f32 fit would hand over.
START = np.array([1.2, -0.5, 0.4, 0.0, 0.2, 0.0, 0.1])


@pytest.mark.parametrize("order", [(1, 0, 1), (2, 1, 1), (1, 2, 0)])
def test_polish_matches_jax(order):
    y, exog = _series()
    got, ll = polish.sarimax_polish(SarimaxConfig(**CFG), START, y, exog, order, 70,
                                    max_iter=300)
    want, want_ll = jax_polish.sarimax_polish(JaxConfig(**CFG), START, y, exog, order, 70,
                                              max_iter=300)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    assert ll == pytest.approx(want_ll, rel=1e-10, abs=1e-10)
    start_ll = polish._f64_loglike(
        np.concatenate([START[:2], START[2:2 + order[0]], START[4:4 + order[2]], START[-1:]]),
        y, exog, order, 70)
    assert np.isfinite(ll) and ll >= start_ll  # the polish only improves
    # Inactive coefficients are zeroed in the packed layout.
    assert np.all(got[2 + order[0]:4] == 0) and np.all(got[4 + order[2]:6] == 0)


@pytest.mark.parametrize("params,order", [
    (np.array([1.0, -1.0, 0.5, 0.3, 0.1]), (1, 1, 1)),
    (np.array([1.0, -1.0, 0.2, 0.0]), (1, 0, 0)),
    (np.array([1.0, -1.0, 4.0, 0.0]), (1, 0, 0)),  # explosive AR: rejected by both
])
def test_f64_loglike_matches_jax(params, order):
    y, exog = _series(seed=1)
    got = polish._f64_loglike(params, y, exog, order, len(y))
    want = jax_polish._f64_loglike(params, y, exog, order, len(y))
    assert got == want or got == pytest.approx(want, rel=1e-12)
