"""The port's Kalman filter, ARMA filter and demand generator vs the JAX
package's (``ops/kalman.py``, ``ops/arma.py``, ``datagen/demand.py``).

- ``kalman_filter`` / ``kalman_forecast`` on a random stable system with
  masked steps, batched over series (JAX vmapped): all outputs within
  1e-10 relative in float64 and 1e-5 in float32; likewise the companion
  form SARIMAX runs (``kalman_filter_companion``), against JAX's general
  filter and the port's.
- ``lfilter``: the float32 ARMA filter equals JAX's scan bit for bit (XLA
  contracts the step into fused multiply-adds, and so does the port), and
  scipy's ``lfilter`` within float32 rounding, the pure-gain ARMA(0,0)
  case included.
- The normal draws (``ThreefryKey.normal``) equal ``jax.random.normal`` bit
  for bit, and so does the demand table: Product, SKU and Date row for
  row, Demand exactly (the test would allow 0.1% of entries off by one, at
  ``np.round``'s .5 boundaries; none are).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from dss_ml_at_scale_tpu.datagen import demand as jax_demand
from dss_ml_at_scale_tpu.ops import arma as jax_arma
from dss_ml_at_scale_tpu.ops import kalman as jax_kalman
from dss_ml_at_scale_tpu_torch.data.augment import ThreefryKey, xla_erfinv, xla_log1p
from dss_ml_at_scale_tpu_torch.datagen import demand
from dss_ml_at_scale_tpu_torch.ops import arma, kalman

B, N, M = 6, 30, 4


def _system(dtype):
    rng = np.random.default_rng(7)
    T = rng.normal(size=(B, M, M)) * 0.3
    T /= np.maximum(1.0, np.abs(np.linalg.eigvals(T)).max(-1) / 0.9)[:, None, None]
    R = rng.normal(size=(B, M, 2))
    A = rng.normal(size=(B, 2, 2))
    Q = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(2)
    Z = rng.normal(size=(B, M))
    H = rng.uniform(0.1, 1.0, B)
    a0 = rng.normal(size=(B, M))
    C = rng.normal(size=(B, M, M))
    P0 = C @ C.transpose(0, 2, 1) + np.eye(M)
    y = rng.normal(size=(B, N)) * 2
    mask = rng.uniform(size=(B, N)) > 0.25
    mask[:, 0] = True
    return [a.astype(dtype) for a in (y, T, R, Q, Z, H, a0, P0)] + [mask]


@pytest.fixture(scope="module", params=[np.float64, np.float32], ids=["f64", "f32"])
def filtered(request):
    dtype = request.param
    args = _system(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = jax.vmap(jax_kalman.kalman_filter)(*[jnp.asarray(a) for a in args])
        fc = jax.vmap(lambda a, P, T, R, Q, Z, H: jax_kalman.kalman_forecast(
            a, P, 7, T, R, Q, Z, H))(ref.a_last, ref.P_last, *[jnp.asarray(a) for a in args[1:6]])
        ref = [np.asarray(x) for x in ref]
        fc = [np.asarray(x) for x in fc]
    return dtype, args, ref, fc


def _close(got, want, dtype):
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_kalman_filter_matches_jax(filtered):
    dtype, args, ref, _ = filtered
    got = kalman.kalman_filter(*[torch.as_tensor(a) for a in args])
    assert got.loglike.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    for name, g, w in zip(kalman.KalmanFiltered._fields, got, ref):
        assert g.shape == w.shape, name
        _close(g.numpy(), w, dtype)


def test_kalman_filter_is_differentiable():
    args = [torch.as_tensor(a) for a in _system(np.float64)]
    T = args[1].clone().requires_grad_(True)
    ll = kalman.kalman_filter(args[0], T, *args[2:]).loglike.sum()
    (g,) = torch.autograd.grad(ll, T)
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a.numpy()) for a in args]
        want = jax.grad(lambda t: jax.vmap(jax_kalman.kalman_filter)(
            jargs[0], t, *jargs[2:]).loglike.sum())(jargs[1])
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_companion_filter_is_the_general_filter(dtype):
    # The Harvey form SARIMAX runs: T companion on phi, R = [1, theta],
    # Z = e_0, H = 0; held to JAX's general filter on the same system.
    rng = np.random.default_rng(11)
    m = 5
    phi = (rng.uniform(-0.5, 0.5, (B, m)) * (np.arange(m) < 3)).astype(dtype)
    T = np.zeros((B, m, m), dtype)
    T[:, :, 0] = phi
    T[:, np.arange(m - 1), np.arange(1, m)] = 1.0
    R = np.concatenate([np.ones((B, 1)), rng.normal(size=(B, m - 1)) * 0.5], 1)[..., None]
    R = R.astype(dtype)
    Q = rng.uniform(0.5, 2.0, (B, 1, 1)).astype(dtype)
    Z = np.zeros((B, m), dtype)
    Z[:, 0] = 1.0
    H = np.zeros(B, dtype)
    a0 = np.zeros((B, m), dtype)
    C = rng.normal(size=(B, m, m))
    P0 = (C @ C.transpose(0, 2, 1) + np.eye(m)).astype(dtype)
    y = (rng.normal(size=(B, N)) * 2).astype(dtype)
    mask = rng.uniform(size=(B, N)) > 0.2
    with jax.enable_x64(dtype == np.float64):
        want = [np.asarray(w) for w in jax.vmap(jax_kalman.kalman_filter)(
            *[jnp.asarray(a) for a in (y, T, R, Q, Z, H, a0, P0, mask)])]
    t = [torch.tensor(a) for a in (y, T, R, Q, Z, H, a0, P0, mask)]
    general = kalman.kalman_filter(*t)
    RQR = t[2] @ t[3] @ t[2].mT
    got = kalman.kalman_filter_companion(t[0], t[1][..., 0], RQR, t[6], t[7], t[8])
    for name, g, w, gen in zip(kalman.KalmanFiltered._fields, got, want, general):
        _close(g.numpy(), w, dtype)
        _close(g.numpy(), gen.numpy(), dtype)
    # Without the likelihood (the concentrated objective's call) the
    # predictions and the last state are the same.
    bare = kalman.kalman_filter_companion(t[0], t[1][..., 0], RQR, t[6], t[7], t[8],
                                          with_loglike=False)
    assert bare.loglike is None
    for g, w in zip(bare[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_kalman_forecast_matches_jax(filtered):
    dtype, args, ref, fc = filtered
    t = [torch.as_tensor(a) for a in args]
    means, variances = kalman.kalman_forecast(torch.tensor(ref[3]), torch.tensor(ref[4]),
                                              7, *t[1:6])
    _close(means.numpy(), fc[0], dtype)
    _close(variances.numpy(), fc[1], dtype)


# -- ARMA ----------------------------------------------------------------------


def _polys(G, k, seed):
    rng = np.random.default_rng(seed)
    ar = np.zeros((G, k), np.float32)
    ma = np.zeros((G, k), np.float32)
    ar[:, 0] = ma[:, 0] = 1.0
    ar[:, 1:] = rng.uniform(0.1, 0.9, (G, k - 1)) * np.array([1, -0.5, 0.2][: k - 1])
    ma[:, 1:] = rng.uniform(0.1, 0.9, (G, k - 1))
    x = (rng.normal(size=(G, 400)) * 100).astype(np.float32)
    return ar, ma, x


def test_lfilter_float32_equals_jax_bit_for_bit():
    ar, ma, x = _polys(8, 4, 0)
    want = np.asarray(jax.vmap(jax_arma.lfilter)(ma, ar, x))
    got = arma.lfilter(ma, ar, x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # One series at a time too (JAX un-vmapped).
    np.testing.assert_array_equal(arma.lfilter(ma[1], ar[1], x[1]),
                                  np.asarray(jax_arma.lfilter(ma[1], ar[1], x[1])))


@pytest.mark.parametrize("k", [1, 2, 4], ids=["arma00", "arma11", "arma33"])
def test_lfilter_matches_scipy(k):
    ar, ma, x = _polys(3, k, k)
    for g in range(3):
        want = scipy.signal.lfilter(ma[g].astype(np.float64), ar[g].astype(np.float64),
                                    x[g].astype(np.float64))
        np.testing.assert_allclose(arma.lfilter(ma[g], ar[g], x[g]), want, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(arma.lfilter(ma[g], ar[g], x[g].astype(np.float64)), want,
                                   rtol=1e-12, atol=1e-9)


def test_lfilter_pure_gain():
    x = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(arma.lfilter([3.0], [2.0], x), 1.5 * x)
    np.testing.assert_array_equal(arma.lfilter([3.0], [2.0], x),
                                  np.asarray(jax_arma.lfilter(jnp.array([3.0]),
                                                              jnp.array([2.0]), x)))


# -- normal draws and the demand table ----------------------------------------


@pytest.mark.parametrize("seed", [0, 123, 2**31 + 5])
def test_normal_draws_equal_jax_bit_for_bit(seed):
    keys = jax.random.split(jax.random.key(seed), 4)
    mine = ThreefryKey.from_seed(seed).split(4)
    for jk, tk in zip(keys, mine):
        want = np.asarray(jax.random.normal(jk, (20000,)))
        got = tk.normal(20000)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_erfinv_and_log1p_match_xla_on_their_whole_range():
    x = np.concatenate([np.linspace(-1, 1, 200001, dtype=np.float32),
                        np.float32([-1.0, 1.0, 0.0, -0.9999999, 1e-30])])
    np.testing.assert_array_equal(xla_erfinv(x), np.asarray(jax.lax.erf_inv(x)))
    u = np.linspace(-0.999, 3.0, 100001, dtype=np.float32)
    np.testing.assert_array_equal(xla_log1p(u), np.asarray(jnp.log1p(u)))


def test_arma_generate_sample_matches_jax():
    keys = jax.random.split(jax.random.key(5), 3)
    ar = np.array([1.0, -0.5, 0.2], np.float32)
    ma = np.array([1.0, 0.4, 0.0], np.float32)
    want = np.stack([np.asarray(jax_arma.arma_generate_sample(k, ar, ma, 60, scale=3.0,
                                                              burnin=100)) for k in keys])
    got = arma.arma_generate_sample(ThreefryKey.from_seed(5).split(3), ar, ma, 60, scale=3.0,
                                    burnin=100)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(n_skus_per_product=2, ts_length_years=1, seed=7),
                                dict(n_skus_per_product=3, ts_length_years=2, seed=123)],
                         ids=["2x53", "3x105"])
def test_generate_demand_matches_jax_row_for_row(kw):
    want = jax_demand.generate_demand(jax_demand.DemandConfig(**kw))
    got = demand.generate_demand(demand.DemandConfig(**kw))
    assert got.column_names == list(want.columns)
    assert got.num_rows == len(want)
    for col in ("Product", "SKU"):
        assert got.column(col).to_pylist() == want[col].tolist()
    np.testing.assert_array_equal(got.column("Date").to_numpy().astype("datetime64[us]"),
                                  want["Date"].to_numpy().astype("datetime64[us]"))
    d_got = got.column("Demand").to_numpy()
    d_want = want["Demand"].to_numpy()
    assert d_got.dtype == np.float32
    assert (d_got == d_want).mean() >= 0.999
    assert np.abs(d_got - d_want).max() <= 1.0
    np.testing.assert_array_equal(d_got, d_want)


def test_weekly_spine_factors_match_jax():
    cfg = dict(ts_length_years=1, end_date=jax_demand.DemandConfig().end_date)
    want = jax_demand.weekly_date_spine(jax_demand.DemandConfig(**cfg))
    got = demand.weekly_date_spine(demand.DemandConfig(**cfg))
    for col in ("Corona_Breakpoint_Helper", "Corona_Factor", "Week", "Factor_XMas"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy(), err_msg=col)
