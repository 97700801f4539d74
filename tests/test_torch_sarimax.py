"""The port's optimizers and SARIMAX vs the JAX package's (``ops/neldermead.py``,
``jax.scipy.optimize.minimize(method="BFGS")``, ``ops/sarimax.py``).

- Nelder-Mead, float64, on a batch of quadratics, Rosenbrocks and lanes
  that turn NaN, converging at different iterations: ``x``, ``fun``,
  ``n_iter`` and ``converged`` per lane equal to JAX vmapped. The two rules
  that keep the lanes' decisions JAX's have tests of their own: NaN and
  +inf map to float max (``jnp.nan_to_num(x, nan=inf)``), and the vertex
  order is a stable sort.
- BFGS, float64, on the same batch: ``nit``, ``status`` and ``nfev`` equal
  to JAX's per lane, ``x`` and ``fun`` within 1e-6.
- SARIMAX at the golden fixture's pinned points
  (``tests/fixtures/sarimax_golden.json``): ``sarimax_loglike`` and
  ``sarimax_predict`` in float32 against the oracle with the JAX test's
  tolerances (``test_sarimax_golden.py``: rel 1e-4 / abs 0.05, rtol 1e-3 /
  atol 5e-3) and in float64 against JAX within 1e-10.
- ``_start_params`` and ``_concentrated_nll`` against JAX in float64.
- ``sarimax_fit`` at a small config (max_iter 20, bfgs_iter 5), float64:
  params within 1e-6 relative of JAX's per order. In float32 the achieved
  loglike is no worse than JAX's by more than the JAX test's per-order bar
  (``_fit_tol``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.scipy.optimize  # noqa: F401  (registers jax.scipy.optimize)
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.ops import neldermead as jax_nm
from dss_ml_at_scale_tpu.ops import sarimax as jax_sx
from dss_ml_at_scale_tpu_torch.ops import sarimax as sx
from dss_ml_at_scale_tpu_torch.ops.bfgs import minimize_bfgs
from dss_ml_at_scale_tpu_torch.ops.neldermead import nan_to_max, nelder_mead

FIXTURE = Path(__file__).parent / "fixtures" / "sarimax_golden.json"

# -- the optimizers on a batch of test functions ------------------------------

L, NDIM = 12, 4


def _batch():
    rng = np.random.default_rng(0)
    return rng.normal(size=(L, NDIM)) * 2, rng.uniform(0.5, 5, (L, NDIM)), np.arange(L) % 3


def _jax_fn(x, s, k):
    quad = jnp.sum(s * (x - 1.0) ** 2)
    ros = jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    return jnp.where(k == 0, quad, jnp.where(k == 1, ros, jnp.where(x[0] > 0.5, jnp.nan, quad)))


def _port_fn(x, s, k):
    quad = (s * (x - 1.0) ** 2).sum(-1)
    ros = (100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1 - x[..., :-1]) ** 2).sum(-1)
    return torch.where(k == 0, quad, torch.where(k == 1, ros,
                                                 torch.where(x[..., 0] > 0.5, torch.nan, quad)))


@pytest.fixture(scope="module")
def jax_optima():
    x0, s, k = _batch()
    with jax.enable_x64(True):
        args = (jnp.asarray(x0), jnp.asarray(s), jnp.asarray(k))
        nm = jax.vmap(lambda x, s, k: jax_nm.nelder_mead(
            lambda z: _jax_fn(z, s, k), x, max_iter=300))(*args)
        bf = jax.vmap(lambda x, s, k: jax.scipy.optimize.minimize(
            lambda z: _jax_fn(z, s, k), x, method="BFGS", options={"maxiter": 50}))(*args)
        return ({f: np.asarray(v) for f, v in nm._asdict().items()},
                {f: np.asarray(getattr(bf, f)) for f in ("x", "fun", "nit", "status", "nfev")})


def test_nelder_mead_matches_jax_per_lane(jax_optima):
    want, _ = jax_optima
    x0, s, k = _batch()
    S, K = torch.tensor(s), torch.tensor(k)
    got = nelder_mead(lambda x: _port_fn(x, S[:, None], K[:, None]), torch.tensor(x0),
                      max_iter=300)
    assert got.x.dtype == torch.float64
    # The lanes stop at different iterations, some at max_iter.
    assert len(set(want["n_iter"].tolist())) > 5 and (want["n_iter"] == 300).any()
    np.testing.assert_array_equal(got.n_iter.numpy(), want["n_iter"])
    np.testing.assert_array_equal(got.converged.numpy(), want["converged"])
    np.testing.assert_allclose(got.x.numpy(), want["x"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.fun.numpy(), want["fun"], rtol=1e-12, atol=1e-12)


def test_nelder_mead_lane_that_yields_nan():
    # Every point of lane 1 is NaN: its values are all float max, the
    # simplex shrinks toward vertex 0 and the lane's fun is float max.
    x0 = np.array([[0.3, -0.2], [1.0, 2.0]])

    def jf(x, bad):
        return jnp.where(bad, jnp.nan, jnp.sum(x * x))

    with jax.enable_x64(True):
        want = jax.vmap(lambda x, b: jax_nm.nelder_mead(lambda z: jf(z, b), x, max_iter=40))(
            jnp.asarray(x0), jnp.array([False, True]))
    bad = torch.tensor([False, True])
    got = nelder_mead(lambda x: torch.where(bad[:, None], torch.nan, (x * x).sum(-1)),
                      torch.tensor(x0), max_iter=40)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.fun.numpy(), np.asarray(want.fun))
    assert got.fun[1] == torch.finfo(torch.float64).max
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nan_to_max_is_jax_nan_to_num_with_nan_inf(dtype):
    x = np.array([np.nan, np.inf, -np.inf, 1.5, -0.0], dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jnp.nan_to_num(jnp.asarray(x), nan=jnp.inf))
    got = nan_to_max(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.finfo(dtype).max and got[1] == np.finfo(dtype).max
    # torch's own nan_to_num(nan=inf) would leave NaN as inf: the rule matters.
    assert torch.isinf(torch.nan_to_num(torch.tensor(x), nan=float("inf"))[0])


def test_vertex_order_is_stable_among_float_max_ties():
    # Only the start is finite: every perturbed vertex (and most points
    # after) maps to float max, so the sort breaks ties by vertex order.
    # An unstable order picks another "worst" vertex and another path.
    x0 = np.array([[0.5, -1.0, 2.0], [0.1, 0.2, 0.3]])

    def jf(x):
        return jnp.where(jnp.sum(jnp.abs(x - x0[0])) + jnp.sum(jnp.abs(x - x0[1])) > 3.05,
                         jnp.nan, jnp.sum(x ** 2))

    with jax.enable_x64(True):
        want = jax.vmap(lambda x: jax_nm.nelder_mead(jf, x, max_iter=60))(jnp.asarray(x0))
    X0 = torch.tensor(x0)

    def pf(x):
        far = (x - X0[0]).abs().sum(-1) + (x - X0[1]).abs().sum(-1) > 3.05
        return torch.where(far, torch.nan, (x ** 2).sum(-1))

    got = nelder_mead(pf, X0, max_iter=60)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    f = torch.tensor([1.0, 3.4e38, 3.4e38, 3.4e38, 2.0, 3.4e38])
    assert torch.argsort(f, stable=True).tolist() == np.asarray(jnp.argsort(f.numpy())).tolist()


def test_bfgs_matches_jax_per_lane(jax_optima):
    _, want = jax_optima
    x0, s, k = _batch()
    S, K = torch.tensor(s), torch.tensor(k)
    got = minimize_bfgs(lambda x, lanes: _port_fn(x, S[lanes], K[lanes]), torch.tensor(x0),
                        maxiter=50)
    np.testing.assert_array_equal(got.nit.numpy(), want["nit"])
    np.testing.assert_array_equal(got.status.numpy(), want["status"])
    np.testing.assert_array_equal(got.nfev.numpy(), want["nfev"])
    # Statuses 0 (converged), 1 (maxiter) and 3 (line search failed at its
    # maximum) all occur.
    assert {0, 1, 3} <= set(want["status"].tolist())
    np.testing.assert_allclose(got.x.numpy(), want["x"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.fun.numpy(), want["fun"], rtol=1e-6, atol=1e-12)


def test_bfgs_lane_chunks_do_not_change_the_result():
    x0, s, k = _batch()
    S, K = torch.tensor(s), torch.tensor(k)
    fn = lambda x, lanes: _port_fn(x, S[lanes], K[lanes])  # noqa: E731
    whole = minimize_bfgs(fn, torch.tensor(x0), maxiter=20)
    chunked = minimize_bfgs(fn, torch.tensor(x0), maxiter=20, lane_chunk=5)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- SARIMAX at the golden fixture --------------------------------------------

CFG = dict(k_exog=3)
FIT = dict(k_exog=3, max_iter=20, bfgs_iter=5)
# Fit orders across the grid: every corner kind, both d = 0 and d >= 1.
FIT_ORDERS = [(0, 0, 0), (1, 1, 1), (2, 1, 0), (4, 2, 4), (0, 1, 2), (3, 0, 1)]


@pytest.fixture(scope="module")
def golden():
    fix = json.loads(FIXTURE.read_text())
    cfg = sx.SarimaxConfig(**CFG)

    def pack(c):
        return np.concatenate([c["beta"], np.pad(c["phi"], (0, cfg.max_p - len(c["phi"]))),
                               np.pad(c["theta"], (0, cfg.max_q - len(c["theta"]))),
                               [c["log_sigma2"]]])

    fix["_params"] = np.stack([pack(c) for c in fix["cases"]])
    fix["_orders"] = np.array([c["order"] for c in fix["cases"]])
    return fix


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_sarimax_packed_layout_round_trips(golden):
    cfg = sx.SarimaxConfig(**CFG)
    p = _t(golden["_params"])
    assert p.shape[-1] == cfg.n_params == jax_sx.SarimaxConfig(**CFG).n_params
    assert torch.equal(cfg.pack(*cfg.unpack(p)), p)
    for a, b in zip(cfg.unpack(p), jax_sx.SarimaxConfig(**CFG).unpack(golden["_params"][0])):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


def test_loglike_and_predict_match_oracle_in_float32(golden):
    cfg = sx.SarimaxConfig(**CFG)
    f32 = torch.float32
    args = (_t(golden["y"], f32), _t(golden["exog"], f32),
            torch.tensor(golden["_orders"]), torch.tensor(golden["n_valid"]))
    ll = sx.sarimax_loglike(cfg, _t(golden["_params"], f32), *args)
    pred = sx.sarimax_predict(cfg, _t(golden["_params"], f32), *args)
    assert ll.dtype == f32 and pred.dtype == f32
    for i, case in enumerate(golden["cases"]):
        assert float(ll[i]) == pytest.approx(case["loglike"], rel=1e-4, abs=0.05), case["order"]
        np.testing.assert_allclose(pred[i].numpy(), case["predict"], rtol=1e-3, atol=5e-3,
                                   err_msg=str(case["order"]))


def test_loglike_and_predict_match_jax_in_float64(golden):
    cfg = sx.SarimaxConfig(**CFG)
    jcfg = jax_sx.SarimaxConfig(**CFG)
    y, ex, nv = golden["y"], golden["exog"], golden["n_valid"]
    with jax.enable_x64(True):
        one = jax.jit(jax.vmap(lambda p, o: (
            jax_sx.sarimax_loglike(jcfg, p, jnp.asarray(y), jnp.asarray(ex), o, nv),
            jax_sx.sarimax_predict(jcfg, p, jnp.asarray(y), jnp.asarray(ex), o, nv))))
        jll, jpred = (np.asarray(a) for a in one(jnp.asarray(golden["_params"]),
                                                   jnp.asarray(golden["_orders"])))
    args = (_t(y), _t(ex), torch.tensor(golden["_orders"]), torch.tensor(nv))
    ll = sx.sarimax_loglike(cfg, _t(golden["_params"]), *args).numpy()
    pred = sx.sarimax_predict(cfg, _t(golden["_params"]), *args).numpy()
    np.testing.assert_allclose(ll, jll, rtol=1e-10)
    np.testing.assert_allclose(pred, jpred, rtol=1e-10, atol=1e-8)


def test_start_params_and_concentrated_nll_match_jax(golden):
    cfg = sx.SarimaxConfig(**CFG)
    jcfg = jax_sx.SarimaxConfig(**CFG)
    y, ex, nv = golden["y"], golden["exog"], golden["n_valid"]
    orders = golden["_orders"]
    free = golden["_params"][:, :-1]
    with jax.enable_x64(True):
        jy, jex = jnp.asarray(y), jnp.asarray(ex)
        jhr, jar = jax.jit(jax.vmap(lambda o: jax_sx._start_params(jcfg, jy, jex, o, nv)))(
            jnp.asarray(orders))
        jnll, jls = jax.jit(jax.vmap(
            lambda f, o: jax_sx._concentrated_nll(jcfg, f, jy, jex, o, nv)))(
            jnp.asarray(free), jnp.asarray(orders))
    args = (_t(y), _t(ex), torch.tensor(orders), torch.tensor(nv))
    hr, ar = sx._start_params(cfg, *args)
    np.testing.assert_allclose(hr.numpy(), np.asarray(jhr), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(ar.numpy(), np.asarray(jar), rtol=1e-9, atol=1e-10)
    nll, ls = sx._concentrated_nll(cfg, _t(free), *args)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=1e-10)
    np.testing.assert_allclose(ls.numpy(), np.asarray(jls), rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def jax_fits(golden):
    y, ex, nv = golden["y"], golden["exog"], golden["n_valid"]
    out = {}
    for dtype in (np.float64, np.float32):
        with jax.enable_x64(dtype == np.float64):
            jcfg = jax_sx.SarimaxConfig(**FIT)
            jy, jex = jnp.asarray(y, dtype), jnp.asarray(ex, dtype)
            out[dtype] = [{f: np.asarray(v) for f, v in jax_sx.sarimax_fit(
                jcfg, jy, jex, jnp.asarray(o), nv)._asdict().items()} for o in FIT_ORDERS]
    return out


def test_sarimax_fit_matches_jax_in_float64(golden, jax_fits):
    cfg = sx.SarimaxConfig(**FIT)
    got = sx.sarimax_fit(cfg, _t(golden["y"]), _t(golden["exog"]), torch.tensor(FIT_ORDERS),
                         torch.tensor(golden["n_valid"]))
    assert got.params.shape == (len(FIT_ORDERS), cfg.n_params)
    for i, (order, want) in enumerate(zip(FIT_ORDERS, jax_fits[np.float64])):
        p, w = got.params[i].numpy(), want["params"]
        assert np.max(np.abs(p - w) / np.maximum(np.abs(w), 1e-3)) <= 1e-6, order
        assert float(got.loglike[i]) == pytest.approx(float(want["loglike"]), rel=1e-8)
        assert int(got.n_iter[i]) == int(want["n_iter"]), order
        assert bool(got.converged[i]) == bool(want["converged"]), order


def _fit_tol(order) -> float:
    """``tests/test_sarimax_golden.py``'s per-order fit bar."""
    p, d, q = order
    if d == 0 and (p or q):
        return 30.0
    return max(1.0, 1.5 * (p + q))


def test_sarimax_fit_float32_is_no_worse_than_jax(golden, jax_fits):
    cfg = sx.SarimaxConfig(**FIT)
    f32 = torch.float32
    got = sx.sarimax_fit(cfg, _t(golden["y"], f32), _t(golden["exog"], f32),
                         torch.tensor(FIT_ORDERS), torch.tensor(golden["n_valid"]))
    assert got.params.dtype == f32
    for i, (order, want) in enumerate(zip(FIT_ORDERS, jax_fits[np.float32])):
        ll = float(got.loglike[i])
        assert np.isfinite(ll), order
        assert ll >= float(want["loglike"]) - _fit_tol(order), (order, ll, want["loglike"])


def test_float32_objective_and_starts_are_as_accurate_as_jax(golden):
    # At (4, 2, 1), whose f32 fit at max_iter 600 lands in either of two
    # basins in both packages: the f32 objective around the start is
    # JAX's to float32 rounding, and the f32 start values are no further
    # from the f64 ones than JAX's are.
    order = (4, 2, 1)
    nv = golden["n_valid"]
    y = np.asarray(golden["y"], np.float32)
    ex = np.asarray(golden["exog"], np.float32)
    jcfg = jax_sx.SarimaxConfig(**CFG)
    cfg = sx.SarimaxConfig(**CFG)
    jhr, _ = jax_sx._start_params(jcfg, jnp.asarray(y), jnp.asarray(ex), jnp.asarray(order), nv)
    with jax.enable_x64(True):
        hr64, _ = jax_sx._start_params(jcfg, jnp.asarray(y, jnp.float64),
                                       jnp.asarray(ex, jnp.float64), jnp.asarray(order), nv)
    args = (torch.tensor(y)[None], torch.tensor(ex)[None], torch.tensor([order]),
            torch.tensor([nv]))
    hr, _ = sx._start_params(cfg, *args)
    jax_err = np.abs(np.asarray(jhr) - np.asarray(hr64)).max()
    assert np.abs(hr[0].numpy() - np.asarray(hr64)).max() <= 2 * jax_err
    rng = np.random.default_rng(0)
    base = np.asarray(jhr)[:-1]
    pts = (base + rng.normal(size=(64, base.size)) * 0.05 * (np.abs(base) + 0.1))
    pts = pts.astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda f: jax_sx._concentrated_nll(
        jcfg, f, jnp.asarray(y), jnp.asarray(ex), jnp.asarray(order), nv)[0]))(pts))
    got = sx._concentrated_nll(cfg, torch.tensor(pts), *args)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grid_orders_match_jax():
    for kw in ({}, dict(max_p=1, max_d=1, max_q=2)):
        np.testing.assert_array_equal(sx.grid_orders(sx.SarimaxConfig(**kw)),
                                      jax_sx.grid_orders(jax_sx.SarimaxConfig(**kw)))
    assert len(sx.grid_orders(sx.SarimaxConfig())) == 75
