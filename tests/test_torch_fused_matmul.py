"""The port's fused BN-apply + ReLU + 1x1 conv vs the JAX package's.

The same numpy inputs go through ``dss_ml_at_scale_tpu.ops.fused_matmul.
bn_relu_matmul`` (Pallas kernels K1-K3 in interpret mode, as the JAX
package's own tests run them on the CPU) and the port's op, whose CPU path
is the plain version of each kernel. Tolerances are those of
``tests/test_fused_matmul.py``: forward at rtol/atol 1e-5 (``:76``); every
cotangent (dy, dgamma, dbeta, dW, dres) at a max-abs error under 1e-5 of
the JAX gradient's max-abs (``:104``); awkward shapes at ``:113-118``; the
bf16 pipeline at rtol 0.05 / atol 0.15 (``:203``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.ops.fused_matmul import bn_relu_matmul as jax_op
from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm
from dss_ml_at_scale_tpu_torch.ops.fused_matmul import bn_relu_matmul

EPS = 1e-5
REL = 1e-5


def _inputs(seed=42, shape=(4, 6, 6, 24), n=40):
    rng = np.random.default_rng(seed)
    k = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(1.0, 0.2, k).astype(np.float32),
            rng.normal(0.0, 0.2, k).astype(np.float32),
            rng.normal(0.0, 0.1, (k, n)).astype(np.float32))  # y, res, gamma, beta, w


def _jax_fused(y, gamma, beta, w, residual=None):
    k = y.shape[-1]
    yf = y.reshape(-1, k).astype(jnp.float32)
    mean = jnp.mean(yf, 0)
    var = jnp.mean(jnp.square(yf), 0) - jnp.square(mean)
    return jax_op(y, gamma, beta, mean, var, w, eps=EPS, residual=residual)


def _torch_fused(y, gamma, beta, w, residual=None):
    k = y.shape[-1]
    yf = y.reshape(-1, k).float()
    mean = yf.mean(0)
    var = yf.square().mean(0) - mean.square()
    return bn_relu_matmul(y, gamma, beta, mean, var, w, eps=EPS, residual=residual)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("with_res", [False, True])
def test_forward_matches_jax(with_res):
    y, res, gamma, beta, w = _inputs()
    r = res if with_res else None
    want = _jax_fused(*map(jnp.asarray, (y, gamma, beta, w)), None if r is None else jnp.asarray(r))
    ty, tres, tg, tb, tw = _t(y, res, gamma, beta, w)
    got = _torch_fused(ty, tg, tb, tw, tres if with_res else None)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_res", [False, True])
def test_every_cotangent_matches_jax(with_res):
    y, res, gamma, beta, w = _inputs()

    def loss(args):
        out = _jax_fused(*args[:4], args[4] if with_res else None)
        return jnp.sum(jnp.sin(out))  # nonconstant cotangent

    want = jax.grad(loss)(tuple(map(jnp.asarray, (y, gamma, beta, w, res))))
    targs = _t(y, gamma, beta, w, res, grad=True)
    out = _torch_fused(*targs[:4], targs[4] if with_res else None)
    torch.sin(out).sum().backward()
    for name, a, t in zip(("dy", "dgamma", "dbeta", "dw", "dres"), want, targs):
        if name == "dres" and not with_res:
            assert t.grad is None
            continue
        assert _rel(a, t.grad) < REL, f"{name}: rel err {_rel(a, t.grad)}"


def test_awkward_shapes():
    """K, N, M on no tile boundary (the TPU pads; the port takes them)."""
    y, res, gamma, beta, w = _inputs(shape=(3, 5, 7, 17), n=33)
    jy, jg, jb, jw = map(jnp.asarray, (y, gamma, beta, w))
    np.testing.assert_allclose(
        _torch_fused(*_t(y, gamma, beta, w)), _jax_fused(jy, jg, jb, jw), rtol=1e-5, atol=1e-5)
    want = jax.grad(lambda t: jnp.sum(_jax_fused(t, jg, jb, jw)))(jy)
    ty = torch.tensor(y, requires_grad=True)
    _torch_fused(ty, *_t(gamma, beta, w)).sum().backward()
    np.testing.assert_allclose(ty.grad, want, rtol=1e-4, atol=1e-5)


def _running(seed, k):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, k).astype(np.float32),
            rng.uniform(0.5, 2.0, k).astype(np.float32))


def test_eval_mode_running_stats():
    y, _, gamma, beta, w = _inputs()
    ra_m, ra_v = _running(1, y.shape[-1])
    want = jax_op(*map(jnp.asarray, (y, gamma, beta, ra_m, ra_v, w)), eps=EPS)
    got = bn_relu_matmul(*_t(y, gamma, beta, ra_m, ra_v, w), eps=EPS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_constant_stats_gradients():
    """``batch_stats=False``: no statistics correction in dy."""
    y, _, gamma, beta, w = _inputs()
    ra_m, ra_v = _running(2, y.shape[-1])
    jargs = tuple(map(jnp.asarray, (gamma, beta, ra_m, ra_v, w)))

    def loss(t):
        return jnp.sum(jnp.sin(jax_op(t, *jargs, eps=EPS, batch_stats=False)))

    want = jax.grad(loss)(jnp.asarray(y))
    ty = torch.tensor(y, requires_grad=True)
    out = bn_relu_matmul(ty, *_t(gamma, beta, ra_m, ra_v, w), eps=EPS, batch_stats=False)
    torch.sin(out).sum().backward()
    assert _rel(want, ty.grad) < REL


def test_conv_kernel_4d_accepted_and_non_1x1_rejected():
    y, _, gamma, beta, w = _inputs()
    ty, tg, tb, tw = _t(y, gamma, beta, w)
    k = y.shape[-1]
    np.testing.assert_allclose(_torch_fused(ty, tg, tb, tw.reshape(1, 1, k, -1)),
                               _torch_fused(ty, tg, tb, tw), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="1x1"):
        bn_relu_matmul(ty, tg, tb, tg, tg, torch.zeros(3, 3, k, 8))
    with pytest.raises(ValueError, match="channels"):
        bn_relu_matmul(ty, tg, tb, tg, tg, torch.zeros(k + 1, 8))


def test_bf16_pipeline():
    """bf16 activations and weights, f32 channel vectors: the card's
    configuration, against JAX's f32 result at its bf16 tolerance."""
    y, res, gamma, beta, w = _inputs()
    want = _jax_fused(*map(jnp.asarray, (y, gamma, beta, w)), jnp.asarray(res))
    ty, tres, tw = (torch.tensor(a).to(torch.bfloat16) for a in (y, res, w))
    got = _torch_fused(ty, *_t(gamma, beta), tw, tres)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float(), want, rtol=0.05, atol=0.15)


def test_cpu_runs_the_plain_versions_and_launches_nothing():
    y, res, gamma, beta, w = _inputs()
    before = (fm.bn_relu_matmul_fwd.launches, fm.bn_relu_matmul_bwd_da.launches,
              fm.bn_relu_matmul_bwd_dw.launches)
    targs = _t(y, gamma, beta, w, res, grad=True)
    _torch_fused(*targs[:4], targs[4]).sum().backward()
    assert (fm.bn_relu_matmul_fwd.launches, fm.bn_relu_matmul_bwd_da.launches,
            fm.bn_relu_matmul_bwd_dw.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        fm.bn_relu_matmul_fwd(torch.zeros(4, 8, device="meta"), None, None, None)


def test_dw_splits_cover_m_in_whole_chunks():
    # K3's plan: runs of whole 64-row ring stages that cover M.
    for m, k, n in ((664832, 64, 256), (10388, 512, 2048), (4133, 72, 200), (1, 8, 8)):
        splits, chunk = fm.dw_plan(m, k, n, 132)
        assert chunk % 64 == 0 and splits * chunk >= m > (splits - 1) * chunk


_PLAN_SHAPES = [(664832, 64, 256), (166208, 128, 512), (41552, 256, 1024), (10388, 512, 2048),
                (4133, 72, 200), (1, 8, 8), (129, 136, 264), (5000, 64, 520)]


@pytest.mark.parametrize("sm_count", [1, 16, 132])
@pytest.mark.parametrize("m,k,n", _PLAN_SHAPES)
def test_dw_work_covers_every_output_tile_and_row_once(m, k, n, sm_count):
    work = fm.dw_work(m, k, n, sm_count)
    tile_k = fm.dw_tile_k(k)
    tiles = {(r, c) for r in range(0, k, tile_k) for c in range(0, n, 256)}
    # One CTA per (tile, run); the grid fills the SMs at most once unless
    # there are more output tiles than SMs.
    assert len(work) <= max(sm_count, len(tiles))
    runs = {}
    for k0, n0, begin, end in work:
        assert (k0, n0) in tiles
        # Runs start on whole ring stages, so no stage reads the next run's rows.
        assert begin % 64 == 0 and begin < end <= m
        runs.setdefault((k0, n0), []).append((begin, end))
    assert set(runs) == tiles
    for spans in runs.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # The tiles of one run are neighbours in CTA order.
    assert [w[2] for w in work] == sorted(w[2] for w in work)


@pytest.mark.parametrize("sm_count", [1, 16, 132])
@pytest.mark.parametrize("m,k,n", _PLAN_SHAPES)
def test_da_tile_walk_covers_every_tile_of_gt_once(m, k, n, sm_count):
    bn = fm.da_tile_n(k)
    walk = fm.da_tile_walk(m, k, bn, sm_count)
    tiles_k = -(-k // bn)
    tiles = -(-m // 128) * tiles_k
    assert len(walk) == min(sm_count, tiles)
    got = [tile for cta in walk for tile in cta]
    want = {(r, c) for r in range(0, m, 128) for c in range(0, k, bn)}
    assert len(got) == len(want) and set(got) == want
    # Channel bands first within an M band: a CTA's next tile is in a
    # later band of the same rows or further down.
    for cta in walk:
        for (r0, c0), (r1, c1) in zip(cta, cta[1:]):
            assert (r1, c1) > (r0, c0)
    # CTAs that start together cover the bands of one M band side by side.
    firsts = [cta[0] for cta in walk]
    assert firsts == sorted(firsts)


@pytest.mark.parametrize("k,want", [
    (8, 64), (64, 64), (72, 128), (128, 128), (136, 128), (256, 128), (512, 128), (2048, 128),
])
def test_da_tile_n_is_the_wgmma_width(k, want):
    assert fm.da_tile_n(k) == want


@pytest.mark.parametrize("k,want", [(8, 64), (64, 64), (72, 128), (256, 128), (2048, 128)])
def test_dw_tile_k_is_one_or_two_warpgroups_of_channels(k, want):
    assert fm.dw_tile_k(k) == want


@pytest.mark.parametrize("sm_count", [1, 16, 132])
@pytest.mark.parametrize("m,n", [(664832, 256), (166208, 512), (41552, 1024), (10388, 2048),
                                 (4133, 200), (1, 8), (129, 257)])
def test_fwd_tile_walk_covers_every_output_tile_once(m, n, sm_count):
    walk = fm.fwd_tile_walk(m, n, sm_count)
    tiles_m, tiles_n = -(-m // 128), -(-n // 256)
    assert len(walk) == min(sm_count, tiles_m * tiles_n)
    got = [tile for cta in walk for tile in cta]
    want = {(r, c) for r in range(0, m, 128) for c in range(0, n, 256)}
    assert len(got) == len(want) and set(got) == want
    # M first within a band of N: a CTA's next tile is further down, or the
    # first rows of the next band.
    for cta in walk:
        for (r0, c0), (r1, c1) in zip(cta, cta[1:]):
            assert (c1, r1) > (c0, r0)
