"""The fused BN-apply + ReLU + 1x1 conv at shapes off the kernels' rows, and
the plans of its f32 kernels (K1f-K3f).

The port's op zero-pads K and N to the kernels' 16-byte rows (4 channels in
f32, 8 in bf16) on every device, as the JAX op pads them to its 128 lanes
(``dss_ml_at_scale_tpu/ops/fused_matmul.py:406-413``); on the CPU the padded
operands go through the plain versions. The same numpy inputs go through
``dss_ml_at_scale_tpu.ops.fused_matmul.bn_relu_matmul`` (its Pallas kernels
in interpret mode) and the port's op, at the tolerances of
``tests/test_fused_matmul.py``: forward at rtol/atol 1e-5 (``:76``), every
cotangent under 1e-5 of the JAX gradient's max-abs (``:104``), the bf16
pipeline at rtol 0.05 / atol 0.15 (``:203``). The f32 kernels' tile walks and
K3f's split plan are pure functions, checked here to cover every output tile
and every row exactly once, and their 3xTF32 arithmetic is emulated here
against JAX's bars; the kernels themselves run on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dss_ml_at_scale_tpu.ops.fused_matmul import bn_relu_matmul as jax_op
from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm
from dss_ml_at_scale_tpu_torch.ops.fused_matmul import bn_relu_matmul

EPS = 1e-5
REL = 1e-5

# (lead shape, K, N, residual): JAX's awkward case (K 17, N 33), and K 20 /
# N 36 with a residual over a ragged M (aligned in f32, padded in bf16).
AWKWARD = [((3, 5, 7), 17, 33, False), ((2, 9, 11), 20, 36, True), ((5, 3), 6, 10, True)]


def _inputs(lead, k, n, seed=42):
    rng = np.random.default_rng(seed)
    shape = (*lead, k)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(1.0, 0.2, k).astype(np.float32),
            rng.normal(0.0, 0.2, k).astype(np.float32),
            rng.normal(0.0, 0.1, (k, n)).astype(np.float32))  # y, res, gamma, beta, w


def _stats(yf):
    mean = yf.mean(0)
    return mean, (yf * yf).mean(0) - mean * mean


def _jax_fused(y, gamma, beta, w, residual=None):
    mean, var = _stats(y.reshape(-1, y.shape[-1]).astype(jnp.float32))
    return jax_op(y, gamma, beta, mean, var, w, eps=EPS, residual=residual)


def _torch_fused(y, gamma, beta, w, residual=None):
    mean, var = _stats(y.reshape(-1, y.shape[-1]).float())
    return bn_relu_matmul(y, gamma, beta, mean, var, w, eps=EPS, residual=residual)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


@pytest.mark.parametrize("lead,k,n,with_res", AWKWARD)
def test_padded_forward_matches_jax(lead, k, n, with_res):
    y, res, gamma, beta, w = _inputs(lead, k, n)
    r = res if with_res else None
    want = _jax_fused(*map(jnp.asarray, (y, gamma, beta, w)), None if r is None else jnp.asarray(r))
    got = _torch_fused(*map(torch.tensor, (y, gamma, beta, w)),
                       None if r is None else torch.tensor(r))
    assert got.shape == (*lead, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead,k,n,with_res", AWKWARD)
def test_padded_cotangents_match_jax(lead, k, n, with_res):
    y, res, gamma, beta, w = _inputs(lead, k, n)

    def loss(args):
        out = _jax_fused(*args[:4], args[4] if with_res else None)
        return jnp.sum(jnp.sin(out))  # nonconstant cotangent

    want = jax.grad(loss)(tuple(map(jnp.asarray, (y, gamma, beta, w, res))))
    targs = [torch.tensor(a, requires_grad=True) for a in (y, gamma, beta, w, res)]
    torch.sin(_torch_fused(*targs[:4], targs[4] if with_res else None)).sum().backward()
    for name, a, t in zip(("dy", "dgamma", "dbeta", "dw", "dres"), want, targs):
        if name == "dres" and not with_res:
            assert t.grad is None
            continue
        assert t.grad.shape == t.shape, name  # sliced back from the padded op
        assert _rel(a, t.grad) < REL, f"{name}: rel err {_rel(a, t.grad)}"


def test_padded_awkward_dy_at_jax_tolerance():
    """tests/test_fused_matmul.py:107-118 word for word: the awkward shape's
    dy of a plain sum at rtol 1e-4 / atol 1e-5."""
    y, _, gamma, beta, w = _inputs((3, 5, 7), 17, 33)
    jy, jg, jb, jw = map(jnp.asarray, (y, gamma, beta, w))
    want = jax.grad(lambda t: jnp.sum(_jax_fused(t, jg, jb, jw)))(jy)
    ty = torch.tensor(y, requires_grad=True)
    _torch_fused(ty, *map(torch.tensor, (gamma, beta, w))).sum().backward()
    np.testing.assert_allclose(ty.grad, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lead,k,n,with_res", AWKWARD)
def test_padded_bf16_pipeline(lead, k, n, with_res):
    """bf16 operands pad K and N to 8: against JAX's f32 result at its bf16
    tolerance."""
    y, res, gamma, beta, w = _inputs(lead, k, n)
    r = res if with_res else None
    want = _jax_fused(*map(jnp.asarray, (y, gamma, beta, w)), None if r is None else jnp.asarray(r))
    ty, tw = (torch.tensor(a).to(torch.bfloat16) for a in (y, w))
    tr = None if r is None else torch.tensor(r).to(torch.bfloat16)
    got = _torch_fused(ty, torch.tensor(gamma), torch.tensor(beta), tw, tr)
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, n)
    np.testing.assert_allclose(got.float(), want, rtol=0.05, atol=0.15)


def _spy(monkeypatch):
    """Record the operands the op hands to its autograd Function."""
    seen = []
    apply = fm._BnReluMatmul.apply

    def spy(*args):
        seen.append(args)
        return apply(*args)

    monkeypatch.setattr(fm._BnReluMatmul, "apply", spy)
    return seen


@pytest.mark.parametrize("dtype,k,n", [(torch.float32, 24, 40), (torch.float32, 64, 256),
                                       (torch.bfloat16, 64, 256), (torch.bfloat16, 8, 16)])
def test_aligned_shapes_take_no_pad(monkeypatch, dtype, k, n):
    y, res, gamma, beta, w = _inputs((2, 3, 5), k, n)
    ty, tres, tw = (torch.tensor(a).to(dtype) for a in (y, res, w))
    seen = _spy(monkeypatch)

    def no_pad(*args, **kwargs):
        raise AssertionError("an aligned shape took a pad")

    monkeypatch.setattr(fm.F, "pad", no_pad)
    out = _torch_fused(ty, torch.tensor(gamma), torch.tensor(beta), tw, tres)
    assert out.shape == (2, 3, 5, n)
    (args,) = seen
    y2, w2, res2 = args[0], args[5], args[6]
    # The kernels see the caller's tensors: views, never copies.
    assert y2.data_ptr() == ty.data_ptr() and y2.shape == (30, k)
    assert w2 is tw
    assert res2.data_ptr() == tres.data_ptr()


@pytest.mark.parametrize("dtype,k,n,want_k,want_n", [
    (torch.float32, 17, 33, 20, 36), (torch.bfloat16, 17, 33, 24, 40),
    (torch.float32, 20, 36, 20, 36), (torch.bfloat16, 20, 36, 24, 40),
])
def test_ragged_shapes_pad_to_the_dtypes_rows(monkeypatch, dtype, k, n, want_k, want_n):
    y, res, gamma, beta, w = _inputs((2, 7), k, n)
    ty, tres, tw = (torch.tensor(a).to(dtype) for a in (y, res, w))
    seen = _spy(monkeypatch)
    out = _torch_fused(ty, torch.tensor(gamma), torch.tensor(beta), tw, tres)
    assert out.shape == (2, 7, n)
    (args,) = seen
    y2, gamma2, beta2, mean2, var2, w2, res2 = args[:7]
    assert y2.shape == res2.shape == (14, want_k) and w2.shape == (want_k, want_n)
    for v in (gamma2, beta2, mean2, var2):
        assert v.shape == (want_k,) and not v[k:].any()  # a = relu(0) = 0 there
    assert not y2[:, k:].any() and not w2[k:].any() and not w2[:, n:].any()
    assert args[9] == 14  # the statistics keep the real row count


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, 8), (torch.float32, 4),
                                        (torch.float16, 8)])
def test_row_align_is_16_bytes(dtype, want):
    assert fm.row_align(dtype) == want


def _operands(dtype, k=16, n=32, m=8):
    return torch.zeros(m, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)


def test_kernel_inputs_take_bf16_and_f32():
    for dtype in (torch.bfloat16, torch.float32):
        y, w = _operands(dtype)
        fm.check_kernel_inputs(8, 16, 32, operands=(y, w), f32=(torch.zeros(16),))


@pytest.mark.parametrize("make,match", [
    (lambda: _operands(torch.float16), "bfloat16 or float32 operands, got torch.float16"),
    (lambda: (_operands(torch.float32)[0], _operands(torch.bfloat16)[1]), "of one type"),
    (lambda: _operands(torch.float32, k=18), "multiples of 4 in torch.float32"),
    (lambda: _operands(torch.bfloat16, n=36), "multiples of 8 in torch.bfloat16"),
])
def test_kernel_inputs_refuse_what_no_kernel_takes(make, match):
    y, w = make()
    with pytest.raises(ValueError, match=match):
        fm.check_kernel_inputs(8, y.shape[1], w.shape[1], operands=(y, w))


# -- the f32 kernels' plans ---------------------------------------------------

_SHAPES = st.tuples(st.integers(1, 3000), st.integers(1, 160).map(lambda x: 4 * x),
                    st.integers(1, 160).map(lambda x: 4 * x))
_SMS = st.sampled_from([1, 3, 16, 132])
_PLAN_SETTINGS = settings(max_examples=60, deadline=None)


@_PLAN_SETTINGS
@given(shape=_SHAPES, sm_count=_SMS)
def test_k1f_tiles_cover_every_output_tile_once(shape, sm_count):
    m, _, n = shape
    slots = fm.cta_slots(sm_count, torch.float32)
    walk = fm.fwd_tile_walk(m, n, sm_count, torch.float32)
    want = [(r, c) for r in range(0, m, 128) for c in range(0, n, 128)]
    assert len(walk) == min(slots, len(want))  # persistent: one CTA an SM at most
    got = [tile for cta in walk for tile in cta]
    assert len(got) == len(want) and set(got) == set(want)
    # The kernel's order: tile i is column band i % tiles_n of row tile
    # i // tiles_n (the N bands of an M band first), CTA c takes tiles c,
    # c + grid, ...; so round j of the walk is tiles j * grid .. in order.
    grid = len(walk)
    for c, cta in enumerate(walk):
        assert cta == want[c::grid]


@pytest.mark.parametrize("m,n,most,least", [
    (664832, 256, 79, 78), (166208, 512, 40, 39), (41552, 1024, 20, 19), (10388, 2048, 10, 9)])
def test_k1f_walk_at_the_resnet50_stages(m, n, most, least):
    # 132 CTAs, one on each of the H100's SMs, share the 128 x 128 tiles
    # (10,388 at stage 1, 1,312 at stage 4) within one tile of each other;
    # the CTAs of a round read the same rows of y: stage 1's two column
    # bands of a row tile go to neighbouring CTAs.
    walk = fm.fwd_tile_walk(m, n, 132, torch.float32)
    assert len(walk) == 132
    assert max(map(len, walk)) == most and min(map(len, walk)) == least
    first = [cta[0] for cta in walk]
    assert first[:2 * (n // 128)] == [(r, c) for r in (0, 128) for c in range(0, n, 128)]


@_PLAN_SETTINGS
@given(shape=_SHAPES, sm_count=_SMS)
def test_k2f_walk_covers_every_tile_of_gt_once(shape, sm_count):
    m, k, _ = shape
    bn = fm.da_tile_n(k)
    slots = fm.cta_slots(sm_count, torch.float32)
    assert slots == sm_count  # one CTA an SM, as the bf16 K2's walk
    walk = fm.da_tile_walk(m, k, bn, slots)
    tiles = -(-m // 128) * -(-k // bn)
    assert len(walk) == min(slots, tiles)
    got = [tile for cta in walk for tile in cta]
    want = {(r, c) for r in range(0, m, 128) for c in range(0, k, bn)}
    assert len(got) == len(want) and set(got) == want
    for cta in walk:  # each CTA's tiles in order: its sums are added in a fixed order
        assert cta == sorted(cta)


@_PLAN_SETTINGS
@given(shape=_SHAPES, sm_count=_SMS)
def test_k3f_split_plan_covers_every_tile_and_row_once(shape, sm_count):
    m, k, n = shape
    splits, chunk = fm.dw_plan(m, k, n, sm_count, torch.float32)
    # Runs of whole 32-row ring stages: no stage crosses into the next run.
    assert chunk % 32 == 0 and splits * chunk >= m > (splits - 1) * chunk
    work = fm.dw_work(m, k, n, sm_count, torch.float32)
    tile_k = fm.dw_tile_k(k)
    tiles = {(r, c) for r in range(0, k, tile_k) for c in range(0, n, 128)}
    assert len(work) == len(tiles) * splits
    # The runs fill one CTA per SM at most, unless the tiles alone are more.
    assert len(work) <= max(sm_count, len(tiles))
    rows = {}
    for k0, n0, begin, end in work:
        assert (k0, n0) in tiles and begin % 32 == 0 and begin < end <= m
        rows.setdefault((k0, n0), []).append((begin, end))
    assert set(rows) == tiles
    for spans in rows.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("m,k,n,splits,chunk,ctas", [
    (664832, 64, 256, 66, 10080, 132), (166208, 128, 512, 33, 5056, 132),
    (41552, 256, 1024, 8, 5216, 128), (10388, 512, 2048, 2, 5216, 128)])
def test_k3f_plan_at_the_resnet50_stages(m, k, n, splits, chunk, ctas):
    # Stage 1's two 64 x 128 tiles of dW split M 66 ways: 132 CTAs, one on
    # each of the H100's 132 SMs, each summing 315 stages of 32 rows.
    assert fm.dw_plan(m, k, n, 132, torch.float32) == (splits, chunk)
    assert len(fm.dw_work(m, k, n, 132, torch.float32)) == ctas


def test_bf16_plans_unchanged_by_the_f32_ones():
    assert fm.dw_plan(664832, 64, 256, 132) == fm.dw_plan(664832, 64, 256, 132, torch.bfloat16)
    assert fm.dw_plan(664832, 64, 256, 132)[1] % 64 == 0
    assert fm.cta_slots(132, torch.bfloat16) == 132
    assert fm.fwd_tile_walk(300, 600, 4) == fm.fwd_tile_walk(300, 600, 4, torch.bfloat16)
    assert len(fm.fwd_tile_walk(300, 600, 4)) == 4


def test_cpu_f32_counts_no_launch():
    y, res, gamma, beta, w = _inputs((3, 5, 7), 17, 33)
    before = [(f.launches, f.launches_f32) for f in
              (fm.bn_relu_matmul_fwd, fm.bn_relu_matmul_bwd_da, fm.bn_relu_matmul_bwd_dw)]
    ty = torch.tensor(y, requires_grad=True)
    _torch_fused(ty, *map(torch.tensor, (gamma, beta, w))).sum().backward()
    after = [(f.launches, f.launches_f32) for f in
             (fm.bn_relu_matmul_fwd, fm.bn_relu_matmul_bwd_da, fm.bn_relu_matmul_bwd_dw)]
    assert after == before


# -- 3xTF32: the arithmetic of K1f, K2f and K3f --------------------------------
#
# K1f-K3f take each f32 product on the tensor cores as three TF32 products,
# A_hi B_hi + A_hi B_lo + A_lo B_hi, of the halves that fm.tf32_split gives
# (cvt.rna.tf32.f32's rounding, emulated in torch ops). Emulated here on the
# CPU with f32 accumulation, against the JAX op's f32 forward and gradients
# (its Pallas kernels in interpret mode): out (K1's function) element by
# element at rtol/atol 1e-5, summed as K1f sums it, a fresh chain per 32-deep
# stage added into an f32 accumulator, at the four ResNet-50 stages' K and N;
# gt (the residual's cotangent, K2's function, with beta shifted so that the
# mask is on everywhere and gt is the bare product) over reductions of 256
# to 2,048, and dW (K3's function) over one long run of M. Three passes meet
# JAX's bars; one TF32 pass (A_hi B_hi) does not.

def _tf32_product(a, b, passes):
    a_hi, a_lo = fm.tf32_split(a)
    b_hi, b_lo = fm.tf32_split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi  # the kernels' order


def _tf32_case(kernel, m, k, n, passes):
    """(emulated, JAX's) result of ``kernel`` at [m, k] x [k, n] shapes."""
    rng = np.random.default_rng(7)
    y, res, g = (rng.normal(size=shape).astype(np.float32)
                 for shape in ((m, k), (m, k), (m, n)))
    gamma = rng.normal(1.0, 0.2, k).astype(np.float32)
    beta = (rng.normal(0.0, 0.2, k) + (8.0 if kernel == "K2f" else 0.0)).astype(np.float32)
    w = rng.normal(0.0, k ** -0.5, (k, n)).astype(np.float32)
    jy, jgamma, jbeta = map(jnp.asarray, (y, gamma, beta))
    _, vjp = jax.vjp(lambda w_, r_: _jax_fused(jy, jgamma, jbeta, w_, r_),
                     jnp.asarray(w), jnp.asarray(res))
    jdw, jgt = vjp(jnp.asarray(g))
    ty, tres, tg, tw = map(torch.tensor, (y, res, g, w))
    if kernel == "K2f":
        mean, var = _stats(ty)
        s = torch.tensor(gamma) * torch.rsqrt(var + EPS)
        z = fm._z(ty, s, torch.tensor(beta) - mean * s, tres)
        assert bool((z > 0).all())  # gt is the bare product g @ W^T
        return _tf32_product(tg, tw.t(), passes), jgt
    mean, var = _stats(ty)
    s = torch.tensor(gamma) * torch.rsqrt(var + EPS)
    a = torch.clamp_min(fm._z(ty, s, torch.tensor(beta) - mean * s, tres), 0.0)
    return _tf32_product(a.t(), tg, passes), jdw


@pytest.mark.parametrize("kernel,m,k,n", [
    ("K2f", 64, 32, 256), ("K2f", 64, 32, 512), ("K2f", 64, 32, 1024), ("K2f", 64, 32, 2048),
    ("K3f", 20000, 16, 32)])
def test_3xtf32_product_meets_jax_f32_bar(kernel, m, k, n):
    got, want = _tf32_case(kernel, m, k, n, passes=3)
    assert _rel(want, got) < REL, f"{kernel}: rel err {_rel(want, got)}"


@pytest.mark.parametrize("kernel,m,k,n", [("K2f", 64, 32, 2048), ("K3f", 20000, 16, 32)])
def test_one_tf32_pass_misses_jax_f32_bar(kernel, m, k, n):
    got, want = _tf32_case(kernel, m, k, n, passes=1)
    assert _rel(want, got) > 10 * REL, f"{kernel}: rel err {_rel(want, got)}"


def _k1f_case(m, k, n, passes):
    """(emulated K1f, JAX's forward, max over elements of |err| / (atol +
    rtol |JAX's|)) at [m, k] x [k, n]: one chain per 32-deep stage."""
    y, _, gamma, beta, w = _inputs((m,), k, n, seed=11)
    w = w * (10 * k ** -0.5)  # the model's init scale, out ~ 1
    want = np.asarray(_jax_fused(*map(jnp.asarray, (y, gamma, beta, w))))
    ty, tw = torch.tensor(y), torch.tensor(w)
    mean, var = _stats(ty)
    s = torch.tensor(gamma) * torch.rsqrt(var + EPS)
    a = torch.clamp_min(fm._z(ty, s, torch.tensor(beta) - mean * s, None), 0.0)
    got = torch.zeros(m, n)
    for k0 in range(0, k, 32):
        got = got + _tf32_product(a[:, k0:k0 + 32], tw[k0:k0 + 32], passes)
    share = np.abs(got.numpy() - want) / (1e-5 + 1e-5 * np.abs(want))
    return got, want, float(share.max())


@pytest.mark.parametrize("k,n", [(64, 256), (128, 512), (256, 1024), (512, 2048)])
def test_k1f_3xtf32_meets_jax_elementwise_bar(k, n):
    got, want, share = _k1f_case(64, k, n, passes=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert share < 0.5  # with room: the tensor cores' truncated sums add to this


def test_k1f_one_tf32_pass_misses_jax_elementwise_bar():
    _, _, share = _k1f_case(64, 512, 2048, passes=1)
    assert share > 10, f"worst element at {share} of the bar"


def test_tf32_split_rounds_as_cvt_rna():
    # Ties away from zero; the low 13 bits of both halves are zero.
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -11 - 2 ** -23, 3.0])
    hi, lo = fm.tf32_split(x)
    assert hi.tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0, 3.0]
    assert torch.equal(lo, fm.tf32_split(x - hi)[0])
    for v in (hi, lo):
        assert not (v.view(torch.int32) & 0x1FFF).any()
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    hi, lo = fm.tf32_split(r)
    assert ((r - hi - lo).abs() <= r.abs() * 2.0 ** -21).all()
