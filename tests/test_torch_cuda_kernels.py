"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card and nvcc; every test skips without a card. The
machine with the card has no JAX, and ``tests/conftest.py`` imports it, so
this file imports neither and is run there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The fused-matmul cases run in bf16 (K1-K3) and in f32 (K1f-K3f); a
``-k float32`` run takes the f32 ones alone.
"""

import importlib

import pytest
import torch

from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm
from dss_ml_at_scale_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# bf16: the JAX package's bf16 tolerance (tests/test_flash_attention.py:41);
# f32: its f32 tolerance (:23). The serving buckets (b1 h8 d128 causal,
# 128/512/1024) and sq < sk take the split path in bf16 on an H100; b8 h8
# s2048 d128 is the LM training shape; head_dim 32 is the lm CLI's default;
# head_dim 8 (full_stack.json's lm), 16 and 48 run zero-padded to 32/32/64;
# above 128 bf16 takes the wide kernel (160 zero-padded to 192; 192, 256 and
# 320 as they are; 320 and 512 in slices of 256; 640 with too few K slots
# for turns; 1024 with Q carried by the K slots), at b1 h1 s1024 d256 and
# b1 h1 s2048 d512 with its key-split plan; f32 takes the f32 kernel at
# every shape.
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 4, 128, 128, 128, True), (2, 4, 64, 192, 64, True), (2, 4, 96, 96, 128, False),
    (2, 4, 32, 32, 64, True), (1, 8, 128, 128, 128, True), (1, 8, 512, 512, 128, True),
    (1, 8, 1024, 1024, 128, True), (1, 8, 256, 1024, 128, True),
    (2, 4, 128, 128, 32, True), (2, 4, 96, 96, 32, False), (2, 4, 64, 192, 32, True),
    (1, 8, 1024, 1024, 32, True), (8, 8, 2048, 2048, 128, True),
    (1, 4, 24, 24, 8, True), (1, 4, 128, 128, 8, True), (8, 4, 24, 24, 8, True),
    (1, 4, 24, 24, 16, True), (1, 4, 128, 128, 16, True), (2, 4, 96, 96, 48, False),
    (2, 4, 128, 128, 192, True), (2, 4, 96, 96, 192, False), (1, 8, 1024, 1024, 256, True),
    (2, 4, 64, 192, 256, True), (1, 4, 256, 256, 512, True), (2, 2, 96, 96, 512, False),
    (1, 1, 1024, 1024, 256, True), (1, 1, 2048, 2048, 512, True),
    (2, 4, 128, 128, 160, True), (2, 4, 96, 96, 160, False), (1, 8, 256, 256, 320, True),
    (2, 2, 96, 96, 320, False), (1, 2, 64, 192, 320, True), (1, 2, 256, 256, 640, True),
    (1, 2, 128, 128, 1024, True),
])
def test_flash_kernel_matches_plain_version(cuda, dtype, atol, b, h, sq, sk, d, causal):
    def mk(s):
        return torch.randn(b, h, s, d, generator=cuda, device="cuda", dtype=dtype)

    q, k, v = mk(sq), mk(sk), mk(sk)
    before = (flash_attention.launches, flash_attention.launches_wide,
              flash_attention.launches_f32)
    out = flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    torch.cuda.synchronize()
    wide, f32 = dtype == torch.bfloat16 and d > 128, dtype == torch.float32
    assert (flash_attention.launches, flash_attention.launches_wide,
            flash_attention.launches_f32) == (before[0] + 1, before[1] + wide, before[2] + f32)
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_reference(q, k, v, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.parametrize("sq,sk", [(128, 128), (512, 512), (1024, 1024), (256, 1024)])
def test_flash_split_path_is_deterministic_and_matches_unsplit(cuda, sq, sk):
    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    q = torch.randn(1, 8, sq, 128, generator=cuda, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(1, 8, sk, 128, generator=cuda, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    first = flash_attention(q, k, v, causal=True)
    again = flash_attention(q, k, v, causal=True)
    whole = fa._launch(q, k, v, True, split=False)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    ref = attention_reference(q, k, v, causal=True).float()
    for out in (first, whole):
        assert (out.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("b,h,s,d", [(1, 1, 1024, 256), (1, 1, 1024, 320), (1, 1, 2048, 512),
                                     (1, 2, 1024, 192)])
def test_flash_wide_split_path_is_deterministic_and_matches_unsplit(cuda, b, h, s, d):
    """The wide kernel's key-split plan (128-row tiles; each consumer's rows
    combined in a fixed order) is the same bit for bit from run to run."""
    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fa.split_plan(b * h * fa.launch_slices(d), s, s, True, sm_count, **fa.plan_tiling(d))
    assert plan is not None and plan[1]
    q, k, v = (torch.randn(b, h, s, d, generator=cuda, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    first = flash_attention(q, k, v, causal=True)
    again = flash_attention(q, k, v, causal=True)
    whole = fa._launch(q, k, v, True, split=False)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    ref = attention_reference(q, k, v, causal=True).float()
    for out in (first, whole):
        assert (out.float() - ref).abs().max().item() <= 2e-2


# The Function's backward (the chunked recompute) against autograd through
# the plain version, in bf16: 2e-2 of max-abs, the forward's bf16 tolerance.
@pytest.mark.parametrize("b,h,s,d", [(2, 4, 128, 32), (2, 4, 512, 64), (1, 4, 1024, 128),
                                     (8, 8, 2048, 128), (2, 4, 2048, 32), (8, 4, 24, 8)])
def test_flash_gradients_match_autograd_through_reference(cuda, b, h, s, d):
    def leaves():
        torch.manual_seed(s + d)
        return [torch.randn(b, h, s, d, device="cuda", dtype=torch.bfloat16).requires_grad_()
                for _ in range(3)]

    g = torch.randn(b, h, s, d, generator=cuda, device="cuda", dtype=torch.bfloat16)
    q, k, v = leaves()
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1  # the backward launches no forward
    rq, rk, rv = leaves()
    attention_reference(rq, rk, rv, causal=True).backward(g)
    for got, want in ((q.grad, rq.grad), (k.grad, rk.grad), (v.grad, rv.grad)):
        assert got.dtype == torch.bfloat16 and got.abs().max().item() > 0
        assert _rel(got, want) <= 2e-2
    del q, k, v, rq, rk, rv, out
    torch.cuda.empty_cache()


def test_lm_training_grads_through_kernel_match_reference(cuda):
    """Every block's qkv gradient reaches the kernel's caller: nonzero and
    within 5e-2 of max-abs of the reference-attention model's."""
    from dss_ml_at_scale_tpu_torch.models import next_token_loss, seeded_lm

    kw = dict(vocab_size=512, dim=256, num_heads=2, num_layers=2, max_seq=256)
    flash = seeded_lm(0, device="cuda", attention="flash", **kw)
    ref = seeded_lm(0, device="cuda", attention="reference", **kw)
    tokens = torch.randint(0, 512, (2, 256), generator=cuda, device="cuda")
    before = flash_attention.launches
    for model in (flash, ref):
        next_token_loss(model(tokens), tokens).backward()
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    for fb, rb in zip(flash.blocks, ref.blocks):
        assert fb.qkv.weight.grad.abs().max().item() > 0
        assert _rel(fb.qkv.weight.grad, rb.qkv.weight.grad) <= 5e-2


def test_kernels_opt_in_to_more_than_48kb_of_shared_memory(cuda):
    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    assert fa._kernel().dsst_flash_attention_smem_bytes(128) > 48 * 1024
    lib = fm._kernel()
    assert lib.dsst_bn_relu_matmul_fwd_smem_bytes(512, 1) > 48 * 1024
    lib_f32 = fm._kernel_f32()
    for with_res in (0, 1):
        assert lib_f32.dsst_bn_relu_matmul_fwd_f32_smem_bytes(with_res) > 48 * 1024
    for tile in (64, 128):
        assert lib_f32.dsst_bn_relu_matmul_bwd_da_f32_smem_bytes(tile) > 48 * 1024
        for with_res in (0, 1):
            assert lib.dsst_bn_relu_matmul_bwd_da_smem_bytes(tile, with_res) > 48 * 1024
            assert lib.dsst_bn_relu_matmul_bwd_dw_smem_bytes(tile, with_res) > 48 * 1024
            assert lib_f32.dsst_bn_relu_matmul_bwd_dw_f32_smem_bytes(tile, with_res) > 48 * 1024
    q = torch.randn(1, 2, 128, 128, generator=cuda, device="cuda", dtype=torch.bfloat16)
    out = flash_attention(q, q, q, causal=True)  # raises if the launch is refused
    outs = [out]
    for k, with_res, dtype in ((512, True, torch.bfloat16), (512, False, torch.bfloat16),
                               (64, True, torch.bfloat16), (128, True, torch.float32),
                               (128, False, torch.float32), (64, True, torch.float32)):
        y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, 300, k, 256, with_res, dtype)
        outs += [fm.bn_relu_matmul_fwd(y, s, t, w, res),
                 *fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res),
                 fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)]
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in outs)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    # Every head of 1 or more is taken (padded to a tile, or above 128 to
    # column slices); an empty one is refused.
    q = torch.randn(1, 2, 64, 0, generator=cuda, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    h = torch.randn(1, 2, 64, 64, generator=cuda, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_attention(h, h, h)
    t = torch.randn(1, 64, 2, 64, generator=cuda, device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(t, t, t)


def test_lm_prefill_through_kernel_matches_reference(cuda):
    from dss_ml_at_scale_tpu_torch.models import seeded_lm

    model = seeded_lm(0, device="cuda", vocab_size=512, dim=256, num_heads=2,
                      num_layers=2, max_seq=256, attention="flash")
    tokens = torch.randint(0, 512, (2, 256), generator=cuda, device="cuda")
    before = flash_attention.launches
    with torch.inference_mode():
        got = model(tokens)
        ref = model(tokens, attention="reference")
    assert flash_attention.launches == before + 2  # one per layer
    assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


def test_generate_at_awkward_prompt_length_launches_the_kernel(cuda, monkeypatch):
    # 300 is no multiple of the clamped TPU block (256). On the card the
    # prefill retries through the kernel, never the plain version.
    from dss_ml_at_scale_tpu_torch.models import generate, seeded_lm, transformer

    def plain(*args, **kwargs):
        raise AssertionError("generate ran the plain version on the card")

    monkeypatch.setattr(transformer, "attention_reference", plain)
    model = seeded_lm(0, device="cuda", vocab_size=512, dim=256, num_heads=2,
                      num_layers=2, max_seq=512, attention="flash")
    prompt = torch.randint(0, 512, (1, 300), generator=cuda, device="cuda")
    before = flash_attention.launches
    out = generate(model, prompt, 4)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2  # one prefill, one per layer
    assert out.shape == (1, 304) and torch.equal(out[:, :300], prompt)
    assert int(out.min()) >= 0 and int(out.max()) < 512


def _fused_inputs(gen, m, k, n, with_res, dtype=torch.bfloat16):
    def randn(*shape, std=1.0, mean=0.0, dtype=dtype):
        return (torch.randn(*shape, generator=gen, device="cuda") * std + mean).to(dtype)

    y = randn(m, k)
    mean = y.float().mean(0)
    inv = torch.rsqrt(y.float().square().mean(0) - mean.square() + 1e-5)
    s = randn(k, mean=1.0, std=0.2, dtype=torch.float32) * inv
    t = randn(k, std=0.2, dtype=torch.float32) - mean * s
    return (y, s, t, mean, inv, randn(k, n, std=k ** -0.5), randn(m, n),
            randn(m, k) if with_res else None)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _launches():
    return tuple((f.launches, f.launches_f32) for f in
                 (fm.bn_relu_matmul_fwd, fm.bn_relu_matmul_bwd_da, fm.bn_relu_matmul_bwd_dw))


# bf16: K1 out at the bf16 tolerance of tests/test_fused_matmul.py:203; gt,
# the sums and dW to one bf16 spacing (2^-7) of the plain result's max-abs.
# f32 (K1f-K3f): out at rtol/atol 1e-5 (:76), gt, the sums and dW within
# 1e-5 of the plain result's max-abs (f32 sums in another order).
DTYPES = [pytest.param(torch.bfloat16, dict(rtol=0.05, atol=0.15), 2.0 ** -7, id="bfloat16"),
          pytest.param(torch.float32, dict(rtol=1e-5, atol=1e-5), 1e-5, id="float32")]
DTYPE_IDS = ["bfloat16", "float32"]


# M, K and N on and off K1's 128 x 256 x 64 tile edges and K1f's 128 x 128
# x 32 ones.
@pytest.mark.parametrize("dtype,out_tol,rel", DTYPES)
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("n", [200, 256, 2048])
@pytest.mark.parametrize("k", [64, 72, 512])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 4133])
def test_fused_matmul_kernels_match_plain_versions(cuda, m, k, n, with_res, dtype, out_tol, rel):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res, dtype)
    before = _launches()
    out = fm.bn_relu_matmul_fwd(y, s, t, w, res)
    gt, sg, sgx = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    dw = fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert _launches() == tuple((a + 1, b + f32) for a, b in before)
    ref = fm.bn_relu_matmul_fwd_reference(y, s, t, w, res)
    assert out.dtype == dtype and gt.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **out_tol)
    rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res)
    for got, want in ((gt, rgt), (sg, rsg), (sgx, rsgx),
                      (dw, fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res))):
        # Of the plain result's max-abs, which is 0 where M = 1 makes the
        # batch statistics' x_hat 0.
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rel * want.float().abs().max().item()


def _check_backward(cuda, m, k, n, with_res, dtype=torch.bfloat16, rel=2.0 ** -7):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res, dtype)
    gt, sg, sgx = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    dw = fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)
    torch.cuda.synchronize()
    rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res)
    rdw = fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res)
    for got, want in ((gt, rgt), (sg, rsg), (sgx, rsgx), (dw, rdw)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rel * want.float().abs().max().item()
    # The ReLU mask agrees bit for bit: gt is zero wherever the plain mask is
    # off, and nonzero wherever it is on and the plain gt is not near zero
    # (a sum may cancel to exactly zero in one summation order only).
    mask = fm._z(y, s, t, res) > 0
    assert not gt[~mask].any()
    big = mask & (rgt.float().abs() > rel * rgt.float().abs().max())
    assert gt[big].ne(0).all()


# K2 and K3 on and off their tile edges: K2's 128-row tiles and 64/128
# channel bands, K3's 64 x 256 / 128 x 256 tiles of dW and its 64-row ring
# stages. K = 64 with N = 256 is stage 1's single output tile of K3; K = 264
# leaves K2 a band with one 64-channel block wholly past K and K3 a tile
# with one; N = 264 leaves K3 a tile with three blocks past N.
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (1, 64, 256), (64, 64, 256), (65, 64, 256), (128, 128, 512), (129, 136, 264),
    (1000, 264, 520), (3000, 256, 1024), (257, 512, 2048), (8191, 72, 200),
])
def test_fused_backward_kernels_on_tile_edges(cuda, m, k, n, with_res):
    _check_backward(cuda, m, k, n, with_res)


# K3's runs of M: M = 64 q + r ends the last run inside a ring stage (rows
# past M zero-filled), and at M = 20000 the plan's runs of 192 rows end where
# a run of ceil(M / splits) = 152 rows would fall inside a stage.
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [(20000, 64, 256), (8485, 64, 256), (6437, 128, 512)])
def test_fused_backward_kernels_on_split_edges(cuda, m, k, n, with_res):
    splits, chunk = fm.dw_plan(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
    assert splits > 1 and chunk % 64 == 0
    _check_backward(cuda, m, k, n, with_res)


# K2f and K3f (3xTF32 wgmma) on their edges, held to the f32 bar: K2f's
# 128-row tiles, 64/128-channel bands and 32-deep stages (N = 200 ends inside
# one); K3f's 32-row stages (M off 32 and off K2f's 128), the transposed a^T
# staging at K = 72 (a 128-channel tile with one 32-channel block wholly past
# K and one partly) and 136, its 128-column tiles at N = 200 and 264, and
# its runs of M (several runs from M = 6437 on, the last one short).
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (1, 4, 4), (31, 72, 200), (33, 72, 200), (127, 64, 256), (4133, 72, 200), (129, 136, 264),
    (6437, 128, 512), (20017, 64, 256), (20000, 72, 200), (257, 512, 2048),
])
def test_f32_backward_kernels_on_tf32_edges(cuda, m, k, n, with_res):
    if m > 4133:
        sm_count = torch.cuda.get_device_properties(0).multi_processor_count
        splits, chunk = fm.dw_plan(m, k, n, sm_count, torch.float32)
        assert splits > 1 and chunk % 32 == 0 and m % chunk
    _check_backward(cuda, m, k, n, with_res, torch.float32, 1e-5)


# K1f (3xTF32 wgmma) on its edges, held to JAX's f32 bar element by element
# (rtol/atol 1e-5, tests/test_fused_matmul.py:76): one row, and rows on and
# off its 64-row warpgroup blocks and 128-row tiles; K off its 32-deep stage
# (4, 36, 72, 136: a stage partly past K; 32 one whole stage) and at stage
# 4's 512; N off its 128-column tiles and its 32-column TMA stores (4, 132,
# 200) and at stage 4's 2048 (16 column bands a row tile).
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("n", [4, 128, 132, 200, 2048])
@pytest.mark.parametrize("k", [4, 32, 36, 72, 136, 512])
@pytest.mark.parametrize("m", [1, 63, 65, 129, 4133])
def test_k1f_on_its_edges(cuda, m, k, n, with_res):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res, torch.float32)
    before = _launches()[0]
    out = fm.bn_relu_matmul_fwd(y, s, t, w, res)
    torch.cuda.synchronize()
    assert _launches()[0] == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, fm.bn_relu_matmul_fwd_reference(y, s, t, w, res),
                               rtol=1e-5, atol=1e-5)


# K1f's prologue rounds as the plain version does: with W the identity each
# entry of out is one product, a * 1, which 3xTF32 takes as a_hi * 1 +
# a_hi * 0 + a_lo * 1: the sum of the plain a's two TF32 halves, exact in f32.
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k", [(256, 64), (700, 136), (2048, 512)])
def test_k1f_prologue_is_the_plain_a_bit_for_bit(cuda, m, k, with_res):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, k, with_res, torch.float32)
    out = fm.bn_relu_matmul_fwd(y, s, t, torch.eye(k, device="cuda"), res)
    torch.cuda.synchronize()
    hi, lo = fm.tf32_split(torch.clamp_min(fm._z(y, s, t, res), 0.0))
    assert torch.equal(out, hi + lo)


@pytest.mark.parametrize("with_res", [False, True])
def test_k1f_is_deterministic(cuda, with_res):
    # Stage 1's shape: 79 tiles on some of the 132 CTAs, each summed in a
    # fixed order (no atomics), so every run gives the same bits.
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    assert max(map(len, fm.fwd_tile_walk(664832, 256, sm_count, torch.float32))) > 1
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, 664832, 64, 256, with_res, torch.float32)
    first = fm.bn_relu_matmul_fwd(y, s, t, w, res)
    for _ in range(3):
        assert torch.equal(fm.bn_relu_matmul_fwd(y, s, t, w, res), first)


# K3's prologue rounds as the plain version does: with g the identity on its
# first rows, each entry of dW is one product, a * 1, so dW^T is a itself.
# K3f (3xTF32) takes a * 1 as a_hi * 1 + a_hi * 0 + a_lo * 1: the sum of
# the plain a's two TF32 halves, exact in f32.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=DTYPE_IDS)
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [(256, 64, 256), (700, 136, 520), (2048, 512, 2048)])
def test_dw_prologue_is_the_plain_a_bit_for_bit(cuda, m, k, n, with_res, dtype):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res, dtype)
    rows = min(m, n)
    eye = torch.zeros(m, n, dtype=dtype, device="cuda")
    eye[:rows, :rows] = torch.eye(rows, dtype=dtype, device="cuda")
    dw = fm.bn_relu_matmul_bwd_dw(y, s, t, eye, res)
    torch.cuda.synchronize()
    a = torch.clamp_min(fm._z(y, s, t, res), 0.0).to(dtype).float()
    if dtype == torch.float32:
        hi, lo = fm.tf32_split(a)
        a = hi + lo
    assert torch.equal(dw[:, :rows].t(), a[:rows])


# K2's ReLU mask is the plain version's bit for bit: with g and W positive,
# g @ W^T is positive everywhere (no sum cancels), so gt is nonzero exactly
# where the plain mask is on.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=DTYPE_IDS)
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [(300, 64, 256), (1000, 264, 520), (2048, 512, 2048)])
def test_da_mask_is_the_plain_mask_bit_for_bit(cuda, m, k, n, with_res, dtype):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res, dtype)
    gt = fm.bn_relu_matmul_bwd_da(g.abs(), w.abs(), y, s, t, mean, inv, res)[0]
    torch.cuda.synchronize()
    assert torch.equal(gt != 0, fm._z(y, s, t, res) > 0)


@pytest.mark.parametrize("dtype,tiles_per_cta", [(torch.bfloat16, 3), (torch.float32, 2)],
                         ids=DTYPE_IDS)
def test_fused_matmul_kernels_are_deterministic(cuda, dtype, tiles_per_cta):
    # K2's walk gives each CTA several tiles (782 tiles on at most 132 CTAs,
    # K2f's too); K3 and K3f split M over as many CTAs as the card runs at
    # once (132 runs of K3's one tile, 66 of each of K3f's two).
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    assert len(fm.dw_work(100000, 64, 256, sm_count, dtype)) >= sm_count - 1
    walk = fm.da_tile_walk(100000, 64, 64, fm.cta_slots(sm_count, dtype))
    assert len(walk[0]) > tiles_per_cta
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, 100000, 64, 256, True, dtype)
    first = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    again = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.equal(fm.bn_relu_matmul_bwd_dw(y, s, t, g, res),
                       fm.bn_relu_matmul_bwd_dw(y, s, t, g, res))


def test_fused_matmul_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    y, s, t, mean, inv, w, g, _ = _fused_inputs(cuda, 256, 64, 128, False)
    # f32 is taken now (K1f); f16, which no path uses, and mixed types are not.
    with pytest.raises(ValueError, match="bfloat16 or float32 operands, got torch.float16"):
        fm.bn_relu_matmul_fwd(y.half(), s, t, w.half())
    with pytest.raises(ValueError, match="of one type"):
        fm.bn_relu_matmul_fwd(y.float(), s, t, w)
    with pytest.raises(ValueError, match="contiguous"):
        fm.bn_relu_matmul_fwd(y.t().contiguous().t(), s, t, w)
    with pytest.raises(ValueError, match="float32"):
        fm.bn_relu_matmul_fwd(y, s.to(torch.bfloat16), t, w)
    y60, w60 = y[:, :60].contiguous(), w[:60].contiguous()
    s60, t60 = s[:60].contiguous(), t[:60].contiguous()
    with pytest.raises(ValueError, match="multiples of 8"):
        fm.bn_relu_matmul_fwd(y60, s60, t60, w60)
    # The op takes K = 60, zero-padded to 64, through the kernels.
    before = _launches()
    y4 = y60.reshape(4, 8, 8, 60).requires_grad_()
    out = fm.bn_relu_matmul(y4, s60 * 0 + 1, t60 * 0, y60.float().mean(0),
                            y60.float().var(0, unbiased=False), w60)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert _launches() == tuple((a + 1, b) for a, b in before)
    assert out.shape == (4, 8, 8, 128) and y4.grad.shape == y4.shape
    with pytest.raises(ValueError, match="channels-last"):
        fm.bn_relu_matmul(y.reshape(4, 8, 8, 64).transpose(1, 2), s, t, mean, inv * 0 + 1, w)


def test_tiny_bottleneck_f32_train_step_launches_the_f32_kernels(cuda):
    """The f32 pallas level (JAX's test model, tests/test_fused_matmul.py:304)
    takes a train step through K1f-K3f: every launch is the f32 variant's."""
    from dss_ml_at_scale_tpu_torch.models import BottleneckBlock, seeded_resnet
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

    model = seeded_resnet(0, device="cuda", stage_sizes=[1, 1], block_cls=BottleneckBlock,
                          num_classes=10, num_filters=8, dtype=torch.float32,
                          fused_bn="pallas")
    with torch.no_grad():  # a nonzero last-BN scale lets the gradient reach K2f/K3f
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.fill_(0.5)
    task = ClassifierTask(model=model)
    batch = {"image": torch.randn(8, 32, 32, 3, generator=cuda, device="cuda"),
             "label": torch.randint(0, 10, (8,), generator=cuda, device="cuda")}
    before = _launches()
    metrics = task.train_step(batch)
    torch.cuda.synchronize()
    assert _launches() == tuple((a + 2, b + 2) for a, b in before)  # 2 blocks
    assert all(torch.isfinite(v) for v in metrics.values())
    assert model.layer1[0].conv3.weight.grad.abs().max() > 0


def test_tiny_bottleneck_train_step_launches_all_three_kernels(cuda):
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

    model = build_classifier_model("tiny-bottleneck", num_classes=10, torch_padding=False,
                                   fused_bn="pallas", device="cuda")
    with torch.no_grad():  # a nonzero last-BN scale lets the gradient reach K2/K3
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.fill_(0.5)
    task = ClassifierTask(model=model)
    batch = {"image": torch.randn(8, 32, 32, 3, generator=cuda, device="cuda"),
             "label": torch.randint(0, 10, (8,), generator=cuda, device="cuda")}
    before = (fm.bn_relu_matmul_fwd.launches, fm.bn_relu_matmul_bwd_da.launches,
              fm.bn_relu_matmul_bwd_dw.launches)
    metrics = task.train_step(batch)
    torch.cuda.synchronize()
    assert (fm.bn_relu_matmul_fwd.launches, fm.bn_relu_matmul_bwd_da.launches,
            fm.bn_relu_matmul_bwd_dw.launches) == tuple(b + 2 for b in before)  # 2 blocks
    assert all(torch.isfinite(v) for v in metrics.values())
    assert model.layer1[0].conv3.weight.grad.abs().max() > 0
