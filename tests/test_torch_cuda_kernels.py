"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card and nvcc; every test skips without a card. The
machine with the card has no JAX, and ``tests/conftest.py`` imports it, so
this file imports neither and is run there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
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
# head_dim 8 (full_stack.json's lm), 16 and 48 run zero-padded to 32/32/64.
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 4, 128, 128, 128, True), (2, 4, 64, 192, 64, True), (2, 4, 96, 96, 128, False),
    (2, 4, 32, 32, 64, True), (1, 8, 128, 128, 128, True), (1, 8, 512, 512, 128, True),
    (1, 8, 1024, 1024, 128, True), (1, 8, 256, 1024, 128, True),
    (2, 4, 128, 128, 32, True), (2, 4, 96, 96, 32, False), (2, 4, 64, 192, 32, True),
    (1, 8, 1024, 1024, 32, True), (8, 8, 2048, 2048, 128, True),
    (1, 4, 24, 24, 8, True), (1, 4, 128, 128, 8, True), (8, 4, 24, 24, 8, True),
    (1, 4, 24, 24, 16, True), (1, 4, 128, 128, 16, True), (2, 4, 96, 96, 48, False),
])
def test_flash_kernel_matches_plain_version(cuda, dtype, atol, b, h, sq, sk, d, causal):
    def mk(s):
        return torch.randn(b, h, s, d, generator=cuda, device="cuda", dtype=dtype)

    q, k, v = mk(sq), mk(sk), mk(sk)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
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
    for tile in (64, 128):
        for with_res in (0, 1):
            assert lib.dsst_bn_relu_matmul_bwd_da_smem_bytes(tile, with_res) > 48 * 1024
            assert lib.dsst_bn_relu_matmul_bwd_dw_smem_bytes(tile, with_res) > 48 * 1024
    q = torch.randn(1, 2, 128, 128, generator=cuda, device="cuda", dtype=torch.bfloat16)
    out = flash_attention(q, q, q, causal=True)  # raises if the launch is refused
    outs = [out]
    for k, with_res in ((512, True), (512, False), (64, True)):
        y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, 300, k, 256, with_res)
        outs += [fm.bn_relu_matmul_fwd(y, s, t, w, res),
                 *fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res),
                 fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)]
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in outs)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    # Heads up to 128 are padded to a tile; wider ones are refused.
    q = torch.randn(1, 2, 64, 160, generator=cuda, device="cuda", dtype=torch.bfloat16)
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


def _fused_inputs(gen, m, k, n, with_res):
    def randn(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
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


# K1 out at the bf16 tolerance of tests/test_fused_matmul.py:203; gt, the
# sums and dW to one bf16 spacing (2^-7) of the plain result's max-abs.
# M, K and N on and off K1's 128 x 256 x 64 tile edges.
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("n", [200, 256, 2048])
@pytest.mark.parametrize("k", [64, 72, 512])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 4133])
def test_fused_matmul_kernels_match_plain_versions(cuda, m, k, n, with_res):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res)
    before = (fm.bn_relu_matmul_fwd.launches, fm.bn_relu_matmul_bwd_da.launches,
              fm.bn_relu_matmul_bwd_dw.launches)
    out = fm.bn_relu_matmul_fwd(y, s, t, w, res)
    gt, sg, sgx = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    dw = fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)
    torch.cuda.synchronize()
    assert (fm.bn_relu_matmul_fwd.launches, fm.bn_relu_matmul_bwd_da.launches,
            fm.bn_relu_matmul_bwd_dw.launches) == tuple(b + 1 for b in before)
    ref = fm.bn_relu_matmul_fwd_reference(y, s, t, w, res)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.05, atol=0.15)
    rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res)
    for got, want in ((gt, rgt), (sg, rsg), (sgx, rsgx),
                      (dw, fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res))):
        # Of the plain result's max-abs, which is 0 where M = 1 makes the
        # batch statistics' x_hat 0.
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item()


def _check_backward(cuda, m, k, n, with_res):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res)
    gt, sg, sgx = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    dw = fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)
    torch.cuda.synchronize()
    rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res)
    rdw = fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res)
    for got, want in ((gt, rgt), (sg, rsg), (sgx, rsgx), (dw, rdw)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item()
    # The ReLU mask agrees bit for bit: gt is zero wherever the plain mask is
    # off, and nonzero wherever it is on and the plain gt is not near zero
    # (a sum may cancel to exactly zero in one summation order only).
    mask = fm._z(y, s, t, res) > 0
    assert not gt[~mask].any()
    big = mask & (rgt.float().abs() > 2.0 ** -7 * rgt.float().abs().max())
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


# K3's prologue rounds as the plain version does: with g the identity on its
# first rows, each entry of dW is one product, a * 1, so dW^T is a itself.
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [(256, 64, 256), (700, 136, 520), (2048, 512, 2048)])
def test_dw_prologue_is_the_plain_a_bit_for_bit(cuda, m, k, n, with_res):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res)
    rows = min(m, n)
    eye = torch.zeros(m, n, dtype=torch.bfloat16, device="cuda")
    eye[:rows, :rows] = torch.eye(rows, dtype=torch.bfloat16, device="cuda")
    dw = fm.bn_relu_matmul_bwd_dw(y, s, t, eye, res)
    torch.cuda.synchronize()
    a = torch.clamp_min(fm._z(y, s, t, res), 0.0).to(torch.bfloat16).float()
    assert torch.equal(dw[:, :rows].t(), a[:rows])


# K2's ReLU mask is the plain version's bit for bit: with g and W positive,
# g @ W^T is positive everywhere (no sum cancels), so gt is nonzero exactly
# where the plain mask is on.
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("m,k,n", [(300, 64, 256), (1000, 264, 520), (2048, 512, 2048)])
def test_da_mask_is_the_plain_mask_bit_for_bit(cuda, m, k, n, with_res):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, m, k, n, with_res)
    gt = fm.bn_relu_matmul_bwd_da(g.abs(), w.abs(), y, s, t, mean, inv, res)[0]
    torch.cuda.synchronize()
    assert torch.equal(gt != 0, fm._z(y, s, t, res) > 0)


def test_fused_matmul_kernels_are_deterministic(cuda):
    # K2's walk gives each CTA several tiles (782 tiles on at most 132 CTAs);
    # K3 splits M over as many CTAs as the card has SMs.
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    assert fm.dw_plan(100000, 64, 256, sm_count)[0] > 100
    assert len(fm.da_tile_walk(100000, 64, 64, sm_count)[0]) > 3
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, 100000, 64, 256, True)
    first = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    again = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.equal(fm.bn_relu_matmul_bwd_dw(y, s, t, g, res),
                       fm.bn_relu_matmul_bwd_dw(y, s, t, g, res))


def test_fused_matmul_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    y, s, t, mean, inv, w, g, _ = _fused_inputs(cuda, 256, 64, 128, False)
    with pytest.raises(ValueError, match="bfloat16"):
        fm.bn_relu_matmul_fwd(y.float(), s, t, w.float())
    with pytest.raises(ValueError, match="contiguous"):
        fm.bn_relu_matmul_fwd(y.t().contiguous().t(), s, t, w)
    with pytest.raises(ValueError, match="float32"):
        fm.bn_relu_matmul_fwd(y, s.to(torch.bfloat16), t, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        fm.bn_relu_matmul_fwd(y[:, :60].contiguous(), s[:60].contiguous(), t[:60].contiguous(),
                              w[:60].contiguous())
    with pytest.raises(ValueError, match="channels-last"):
        fm.bn_relu_matmul(y.reshape(4, 8, 8, 64).transpose(1, 2), s, t, mean, inv * 0 + 1, w)


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
