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
# 128/512/1024) and sq < sk take the split path in bf16 on an H100.
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 4, 128, 128, 128, True), (2, 4, 64, 192, 64, True), (2, 4, 96, 96, 128, False),
    (2, 4, 32, 32, 64, True), (1, 8, 128, 128, 128, True), (1, 8, 512, 512, 128, True),
    (1, 8, 1024, 1024, 128, True), (1, 8, 256, 1024, 128, True),
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


def test_kernels_opt_in_to_more_than_48kb_of_shared_memory(cuda):
    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    assert fa._kernel().dsst_flash_attention_smem_bytes(128) > 48 * 1024
    assert fm._kernel().dsst_bn_relu_matmul_fwd_smem_bytes(512, 1) > 48 * 1024
    q = torch.randn(1, 2, 128, 128, generator=cuda, device="cuda", dtype=torch.bfloat16)
    out = flash_attention(q, q, q, causal=True)  # raises if the launch is refused
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, 300, 512, 256, True)
    got = fm.bn_relu_matmul_fwd(y, s, t, w, res)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(got).all()


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 64, 96, generator=cuda, device="cuda", dtype=torch.bfloat16)
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


def test_fused_matmul_kernels_are_deterministic(cuda):
    y, s, t, mean, inv, w, g, res = _fused_inputs(cuda, 20000, 64, 256, True)
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
