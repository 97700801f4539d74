"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card and nvcc; every test skips without a card. The
machine with the card has no JAX, and ``tests/conftest.py`` imports it, so
this file imports neither and is run there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

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
# f32: its f32 tolerance (:23).
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 128, True), (64, 192, 64, True), (96, 96, 128, False),
    (32, 32, 64, True),
])
def test_flash_kernel_matches_plain_version(cuda, dtype, atol, sq, sk, d, causal):
    def mk(s):
        return torch.randn(2, 4, s, d, generator=cuda, device="cuda", dtype=dtype)

    q, k, v = mk(sq), mk(sk), mk(sk)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_reference(q, k, v, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol


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
