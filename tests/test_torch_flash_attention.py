"""The port's flash attention vs the JAX package's (Pallas interpret on CPU).

The same numpy inputs go through ``dss_ml_at_scale_tpu.ops.flash_attention``
(the Pallas kernel in interpret mode, as ``tests/test_flash_attention.py``
runs it) and ``dss_ml_at_scale_tpu_torch.ops.flash_attention`` (its plain
version, which is what a CPU tensor takes). Tolerance: 2e-5 in f32, the
JAX package's own (``tests/test_flash_attention.py:23``). The CUDA kernel
itself is held against the plain version on the card by ``chip_smoke.py``
and by ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.ops import flash_attention as jax_flash
from dss_ml_at_scale_tpu_torch.ops import (
    BlockDivisibilityError,
    attention_reference,
    flash_attention,
)
from dss_ml_at_scale_tpu_torch.ops.flash_attention import check_kernel_inputs

ATOL = RTOL = 2e-5


def _qkv(rng, b=1, h=2, sq=128, sk=None, d=64):
    sk = sq if sk is None else sk
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32))


def _both(q, k, v, **kw):
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw).numpy()
    return got, want


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_kernel(rng, causal):
    q, k, v = _qkv(rng, sq=256)
    got, want = _both(q, k, v, causal=causal, block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_several_k_blocks_online_softmax(rng, causal):
    # 4 k-blocks on the JAX side: the running-max rescaling path.
    q, k, v = _qkv(rng, sq=256)
    got, want = _both(q, k, v, causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,h,s,d", [(1, 8, 128, 128), (2, 2, 64, 64),
                                     (1, 4, 192, 32), (3, 1, 128, 16)])
def test_shapes_causal(rng, b, h, s, d):
    q, k, v = _qkv(rng, b=b, h=h, sq=s, d=d)
    got, want = _both(q, k, v, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_causal_bottom_right_sq_lt_sk(rng):
    # Decode-with-cache shape: the last query row sees ALL keys.
    q, k, v = _qkv(rng, sq=64, sk=256, d=32)
    got, want = _both(q, k, v, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    s_last = q[0, 0, -1] @ k[0, 0].T / np.sqrt(32)
    p = np.exp(s_last - s_last.max())
    manual = (p / p.sum()) @ v[0, 0]
    np.testing.assert_allclose(got[0, 0, -1], manual, atol=ATOL, rtol=RTOL)


def test_non_causal_sq_gt_sk(rng):
    q, k, v = _qkv(rng, sq=128, sk=64, d=32)
    got, want = _both(q, k, v, block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_small_seq_block_clamp(rng):
    # seq < default blocks (256, 512): both clamp to seq.
    q, k, v = _qkv(rng, sq=48, d=32)
    got, want = _both(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_reference_matches_jax_reference(rng):
    from dss_ml_at_scale_tpu.ops import attention_reference as jax_reference

    q, k, v = _qkv(rng, sq=32, sk=96, d=16)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True))
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_rejects_ragged_seq(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, sq=100))
    with pytest.raises(BlockDivisibilityError, match="multiples"):
        flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="multiples"):
        jax_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                  jnp.asarray(v.numpy()), block_q=64, block_k=64)


def test_rejects_causal_sq_gt_sk(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, sq=64, sk=32))
    with pytest.raises(ValueError, match="sq <= sk") as err:
        flash_attention(q, k, v, causal=True)
    # Not the block contract's error: no caller may retry past it.
    assert not isinstance(err.value, BlockDivisibilityError)


def test_rejects_wrong_rank(rng):
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="batch, heads, seq, head_dim"):
        flash_attention(q, q, q)


def test_bf16_dtype_kept(rng):
    q, k, v = _qkv(rng, sq=128)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jax_flash(jnp.asarray(q, jnp.bfloat16),
                                jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), causal=True))
    # bf16 tolerance of tests/test_flash_attention.py:41.
    np.testing.assert_allclose(out.float().numpy(), want.astype(np.float32),
                               atol=2e-2)


def test_cpu_tensor_does_not_launch(rng):
    before = flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, sq=64))
    flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before == 0


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "contiguous", "mixed_dtype"])
def test_kernel_input_checks(bad):
    shape = (1, 2, 64, 64)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k = torch.zeros(shape, dtype=torch.bfloat16)
    v = torch.zeros(shape, dtype=torch.bfloat16)
    check_kernel_inputs(q, k, v)  # the kernel's own shape passes
    if bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 2, 64, 96, dtype=torch.bfloat16) for _ in range(3))
    elif bad == "contiguous":
        k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16).transpose(2, 3)
    else:
        v = v.float()
    with pytest.raises(ValueError):
        check_kernel_inputs(q, k, v)
