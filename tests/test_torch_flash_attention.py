"""The port's flash attention vs the JAX package's (Pallas interpret on CPU).

The same numpy inputs go through ``dss_ml_at_scale_tpu.ops.flash_attention``
(the Pallas kernel in interpret mode, as ``tests/test_flash_attention.py``
runs it) and ``dss_ml_at_scale_tpu_torch.ops.flash_attention`` (its plain
version, which is what a CPU tensor takes). Tolerance: 2e-5 in f32, the
JAX package's own (``tests/test_flash_attention.py:23``). The CUDA kernel
itself is held against the plain version on the card by ``chip_smoke.py``
and by ``tests/test_torch_cuda_kernels.py``.

The gradients: the port's autograd Function against ``jax.vjp`` of the JAX
function (its custom VJP, the chunked recompute), with the same numpy
cotangent: atol/rtol 1e-4 in f32 (the JAX test's gradient tolerance,
``tests/test_flash_attention.py:44-56``) and 2e-2 of the max-abs in bf16
(JAX sums the chunks' dk/dv in the transpose of its ``lax.map``, the port in
f32, cast once).
"""

import importlib

import jax
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

# The module (the package re-exports its function under the same name).
fa_mod = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")

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
        q, k, v = (torch.zeros(1, 2, 64, 160, dtype=torch.bfloat16) for _ in range(3))
    elif bad == "contiguous":
        k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16).transpose(2, 3)
    else:
        v = v.float()
    with pytest.raises(ValueError):
        check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("d", [8, 16, 48, 160])
def test_kernel_checks_take_every_head_dim_up_to_128(d):
    """Heads the kernel has no tile for are padded (8, 16 -> 32; 48 -> 64);
    above 128 the check raises with a message."""
    q, k, v = (torch.zeros(1, 2, 64, d, dtype=torch.bfloat16) for _ in range(3))
    if d > 128:
        with pytest.raises(ValueError, match="head_dim 1..128"):
            check_kernel_inputs(q, k, v)
        return
    check_kernel_inputs(q, k, v)
    assert fa_mod.padded_head_dim(d) == (32 if d <= 32 else 64)


# The bf16 kernel's split plan: the three serving buckets (b1 h8), sq < sk,
# non-causal, on cards of 1, 16 and 132 SMs.
PLAN_SHAPES = [(8, 128, 128, True), (8, 512, 512, True), (8, 1024, 1024, True),
               (8, 256, 1024, True), (8, 512, 512, False), (2, 96, 96, True)]


@pytest.mark.parametrize("sm_count", [1, 16, 132])
@pytest.mark.parametrize("bh,sq,sk,causal", PLAN_SHAPES)
def test_work_items_cover_every_visible_tile_once(bh, sq, sk, causal, sm_count):
    items = fa_mod.work_items(bh, sq, sk, causal, sm_count)
    n_kt = -(-sk // 64)
    want = set()
    for qt in range(-(-sq // 64)):  # 64-row query tiles, 64-key tiles
        last_row = min(qt * 64 + 64, sq) - 1
        for kt in range(n_kt):
            # A tile is visible when some row of the query tile sees its first key.
            if not causal or kt * 64 <= last_row + sk - sq:
                want.add((qt, kt))
    got = [(qt, kt) for qt, kb, ke, _ in items for kt in range(kb, ke)]
    assert len(got) == len(set(got)) and set(got) == want
    lengths = [ke - kb for _, kb, ke, _ in items]
    assert lengths == sorted(lengths, reverse=True)  # longest first
    plan = fa_mod.split_plan(bh, sq, sk, causal, sm_count)
    if plan is None:
        assert all(slot == -1 for *_, slot in items)
        return
    _, combine, n_slots = plan
    assert bh * -(-sq // 64) < sm_count  # the unsplit grid underfills the card
    assert bh * len(items) <= 2 * sm_count  # the pieces run in one wave, two CTAs per SM
    slots = sorted(slot for *_, slot in items if slot >= 0)
    assert slots == list(range(n_slots))
    for qt, first, pieces in combine:
        mine = sorted((slot, kb, ke) for q, kb, ke, slot in items if q == qt)
        assert [s for s, _, _ in mine] == list(range(first, first + pieces))
        assert mine[0][1] == 0 and all(a[2] == b[1] for a, b in zip(mine, mine[1:]))


def test_only_the_longest_serving_bucket_splits_on_an_h100():
    # 132 SMs: every bucket underfills the card, but only s1024's tiles
    # (up to 16 key tiles) are long enough for the split to pay.
    for s in (128, 512):
        assert fa_mod.split_plan(8, s, s, True, 132) is None
    items, combine, _ = fa_mod.split_plan(8, 1024, 1024, True, 132)
    assert combine and 8 * 16 < 8 * len(items) <= 2 * 132


@pytest.mark.parametrize("bh,sq,sk,causal", PLAN_SHAPES)
def test_split_and_combine_matches_reference(rng, bh, sq, sk, causal):
    plan = fa_mod.split_plan(bh, sq, sk, causal, 132)
    if plan is None:
        plan = (fa_mod.work_items(bh, sq, sk, causal, 132), [], 0)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, b=1, h=bh, sq=sq, sk=sk, d=32))
    got = fa_mod.split_attention_reference(q, k, v, causal=causal, plan=plan)
    want = attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sq,sk", [(1024, 1024), (256, 1024)])
def test_split_and_combine_matches_jax_kernel(rng, sq, sk):
    plan = fa_mod.split_plan(4, sq, sk, True, 132)
    assert plan is not None and plan[1]
    q, k, v = _qkv(rng, b=1, h=4, sq=sq, sk=sk, d=32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, block_q=128, block_k=128))
    got = fa_mod.split_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        plan=plan).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _jax_grads(q, k, v, g, **kw):
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]


def _port_grads(q, k, v, g, **kw):
    leaves = [torch.from_numpy(np.asarray(a)).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(np.asarray(g)))
    return [t.grad.float().numpy() for t in leaves]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_several_chunks(rng, causal, d):
    # block_q 64 at seq 256: four chunks in the backward on both sides.
    q, k, v = _qkv(rng, sq=256, d=d)
    g = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, block_q=64, block_k=64)
    for got, want in zip(_port_grads(q, k, v, g, **kw), _jax_grads(q, k, v, g, **kw)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_sq_lt_sk(rng, causal):
    q, k, v = _qkv(rng, sq=64, sk=256, d=32)
    g = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, block_q=32, block_k=64)
    for got, want in zip(_port_grads(q, k, v, g, **kw), _jax_grads(q, k, v, g, **kw)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d", [32, 128])
def test_gradients_match_jax_bf16(rng, d):
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(rng, sq=128, d=d))
    g = rng.normal(size=q.shape).astype(jnp.bfloat16)
    kw = dict(causal=True, block_q=64, block_k=64)
    tq, tk, tv, tg = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                      for a in (q, k, v, g))
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    flash_attention(*leaves, **kw).backward(tg)
    for t, want in zip(leaves, _jax_grads(q, k, v, g, **kw)):
        assert t.grad.dtype == torch.bfloat16
        err = np.abs(t.grad.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max()


def test_backward_holds_one_chunk_of_scores(rng):
    """Peak memory is O(chunk x sk): no tensor the backward makes is larger
    than one chunk's scores (sq x sk is four times that here)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    b, h, s, d, chunk = 1, 2, 256, 32, 64
    leaves = [torch.from_numpy(a).requires_grad_() for a in _qkv(rng, b=b, h=h, sq=s, d=d)]
    out = flash_attention(*leaves, causal=True, block_q=chunk, block_k=64)
    with Largest() as mode:
        out.backward(torch.ones_like(out))
    assert b * h * chunk * s >= mode.numel >= b * h * s * d
    assert mode.numel < b * h * s * s


def test_backward_is_the_recompute_not_the_forward(rng, monkeypatch):
    """The backward neither launches the kernel nor calls the forward's
    plain version, so ``launches`` counts forward launches only."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in _qkv(rng, sq=128, d=32)]
    before = flash_attention.launches
    out = flash_attention(*leaves, causal=True, block_q=64)

    def forbidden(*args, **kwargs):
        raise AssertionError("the backward ran the forward")

    monkeypatch.setattr(fa_mod, "_launch", forbidden)
    monkeypatch.setattr(fa_mod, "attention_reference", forbidden)
    out.sum().backward()
    assert flash_attention.launches == before
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in leaves)


def test_no_graph_under_inference_mode(rng):
    """Serving runs the Function with no autograd graph."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, sq=64, d=32))
    with torch.inference_mode():
        out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None and not out.requires_grad
