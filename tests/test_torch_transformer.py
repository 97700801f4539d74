"""The port's TransformerLM vs the JAX package's, on the same weights.

The flax parameters go through ``lm_state_from_flax`` into the port, the
same numpy tokens into both models, and logits are compared in f32 at
5e-4 (the tolerance of ``tests/test_ring_transformer.py:104``): full
forward under both attention backends, then prefill and every decode step
along JAX's own greedy token path, and the serving arena's batched
per-slot decode against JAX's vmapped ``slot_decode``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
from dss_ml_at_scale_tpu.models import transformer as jax_tf
from dss_ml_at_scale_tpu.serving.lm import kvcache as jax_kv
from dss_ml_at_scale_tpu_torch.models import (
    TransformerLM,
    generate,
    init_kv_cache,
    init_lm_state,
    lm_state_from_flax,
    next_token_loss,
    rms_norm,
    seeded_lm,
)
from dss_ml_at_scale_tpu_torch.models import transformer
from dss_ml_at_scale_tpu_torch.ops import BlockDivisibilityError
from dss_ml_at_scale_tpu_torch.serving.lm import kvcache

TOL = 5e-4
KW = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=64)


def _pair(attention="reference", **over):
    kw = {**KW, **over}
    jm = JaxLM(attention=attention, dtype=jnp.float32, **kw)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    tm = TransformerLM(attention=attention, dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(lm_state_from_flax(params))
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_converter_maps_every_param(pair):
    _, params, tm = pair
    state = lm_state_from_flax(params)
    assert set(state) == set(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert state[name].shape == t.shape, name
    # A flax kernel is [in, out]; a torch Linear weight [out, in].
    kernel = np.asarray(params["params"]["block_1"]["qkv"]["kernel"])
    np.testing.assert_array_equal(state["blocks.1.qkv.weight"].numpy(), kernel.T)


def test_converter_takes_flat_keys_and_rejects_leftovers(pair):
    _, params, _ = pair
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    assert set(lm_state_from_flax(flat)) == set(lm_state_from_flax(params))
    with pytest.raises(ValueError, match="not carried over"):
        lm_state_from_flax({**flat, "block_0/extra/kernel": np.zeros(3)})


@pytest.mark.parametrize("attention", ["flash", "reference"])
def test_full_forward_logits_match(rng, attention):
    jm, params, tm = _pair(attention)
    tokens = rng.integers(0, 64, (2, 64))
    want = np.asarray(jm.apply(params, jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.as_tensor(tokens)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("p", [1, 5, 8])
def test_prefill_then_decode_along_jax_greedy_path(rng, pair, p):
    jm, params, tm = pair
    prompt = rng.integers(0, 64, (1, p))
    j_cache = jax_tf.init_kv_cache(jm, 1)
    t_cache = init_kv_cache(tm, 1)
    j_logits, j_cache = jm.apply(params, jnp.asarray(prompt, jnp.int32),
                                 cache=j_cache, pos=0)
    with torch.no_grad():
        t_logits, t_cache = tm(torch.as_tensor(prompt), cache=t_cache, pos=0)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=TOL, rtol=TOL)
    last = np.asarray(j_logits if p == 1 else j_logits[:, -1])
    for i in range(6):
        tok = last.argmax(-1)[:, None]  # JAX's greedy token
        j_logits, j_cache = jax_tf.decode_step(
            jm, params, jnp.asarray(tok, jnp.int32), j_cache, p + i)
        with torch.no_grad():
            t_logits, t_cache = tm(torch.as_tensor(tok), cache=t_cache, pos=p + i)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   atol=TOL, rtol=TOL)
        last = np.asarray(j_logits)


@pytest.mark.parametrize("attention", ["flash", "reference"])
def test_greedy_generate_matches_jax(rng, attention):
    jm, params, tm = _pair(attention)
    prompt = rng.integers(0, 64, (2, 7))
    want = np.asarray(jax_tf.generate(jm, params, jnp.asarray(prompt, jnp.int32), 10))
    got = generate(tm, torch.as_tensor(prompt), 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_flash_retries_reference_at_awkward_prompt_length(rng):
    # 260 is no multiple of the clamped block (256): the flash prefill
    # raises and generate retries it with reference attention.
    jm, params, tm = _pair("flash", max_seq=512)
    prompt = rng.integers(0, 64, (1, 260))
    with pytest.raises(BlockDivisibilityError, match="multiples"):
        with torch.no_grad():
            tm(torch.as_tensor(prompt))
    want = np.asarray(jax_tf.generate(jm, params, jnp.asarray(prompt, jnp.int32), 3))
    got = generate(tm, torch.as_tensor(prompt), 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_retries_only_the_block_contract(monkeypatch):
    # Any other refusal of the flash call (on the card: a kernel-input
    # check) reaches the caller; nothing reruns it on the plain version.
    _, _, tm = _pair("flash")

    def refuse(*args, **kwargs):
        raise ValueError("flash kernel takes head_dim 64 or 128, got 8")

    def plain(*args, **kwargs):
        raise AssertionError("generate fell back to the plain version")

    monkeypatch.setattr(transformer, "flash_attention", refuse)
    monkeypatch.setattr(transformer, "attention_reference", plain)
    with pytest.raises(ValueError, match="head_dim"):
        generate(tm, torch.zeros(1, 8, dtype=torch.long), 2)


def test_one_block_flash_takes_any_length(rng):
    # The backend the card's retry uses: one block per sequence meets the
    # block contract at any length.
    jm, params, tm = _pair("flash", max_seq=512)
    prompt = rng.integers(0, 64, (1, 260))
    want = np.asarray(jm.clone(attention="reference").apply(
        params, jnp.asarray(prompt, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.as_tensor(prompt), attention="flash_one_block").numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_multi_token_cached_call_requires_pos_zero(pair):
    _, _, tm = pair
    cache = init_kv_cache(tm, 1)
    with pytest.raises(ValueError, match="prefill only"):
        tm(torch.zeros(1, 4, dtype=torch.long), cache=cache, pos=3)


def test_generate_caps_at_cache_capacity(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="preallocated KV-cache capacity"):
        generate(tm, torch.zeros(1, 30, dtype=torch.long), 40)


def test_n_tokens_zero_returns_prompt(pair):
    _, _, tm = pair
    prompt = torch.arange(5)[None]
    assert torch.equal(generate(tm, prompt, 0), prompt)


@pytest.mark.parametrize("kw,match", [
    # As JAX's transformer.py:90-91 and :57-58: MoE needs experts, the ring
    # a group to shard the sequence over.
    (dict(ffn="moe"), "num_experts >= 1"),
    (dict(attention="ring"), "needs group"),
    (dict(attention="bogus"), "unknown attention"),
])
def test_unported_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        TransformerLM(device="cpu", **{**KW, **kw})


def test_slot_decode_matches_jax_vmapped_slots(rng, pair):
    """The serving arena: two prompts prefilled into slots 0 and 1 of a
    3-slot arena, then one batched step with per-slot positions (slot 2
    inactive at position 0) — against JAX's vmapped slot_decode."""
    jm, params, tm = pair
    prompts = [rng.integers(0, 64, (1, 8)), rng.integers(0, 64, (1, 8))]
    j_arena = jax_kv.make_arena(jm, 3, 32)
    t_arena = kvcache.make_arena(tm, 3, 32)
    for slot, prompt in enumerate(prompts):
        _, j_rows = jax_kv.prefill_bucket(
            jm, params, jnp.asarray(prompt, jnp.int32), jax_kv.make_arena(jm, 1, 32))
        j_arena = jax_kv.write_slot(j_arena, j_rows, jnp.int32(slot))
        with torch.no_grad():
            _, t_rows = kvcache.prefill_bucket(
                tm, torch.as_tensor(prompt), kvcache.make_arena(tm, 1, 32))
        kvcache.write_slot(t_arena, t_rows, slot)
    tokens = np.array([3, 9, 0])
    pos = np.array([5, 8, 0])  # slot 0 rewinds into its prompt: any pos works
    j_logits, j_arena = jax_kv.slot_decode(
        jm, params, jnp.asarray(tokens, jnp.int32), j_arena,
        jnp.asarray(pos, jnp.int32))
    with torch.no_grad():
        t_logits, _ = kvcache.slot_decode(tm, torch.as_tensor(tokens), t_arena,
                                          torch.as_tensor(pos))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=TOL, rtol=TOL)
    # The step wrote each slot's k/v at its own position, in place.
    for layer in range(KW["num_layers"]):
        for kv in ("k", "v"):
            np.testing.assert_allclose(t_arena[layer][kv].numpy(),
                                       np.asarray(j_arena[layer][kv]),
                                       atol=TOL, rtol=TOL)


def test_rms_norm_matches_jax(rng):
    x = rng.normal(size=(3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jax_tf.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_next_token_loss_matches_jax(rng):
    logits = rng.normal(size=(2, 9, 64)).astype(np.float32)
    tokens = rng.integers(0, 64, (2, 9))
    want = float(jax_tf.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens)))
    assert abs(got - want) < 1e-5


def test_init_kv_cache_shape_and_dtype(pair):
    _, _, tm = pair
    cache = init_kv_cache(tm, 3)
    assert len(cache) == KW["num_layers"]
    assert cache[0]["k"].shape == (3, 4, 64, 8)
    assert cache[0]["v"].dtype == torch.float32


def test_seeded_init_is_deterministic():
    kw = dict(KW, dtype=torch.bfloat16)
    a = seeded_lm(3, device="cpu", **kw).state_dict()
    b = seeded_lm(3, device="cpu", **kw).state_dict()
    c = init_lm_state(TransformerLM(device="cpu", **kw), 4)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["blocks.0.qkv.weight"], c["blocks.0.qkv.weight"])
    assert torch.equal(a["blocks.0.norm1.scale"], torch.ones(KW["dim"]))


def test_bf16_model_emits_f32_logits(rng):
    tm = seeded_lm(0, device="cpu", dtype=torch.bfloat16, attention="flash", **KW)
    with torch.no_grad():
        logits = tm(torch.as_tensor(rng.integers(0, 64, (1, 16))))
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


DENSE = ("qkv.weight", "proj.weight", "mlp_up.weight", "mlp_down.weight", "lm_head.weight")


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_kernels_are_truncated_lecun_normal_like_flax(seed):
    """flax's ``lecun_normal``: a normal truncated at two deviations and
    rescaled by 1/0.87962566, so its std is 1/sqrt(fan_in): no entry beyond
    2 sigma (sigma the pre-truncation std), and the empirical std within 2%
    of 1/sqrt(fan_in). The token table stays an untruncated normal of std
    1/sqrt(vocab), as ``nn.Embed``."""
    kw = dict(vocab_size=512, dim=256, num_heads=4, num_layers=2, max_seq=64)
    state = init_lm_state(TransformerLM(device="cpu", **kw), seed)
    dense = [n for n in state if n.endswith(DENSE)]
    assert len(dense) == 4 * kw["num_layers"] + 1
    for name in dense:
        t = state[name].double()
        target = 1.0 / np.sqrt(t.shape[1])
        sigma = target / 0.87962566103423978
        assert t.abs().max().item() <= 2 * sigma, name
        assert abs(t.std().item() / target - 1.0) < 0.02, name
    emb = state["tok_embed.weight"].double()
    assert abs(emb.std().item() * np.sqrt(kw["vocab_size"]) - 1.0) < 0.02
    assert emb.abs().max().item() > 3.0 / np.sqrt(kw["vocab_size"])  # untruncated tails
