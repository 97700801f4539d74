"""The port's ring attention and sequence-parallel LM against the JAX package's.

Ranks are gloo processes on the CPU (``torch_ranks``); the JAX side runs
in this process on a 2- or 4-device ``sp`` mesh of the conftest's CPU
devices. Tolerances are ``tests/test_ring_transformer.py``'s:

- ``ring_attention`` over 2 and 4 ranks against JAX's ``ring_attention``:
  outputs causal and not at 2e-5 (``:36``), the gradients of
  ``sum(out ** 2)`` at 1e-4 (``:53``), bf16 at 2e-2 (``:236-237``).
- The ring ``TransformerLM`` (f32) over 2 ranks, the sequence split
  32 + 32: the loss and every parameter's gradient (summed over the ranks)
  against the unsharded JAX model at 1e-4 (``:141``).
- A sequence-parallel ``Trainer.fit`` of an ``LMTask`` on a ring model
  learns as ``:144-195``'s: val_loss below 0.7 ln(vocab) and above the
  source's entropy floor less 0.05, the parameters equal on both ranks.
- What the ring refuses: decoding, a model without a group, a sequence the
  ranks do not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
from dss_ml_at_scale_tpu.models import next_token_loss as jax_ntl
from dss_ml_at_scale_tpu.parallel import ring_attention as jax_ring
from dss_ml_at_scale_tpu_torch.models import TransformerLM, generate, init_kv_cache
from dss_ml_at_scale_tpu_torch.models import lm_state_from_flax
from torch_ranks import run_ranks

LM_KW = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=64)

_RANK = r'''
import torch.distributed as dist
from dss_ml_at_scale_tpu_torch.parallel import ring_attention, sequence_shard
from dss_ml_at_scale_tpu_torch.parallel import sharded_next_token_loss

g = dist.group.WORLD
s_local = inputs["q"].shape[2] // world
part = slice(rank * s_local, (rank + 1) * s_local)
for causal in (False, True):
    qkv = [torch.from_numpy(inputs[n][:, :, part]).requires_grad_() for n in "qkv"]
    o = ring_attention(*qkv, group=g, causal=causal)
    (o ** 2).sum().backward()
    out[f"out_{causal}"] = o.detach()
    out[f"grads_{causal}"] = [t.grad for t in qkv]
try:
    sequence_shard(torch.zeros(1, 4 * world + 1), g)
except ValueError as e:
    out["indivisible"] = str(e)
bf = [torch.from_numpy(inputs[n][:, :, part]).to(torch.bfloat16) for n in "qkv"]
o = ring_attention(*bf, group=g, causal=True)
out["bf16"] = o
if args.get("lm"):
    from dss_ml_at_scale_tpu_torch.models import TransformerLM
    from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, token_batches
    from dss_ml_at_scale_tpu_torch.models import init_lm_state
    from dss_ml_at_scale_tpu_torch.parallel import LMTask, Trainer, TrainerConfig

    model = TransformerLM(**args["lm"], dtype=torch.float32, attention="ring", group=g,
                          device="cpu")
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in inputs.items()
                           if k.startswith("lm.")})
    tokens = torch.from_numpy(inputs["tokens"]).long()
    share = sharded_next_token_loss(model(sequence_shard(tokens, g)), tokens, g)
    share.backward()
    loss = share.detach().clone()
    dist.all_reduce(loss)
    grads = {}
    for n, p in model.named_parameters():
        t = p.grad.clone()
        dist.all_reduce(t)
        grads[n] = t
    out["lm_loss"], out["lm_grads"] = float(loss), grads

    stream = TokenStreamConfig(vocab_size=16, batch_size=4, seq_len=64, concentration=0.05,
                               seed=0)
    lm = TransformerLM(vocab_size=16, dim=32, num_heads=2, num_layers=1, max_seq=64,
                       dtype=torch.float32, attention="ring", group=g, device="cpu")
    lm.load_state_dict(init_lm_state(lm, 0))
    task = LMTask(model=lm, learning_rate=1e-2)
    trainer = Trainer(TrainerConfig(max_epochs=2, steps_per_epoch=40, limit_val_batches=2,
                                    log_every_steps=1000), device="cpu")
    result = trainer.fit(task, token_batches(stream),
                         val_data_factory=lambda: token_batches(stream, num_batches=2,
                                                                sample_seed=999))
    out["fit"] = {"history": result.history, "layout": task.layout,
                  "params": {n: p.detach().clone() for n, p in lm.named_parameters()}}
'''


def _qkv(rng, s=64, d=16):
    return {n: rng.normal(size=(1, 2, s, d)).astype(np.float32) for n in "qkv"}


def _jax_ring(inputs, world):
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    q, k, v = (jnp.asarray(inputs[n]) for n in "qkv")
    out = {}
    for causal in (False, True):
        def f(q, k, v, causal=causal):
            return jax_ring(q, k, v, mesh=mesh, axis_name="sp", causal=causal)

        out[f"out_{causal}"] = np.asarray(jax.jit(f)(q, k, v))
        out[f"grads_{causal}"] = [np.asarray(g) for g in jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(f(q, k, v) ** 2), argnums=(0, 1, 2)))(q, k, v)]
    bf = [t.astype(jnp.bfloat16) for t in (q, k, v)]
    out["bf16"] = np.asarray(jax.jit(lambda q, k, v: jax_ring(
        q, k, v, mesh=mesh, axis_name="sp", causal=True))(*bf), np.float32)
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = _qkv(rng)
    tokens = rng.integers(0, 64, (2, 64)).astype(np.int32)
    jm = JaxLM(**LM_KW, dtype=jnp.float32, attention="reference")
    params = jm.init(jax.random.key(0), jnp.asarray(tokens))

    def loss_fn(p):
        return jax_ntl(jm.apply(p, jnp.asarray(tokens)), jnp.asarray(tokens))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    inputs.update(tokens=tokens, **{f"lm.{k}": v.numpy()
                                    for k, v in lm_state_from_flax(params).items()})
    ranks = run_ranks(tmp_path_factory.mktemp("ring2"), _RANK, 2, inputs, {"lm": LM_KW})
    return dict(inputs=inputs, ranks=ranks, jax=_jax_ring(inputs, 2), loss=float(loss),
                grads=lm_state_from_flax(grads))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    inputs = _qkv(np.random.default_rng(1))
    ranks = run_ranks(tmp_path_factory.mktemp("ring4"), _RANK, 4, inputs)
    return dict(inputs=inputs, ranks=ranks, jax=_jax_ring(inputs, 4))


def _shards(ranks, key, index=None):
    parts = [r[key] if index is None else r[key][index] for r in ranks]
    return np.concatenate([p.float().numpy() for p in parts], axis=2)


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring(world, causal, request):
    r = request.getfixturevalue(world)
    np.testing.assert_allclose(_shards(r["ranks"], f"out_{causal}"), r["jax"][f"out_{causal}"],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("world", ["two", "four"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_ride_the_ring(world, causal, request):
    r = request.getfixturevalue(world)
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(_shards(r["ranks"], f"grads_{causal}", i),
                                   r["jax"][f"grads_{causal}"][i], atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("world", ["two", "four"])
def test_ring_attention_bf16(world, request):
    r = request.getfixturevalue(world)
    got = _shards(r["ranks"], "bf16")
    assert r["ranks"][0]["bf16"].dtype == torch.bfloat16
    np.testing.assert_allclose(got, r["jax"]["bf16"], atol=2e-2, rtol=2e-2)


def test_ring_lm_loss_and_gradients_match_unsharded_jax(two):
    for out in two["ranks"]:
        np.testing.assert_allclose(out["lm_loss"], two["loss"], atol=1e-4)
        for name, want in two["grads"].items():
            np.testing.assert_allclose(out["lm_grads"][name].numpy(), want.numpy(), atol=1e-4,
                                       err_msg=name)


def test_lm_sp_trains_under_trainer(two):
    from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, entropy_floor

    floor = entropy_floor(TokenStreamConfig(vocab_size=16, batch_size=4, seq_len=64,
                                            concentration=0.05, seed=0))
    fits = [r["fit"] for r in two["ranks"]]
    assert all(f["layout"] == "sequence" for f in fits)
    for f in fits:
        assert len(f["history"]) == 2
        assert f["history"][-1]["val_loss"] < 0.7 * np.log(16)
        assert f["history"][-1]["val_loss"] > floor - 0.05
    for name, p in fits[0]["params"].items():
        assert torch.equal(p, fits[1]["params"][name]), name


def test_ring_refusals(two, four):
    with pytest.raises(ValueError, match="needs group"):
        TransformerLM(**LM_KW, attention="ring", device="cpu")
    model = TransformerLM(**LM_KW, dtype=torch.float32, attention="reference", device="cpu")
    model.attention = "ring"  # a ring model, decoding
    with pytest.raises(ValueError, match="single-process"):
        model(torch.zeros(1, 1, dtype=torch.long), cache=init_kv_cache(model, 1), pos=0)
    with pytest.raises(ValueError, match="single-process"):
        generate(model, torch.zeros(1, 4, dtype=torch.long), 2)

    for r in (2, 4):  # a sequence the ranks do not divide
        assert "not divisible" in (two if r == 2 else four)["ranks"][0]["indivisible"]
