"""The port's ring-attention MoE LM against the JAX package's, on 2 gloo ranks.

JAX accepts ``TransformerLM(ffn="moe", attention="ring")``: its program
sees the whole ``[b, S]`` batch (ring attention is a ``shard_map`` over the
``sp`` mesh inside it), so the MoE routes every token of the batch in
row-major order, at the capacity of ``b * S`` tokens, with the aux term of
the whole batch. The port's ranks each hold ``[b, S/2]``. In f32 (the CPU
parity; in bf16 near-ties flip experts between any two implementations):

- routing: every token's expert, its place in its expert's queue and the
  dropped set equal JAX's, read off JAX's own router logits
  (``capture_intermediates``) with the top-1 margin asserted above f32
  rounding, at a capacity that binds and where rank-major placement (the
  data-parallel order) would keep another set;
- the loss with the aux term at 1e-4 and every parameter's gradient,
  summed over the ranks, at 1e-4 (``tests/test_ring_transformer.py:141``);
- one ``LMTask(aux_loss_weight=0.01)`` step against JAX's ``LMTask`` under
  ``optax.adam``: ``train_loss`` (the objective with aux) at rtol 1e-5 and
  the update within 1e-3 of lr where the gradient is sure, by the rules of
  ``tests/test_torch_lm_train.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
from dss_ml_at_scale_tpu.models import collect_aux_loss as jax_aux
from dss_ml_at_scale_tpu.models import next_token_loss as jax_ntl
from dss_ml_at_scale_tpu.parallel.trainer import LMTask as JaxLMTask
from dss_ml_at_scale_tpu_torch.models import lm_state_from_flax
from torch_ranks import run_ranks

KW = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=64)
E, CF, W, LR = 4, 1.0, 0.01, 3e-4

_RANK = r'''
import torch.distributed as dist
from dss_ml_at_scale_tpu_torch.models import TransformerLM, collect_aux_loss, moe
from dss_ml_at_scale_tpu_torch.parallel import LMTask, sequence_shard, sharded_next_token_loss

g = dist.group.WORLD
routes = []
_route = moe.route


def spy(*a, **k):
    r = _route(*a, **k)
    routes.append({"expert": r.expert.clone(), "position": r.position.clone(),
                   "kept": r.kept.clone(), "capacity": r.capacity})
    return r


moe.route = spy
state = {k[3:]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("lm.")}
kw = dict(**args["lm"], dtype=torch.float32, attention="ring", group=g, ffn="moe",
          num_experts=args["e"], capacity_factor=args["cf"], device="cpu")
model = TransformerLM(**kw)
model.load_state_dict(state)
tokens = torch.from_numpy(inputs["tokens"]).long()
share = sharded_next_token_loss(model(sequence_shard(tokens, g)), tokens, g)
aux = collect_aux_loss(model)
(share + args["w"] * aux / world).backward()
out["routes"] = routes[:]
loss = share.detach().clone()
dist.all_reduce(loss)
aux_sum = aux.detach().clone()
dist.all_reduce(aux_sum)
grads = {}
for n, p in model.named_parameters():
    t = p.grad.clone()
    dist.all_reduce(t)
    grads[n] = t
out.update(ce=float(loss), aux=float(aux_sum) / world, grads=grads)

model = TransformerLM(**kw)
model.load_state_dict(state)
task = LMTask(model=model, learning_rate=args["lr"], aux_loss_weight=args["w"])
out["layout"] = task.layout
out["metrics"] = {k: float(v) for k, v in task.train_step({"tokens": tokens}).items()}
out["step_grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
out["after"] = {n: p.detach().clone() for n, p in model.named_parameters()}
'''


def _router_logits(inter, block: int) -> np.ndarray:
    out = inter["intermediates"][f"block_{block}"]["moe"]["router"]["__call__"]
    return np.asarray(out[0], np.float64)


def _places(expert: np.ndarray, order: np.ndarray, capacity: int) -> np.ndarray:
    """Kept flags when the tokens queue in ``order`` (indices into ``expert``)."""
    one_hot = np.eye(E)[expert[order]]
    pos = ((np.cumsum(one_hot, 0) - 1) * one_hot).sum(-1)
    kept = np.empty(len(expert), bool)
    kept[order] = pos < capacity
    return kept


@pytest.fixture(scope="module")
def ring_moe(tmp_path_factory):
    rng = np.random.default_rng(5)
    b, s = 2, KW["max_seq"]
    tokens = rng.integers(0, KW["vocab_size"], (b, s)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    jm = JaxLM(**KW, dtype=jnp.float32, attention="ring", mesh=mesh, axis_name="sp",
               ffn="moe", num_experts=E, capacity_factor=CF)
    jt = jnp.asarray(tokens)
    jtask = JaxLMTask(model=jm, aux_loss_weight=W)
    state0 = jtask.init_state(jax.random.key(0), {"tokens": tokens})
    params = state0.params

    def objective(p):
        logits, inter = jm.apply({"params": p}, jt, mutable=["intermediates"])
        ce = jax_ntl(logits, jt)
        aux = jax_aux(inter["intermediates"])
        return ce + W * aux, (ce, aux)

    (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
    _, inter = jm.apply({"params": params}, jt, capture_intermediates=True,
                        mutable=["intermediates"])
    logits = [_router_logits(inter, i) for i in range(KW["num_layers"])]

    state1, jmetrics = jax.jit(jtask.train_step)(state0, {"tokens": jt})

    inputs = {"tokens": tokens, **{f"lm.{k}": v.numpy()
                                   for k, v in lm_state_from_flax(params).items()}}
    ranks = run_ranks(tmp_path_factory.mktemp("ring_moe"), _RANK, 2, inputs,
                      {"lm": KW, "e": E, "cf": CF, "w": W, "lr": LR})
    return dict(tokens=tokens, loss=float(loss), ce=float(ce), aux=float(aux),
                grads=lm_state_from_flax(grads), logits=logits, ranks=ranks,
                state1=state1, jmetrics=jmetrics, before=lm_state_from_flax(params))


def _global_order(b: int, s: int, world: int) -> list[np.ndarray]:
    """Each rank's tokens (row-major over its [b, s/world] shard) as
    indices of the global row-major [b, s] batch."""
    local = s // world
    return [(np.arange(b)[:, None] * s + k * local + np.arange(local)[None, :]).reshape(-1)
            for k in range(world)]


def test_ring_moe_routes_the_global_batch_as_jax(ring_moe):
    r = ring_moe
    b, s = r["tokens"].shape
    orders = _global_order(b, s, 2)
    capacity = max(1, math.ceil(b * s * CF / E))
    apart = []
    for block, logits in enumerate(r["logits"]):
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-5, block  # no near-tie in f32
        expert = logits.argmax(-1)
        one_hot = np.eye(E)[expert]
        position = ((np.cumsum(one_hot, 0) - 1) * one_hot).sum(-1)
        kept = position < capacity
        assert not kept.all(), block  # the capacity binds
        apart.append(not np.array_equal(_places(expert, np.concatenate(orders), capacity),
                                        kept))
        for rank, out in enumerate(r["ranks"]):
            got = out["routes"][block]
            idx = orders[rank]
            assert got["capacity"] == capacity
            np.testing.assert_array_equal(got["expert"].numpy(), expert[idx], err_msg=str(block))
            np.testing.assert_array_equal(got["position"].numpy(), position[idx].astype(np.int64))
            np.testing.assert_array_equal(got["kept"].numpy(), kept[idx])
    # The data-parallel (rank-major) order would keep another set: the
    # test tells the two orders apart.
    assert any(apart)


def test_ring_moe_loss_with_aux_matches_jax(ring_moe):
    r = ring_moe
    for out in r["ranks"]:
        np.testing.assert_allclose(out["ce"], r["ce"], atol=1e-4)
        np.testing.assert_allclose(out["aux"], r["aux"], atol=1e-4)
        np.testing.assert_allclose(out["ce"] + W * out["aux"], r["loss"], atol=1e-4)


def test_ring_moe_gradients_match_jax(ring_moe):
    r = ring_moe
    for out in r["ranks"]:
        assert set(out["grads"]) == set(r["grads"])
        for name, want in r["grads"].items():
            np.testing.assert_allclose(out["grads"][name].numpy(), want.numpy(), atol=1e-4,
                                       err_msg=name)
        for i in range(KW["num_layers"]):
            for name in (f"blocks.{i}.qkv.weight", f"blocks.{i}.moe.w_up"):
                assert out["grads"][name].abs().max() > 0, name


def test_ring_moe_lm_task_step_matches_optax(ring_moe):
    r = ring_moe
    want = lm_state_from_flax(r["state1"].params)
    for key in ("train_loss", "train_ppl", "grad_norm"):
        for out in r["ranks"]:
            np.testing.assert_allclose(out["metrics"][key], float(r["jmetrics"][key]),
                                       rtol=1e-5, err_msg=key)
    for out in r["ranks"]:
        assert out["layout"] == "sequence"
        np.testing.assert_allclose(out["metrics"]["train_loss"], r["loss"], rtol=1e-5)
        for name, g in out["step_grads"].items():
            before = r["before"][name]
            d_port, d_jax = out["after"][name] - before, want[name] - before
            ulp = 2 * torch.finfo(torch.float32).eps * before.abs()
            assert (d_port.abs() <= LR * (1 + 1e-3) + ulp).all(), name
            sure = g.abs() > 1e-3 * g.abs().max()
            assert ((d_port - d_jax).abs() <= 1e-3 * LR + ulp)[sure].all(), name
    for name, p in r["ranks"][0]["after"].items():
        assert torch.equal(p, r["ranks"][1]["after"][name]), name
