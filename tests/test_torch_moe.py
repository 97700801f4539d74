"""The port's MoE layer and MoE LM against the JAX package's.

- ``MoEMLP`` in f32 against flax's on the same weights and input: the
  routing and the dropped set equal (the router's top-1 margin asserted
  above f32 rounding), outputs at atol 1e-5
  (``tests/test_pipeline_moe.py:173, :212``); in bf16 at 0.05 (``:444-446``);
  the aux loss at 1e-5; one expert equals the dense MLP, and the capacity
  is a ceiling (``:161-195, :240-256``); router noise jitters only when
  asked (``:215-237``).
- The index dispatch bit-equal to the dense one-hot plain version
  (:func:`moe_dense_reference`), outputs and routing, in f32 and bf16.
- The full MoE LM's logits in f32 (1e-5) and bf16 (0.05); one ``LMTask``
  step with the aux loss against JAX's ``LMTask(aux_loss_weight=0.01)``
  under ``optax.adam``, by the rules of ``tests/test_torch_lm_train.py``
  (metrics rtol 1e-5, Adam's moments within 5e-4 of max-abs, the update
  within 1e-3 of lr), and the eval step without the aux term.
- The seeded init: the expert kernels' spread is flax ``lecun_normal``'s
  for a 3-D kernel (fan-in ``E * d``), biases zero.
- Two gloo ranks against JAX on the whole batch, routing over both ranks'
  tokens at a capacity that binds only globally: each rank's outputs,
  the ranks' mean aux loss, and the DDP-averaged gradients (1e-5), with
  the experts' compute replicated and split (E = 4 over 2 ranks: each rank
  runs 2).
- ``lm --ffn moe`` on the CPU, and on 2 ranks through ``--coordinator``.
"""

import contextlib
import io
import json
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.models import MoEMLP as JaxMoE
from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
from dss_ml_at_scale_tpu.models import collect_aux_loss as jax_aux
from dss_ml_at_scale_tpu.parallel.trainer import LMTask as JaxLMTask
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.models import (
    MoEMLP,
    TransformerLM,
    collect_aux_loss,
    init_lm_state,
    lm_state_from_flax,
    moe_dense_reference,
)
from dss_ml_at_scale_tpu_torch.models.moe import route
from dss_ml_at_scale_tpu_torch.parallel import LMTask
from torch_ranks import run_ranks

KW = dict(vocab_size=64, dim=32, num_heads=2, num_layers=2, max_seq=32)
LR = 3e-4


def _moe_state(params) -> dict[str, torch.Tensor]:
    p = jax.tree_util.tree_map(np.asarray, params)
    out = {"router.weight": torch.from_numpy(np.array(p["router"]["kernel"].T, np.float32))}
    for k in ("w_up", "b_up", "w_down", "b_down"):
        out[k] = torch.from_numpy(np.array(p[k], np.float32))
    return out


def _pair(e=4, cf=1.0, dtype=jnp.float32, tdtype=torch.float32, shape=(2, 16, 8), seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jm = JaxMoE(num_experts=e, mlp_ratio=2, capacity_factor=cf, dtype=dtype)
    variables = jm.init(jax.random.key(seed), jnp.asarray(x))
    tm = MoEMLP(shape[-1], e, mlp_ratio=2, capacity_factor=cf, dtype=tdtype, device="cpu")
    tm.load_state_dict(_moe_state(variables["params"]))
    return jm, variables, tm, x


def _jax_routing(variables, x, e, cf):
    """Expert, kept and the top-1 margin, from JAX's own router logits."""
    tokens = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = np.asarray(tokens @ variables["params"]["router"]["kernel"], np.float64)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    expert = logits.argmax(-1)
    one_hot = np.eye(e)[expert]
    pos = ((np.cumsum(one_hot, 0) - 1) * one_hot).sum(-1)
    cap = max(1, math.ceil(len(expert) * cf / e))
    return expert, pos < cap, float((top2[:, 1] - top2[:, 0]).min())


@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_moe_f32_matches_jax_with_equal_routing(cf):
    jm, variables, tm, x = _pair(cf=cf)
    want, inter = jm.apply(variables, jnp.asarray(x), mutable=["intermediates"])
    expert, kept, margin = _jax_routing(variables, x, 4, cf)
    assert margin > 1e-5  # far above f32 rounding of O(1) logits
    tokens = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    r = route(tokens, tm.router.weight, 4, cf)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    if cf == 1.0:
        assert not kept.all()  # the capacity binds: some tokens are dropped
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(tm.aux_loss), float(jax_aux(inter["intermediates"])),
                               atol=1e-5)


def test_moe_bf16_matches_jax():
    jm, variables, tm, x = _pair(cf=2.0, dtype=jnp.bfloat16, tdtype=torch.bfloat16, seed=7)
    want, _ = jm.apply(variables, jnp.asarray(x), mutable=["intermediates"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.05, rtol=0.05)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_index_dispatch_bit_equal_to_dense_one_hot(dtype, cf):
    _, _, tm, x = _pair(e=4, cf=cf, tdtype=dtype, shape=(2, 32, 16), seed=3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = tm(xt)
        computed = tm.computed_experts
        tokens = xt.reshape(-1, xt.shape[-1])
        r = route(tokens, tm.router.weight, tm.num_experts, tm.capacity_factor)
        want = moe_dense_reference(tokens, r, tm).reshape(xt.shape)
    assert torch.equal(got, want)
    assert torch.equal(r.aux_loss, tm.aux_loss) and computed == (0, 4)


def test_moe_single_expert_equals_dense_mlp():
    _, variables, tm, x = _pair(e=1, cf=2.0)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    tokens = x.reshape(-1, x.shape[-1])
    ref = (np.asarray(jax.nn.gelu(tokens @ p["w_up"][0] + p["b_up"][0]))
           @ p["w_down"][0] + p["b_down"][0]).reshape(x.shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_moe_combine_weights_and_capacity():
    _, _, tm, x = _pair(e=4, cf=4.0, shape=(1, 32, 8), seed=1)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert torch.isfinite(out).all()
    assert float(collect_aux_loss(tm)) >= 0.99  # Switch aux loss: >= 1 at balance
    _, _, tight, _ = _pair(e=4, cf=0.25, shape=(1, 32, 8), seed=2)
    with torch.no_grad():
        assert torch.isfinite(tight(torch.from_numpy(x))).all()


def test_moe_capacity_ceil():
    # 10 tokens, 4 experts, cf 1.0 -> C = ceil(2.5) = 3; zeroed router logits
    # tie-break to expert 0, so exactly 3 tokens survive.
    _, _, tm, x = _pair(e=4, cf=1.0, shape=(1, 10, 8), seed=5)
    with torch.no_grad():
        tm.router.weight.zero_()
        out = tm(torch.from_numpy(x))
    assert int((out[0].abs().sum(-1) > 1e-12).sum()) == 3


def test_router_noise_reachable_through_lm():
    lm = TransformerLM(**{**KW, "num_layers": 1, "max_seq": 16}, dtype=torch.float32,
                       attention="reference", ffn="moe", num_experts=4, router_noise=5.0,
                       device="cpu")
    lm.load_state_dict(init_lm_state(lm, 0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (1, 16)))

    def fwd(seed, det):
        with torch.no_grad():
            return lm(tokens, deterministic=det, generator=torch.Generator().manual_seed(seed))

    assert not torch.allclose(fwd(1, False), fwd(2, False)), "router noise had no effect"
    assert torch.equal(fwd(1, True), fwd(2, True))
    with pytest.raises(ValueError, match="generator"):
        lm(tokens, deterministic=False)


def _lm_pair(dtype=jnp.float32, tdtype=torch.float32, e=4):
    tokens = np.random.default_rng(0).integers(0, 64, (4, 32)).astype(np.int32)
    jm = JaxLM(**KW, dtype=dtype, attention="reference", ffn="moe", num_experts=e)
    params = jm.init(jax.random.key(0), jnp.asarray(tokens))
    tm = TransformerLM(**KW, dtype=tdtype, attention="reference", ffn="moe", num_experts=e,
                       device="cpu")
    tm.load_state_dict(lm_state_from_flax(params))
    return jm, params, tm, tokens


def _routed_lm(dtype, tdtype, cf, batch, monkeypatch):
    """JAX's and the port's MoE LM logits on one batch, and each block's
    expert choices in both."""
    import dss_ml_at_scale_tpu_torch.models.moe as port_moe

    seen = []
    real = port_moe.route
    monkeypatch.setattr(port_moe, "route", lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    tokens = np.random.default_rng(0).integers(0, 64, (batch, 32)).astype(np.int32)
    jm = JaxLM(**KW, dtype=dtype, attention="reference", ffn="moe", num_experts=4,
               capacity_factor=cf)
    params = jm.init(jax.random.key(0), jnp.asarray(tokens))
    want, inter = jm.apply(params, jnp.asarray(tokens), capture_intermediates=True,
                           mutable=["intermediates"])
    tm = TransformerLM(**KW, dtype=tdtype, attention="reference", ffn="moe", num_experts=4,
                       capacity_factor=cf, device="cpu")
    tm.load_state_dict(lm_state_from_flax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    inter = inter["intermediates"]
    routers = [np.asarray(inter[f"block_{i}"]["moe"]["router"]["__call__"][0], np.float64)
               for i in range(KW["num_layers"])]
    experts = [(r.argmax(-1).reshape(batch, -1), t.expert.numpy().reshape(batch, -1))
               for r, t in zip(routers, seen)]
    margin = min(float(np.diff(np.sort(r, -1)[:, -2:], axis=-1).min()) for r in routers)
    return got.numpy(), np.asarray(want), experts, margin, float(jax_aux(inter)), tm


def test_moe_lm_logits_match_jax_f32(monkeypatch):
    got, want, experts, margin, aux, tm = _routed_lm(jnp.float32, torch.float32, 1.25, 4,
                                                     monkeypatch)
    assert margin > 1e-5
    for j, t in experts:
        np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(collect_aux_loss(tm)), aux, atol=1e-5)


def test_moe_lm_logits_match_jax_bf16(monkeypatch):
    # In bf16 the two frameworks' activations differ by roundings, which
    # flip a top-1 choice where the router's margin is below them, and a
    # flipped token changes its row's later attention. With room for every
    # token (no drops) the rows are independent: where a row is routed
    # alike in every block its logits agree at the bf16 tolerance.
    got, want, experts, _, _, _ = _routed_lm(jnp.bfloat16, torch.bfloat16, 4.0, 8, monkeypatch)
    alike = np.ones(8, bool)
    for j, t in experts:
        assert (j == t).mean() >= 0.99
        alike &= (j == t).all(axis=-1)
    assert alike.sum() >= 6
    np.testing.assert_allclose(got[alike], want[alike], atol=0.05, rtol=0.05)


def test_moe_generate_and_prefill_route_the_prompt():
    # The cached passes (prefill and decode) run the MoE too, as in JAX.
    jm, params, tm, tokens = _lm_pair()
    from dss_ml_at_scale_tpu.models import generate as jax_generate
    from dss_ml_at_scale_tpu_torch.models import generate

    want = np.asarray(jax_generate(jm, params, jnp.asarray(tokens[:1, :6]), 8))
    got = generate(tm, torch.from_numpy(tokens[:1, :6]).long(), 8).numpy()
    np.testing.assert_array_equal(got, want)


def _port(tree) -> dict[str, torch.Tensor]:
    return lm_state_from_flax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def moe_stepped():
    tokens = np.random.default_rng(0).integers(0, 64, (4, 32)).astype(np.int32)
    jm = JaxLM(**KW, dtype=jnp.float32, attention="reference", ffn="moe", num_experts=4)
    jtask = JaxLMTask(model=jm, aux_loss_weight=0.01)
    state0 = jtask.init_state(jax.random.key(0), {"tokens": tokens})
    tm = TransformerLM(**KW, dtype=torch.float32, attention="reference", ffn="moe",
                       num_experts=4, device="cpu")
    tm.load_state_dict(_port(state0.params))
    task = LMTask(model=tm, learning_rate=LR, aux_loss_weight=0.01)
    state1, jmetrics = jax.jit(jtask.train_step)(state0, {"tokens": tokens})
    val = np.random.default_rng(1).integers(0, 64, (4, 32)).astype(np.int32)
    jeval = jax.jit(jtask.eval_step)(state1, {"tokens": val})
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tmetrics = task.train_step({"tokens": torch.from_numpy(tokens)})
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    teval = task.eval_step({"tokens": torch.from_numpy(val)})
    # The objective recomputed: next-token loss + 0.01 * sum of aux.
    with torch.no_grad():
        from dss_ml_at_scale_tpu_torch.models import next_token_loss

        fresh = TransformerLM(**KW, dtype=torch.float32, attention="reference", ffn="moe",
                              num_experts=4, device="cpu")
        fresh.load_state_dict(before)
        t = torch.from_numpy(tokens)
        objective = float(next_token_loss(fresh(t), t) + 0.01 * collect_aux_loss(fresh))
    return dict(state1=state1, jmetrics=jmetrics, jeval=jeval, task=task, before=before,
                grads=grads, tmetrics=tmetrics, teval=teval, objective=objective)


def test_lm_task_with_aux_metrics_match_jax(moe_stepped):
    s = moe_stepped
    for key in ("train_loss", "train_ppl", "grad_norm"):
        np.testing.assert_allclose(float(s["tmetrics"][key]), float(s["jmetrics"][key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(s["tmetrics"]["train_loss"]), s["objective"], rtol=1e-6)
    for key in ("val_loss", "val_ppl"):  # no aux term in eval, as JAX's
        np.testing.assert_allclose(float(s["teval"][key]), float(s["jeval"][key]),
                                   rtol=1e-5, err_msg=key)


def test_lm_task_with_aux_adam_moments_and_update_match_jax(moe_stepped):
    s = moe_stepped
    adam = s["state1"].opt_state[0]
    mu, nu = _port(adam.mu), _port(adam.nu)
    task = s["task"]
    for name, p in task.model.named_parameters():
        st = task.optimizer.state[p]
        for got, want in ((st["exp_avg"], mu[name]), (st["exp_avg_sq"], nu[name])):
            err = (got - want).abs().max().item() / (want.abs().max().item() + 1e-30)
            assert err < 5e-4, f"{name}: moment rel err {err}"
    got, want, before = task.model.state_dict(), _port(s["state1"].params), s["before"]
    for name, g in s["grads"].items():
        d_port, d_jax = got[name] - before[name], want[name] - before[name]
        ulp = 2 * torch.finfo(torch.float32).eps * before[name].abs()
        assert (d_port.abs() <= LR * (1 + 1e-3) + ulp).all(), name
        sure = g.abs() > 1e-3 * g.abs().max()
        assert ((d_port - d_jax).abs() <= 1e-3 * LR + ulp)[sure].all(), name


def test_seeded_init_matches_flax_expert_fan_in():
    lm = TransformerLM(vocab_size=64, dim=64, num_heads=2, num_layers=1, max_seq=16,
                       ffn="moe", num_experts=8, device="cpu")
    state = init_lm_state(lm, 0)
    init = fnn.initializers.lecun_normal()
    for name, shape in (("w_up", (8, 64, 256)), ("w_down", (8, 256, 64))):
        want = float(np.std(np.asarray(init(jax.random.key(0), shape))))
        got = float(state[f"blocks.0.moe.{name}"].std())
        assert abs(got / want - 1) < 0.02, (name, got, want)
        assert abs(want * math.sqrt(shape[0] * shape[1]) - 1) < 0.02
    router = float(state["blocks.0.moe.router.weight"].std())
    assert abs(router * math.sqrt(64) - 1) < 0.1
    for name in ("b_up", "b_down"):
        assert not state[f"blocks.0.moe.{name}"].any()


_RANK_MOE = r'''
import torch.distributed as dist
from dss_ml_at_scale_tpu_torch.models import MoEMLP

x, cot = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["cot"])
rows = slice(rank * x.shape[0] // world, (rank + 1) * x.shape[0] // world)
for shard in (False, True):
    moe = MoEMLP(x.shape[-1], int(args["e"]), mlp_ratio=2, capacity_factor=args["cf"],
                 dtype=torch.float32, device="cpu")
    moe.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in inputs.items()
                         if k.startswith("moe.")})
    xr = x[rows].clone().requires_grad_()
    y = moe(xr, group=dist.group.WORLD, shard_experts=shard)
    tokens = y.shape[0] * y.shape[1]
    objective = (y * cot[rows]).sum() / tokens + 0.1 * moe.aux_loss
    objective.backward()
    grads = {}
    for n, p in moe.named_parameters():  # DDP's mean
        g = p.grad.clone()
        dist.all_reduce(g)
        grads[n] = g / world
    out[shard] = {"y": y.detach(), "aux": float(moe.aux_loss), "grads": grads,
                  "x_grad": xr.grad.clone(), "experts": moe.computed_experts}
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    e, cf = 4, 1.0
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 8, 8)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jm = JaxMoE(num_experts=e, mlp_ratio=2, capacity_factor=cf, dtype=jnp.float32)
    variables = jm.init(jax.random.key(3), jnp.asarray(x))

    def objective(params, x):
        y, inter = jm.apply({"params": params}, x, mutable=["intermediates"])
        return jnp.sum(y * cot) / (x.shape[0] * x.shape[1]) + 0.1 * jax_aux(
            inter["intermediates"]), (y, jax_aux(inter["intermediates"]))

    (_, (y, aux)), (g_params, g_x) = jax.value_and_grad(objective, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    expert, kept, margin = _jax_routing(variables, x, e, cf)
    local = [_jax_routing(variables, x[2 * r:2 * r + 2], e, cf)[1] for r in range(2)]
    inputs = {"x": x, "cot": cot, **{f"moe.{k}": v.numpy()
                                     for k, v in _moe_state(variables["params"]).items()}}
    ranks = run_ranks(tmp_path_factory.mktemp("moe2"), _RANK_MOE, 2, inputs,
                      {"e": e, "cf": cf})
    return dict(y=np.asarray(y), aux=float(aux), g_params=_moe_state(g_params),
                g_x=np.asarray(g_x), ranks=ranks, kept=kept, local_kept=local, margin=margin)


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "expert_sharded"])
def test_two_ranks_route_the_global_batch_as_jax(two_ranks, shard):
    t = two_ranks
    assert t["margin"] > 1e-5
    # The capacity binds only over the whole batch: routing each rank's
    # tokens alone would keep a different set.
    assert not t["kept"].all()
    assert not np.array_equal(np.concatenate(t["local_kept"]), t["kept"])
    for r, out in enumerate(t["ranks"]):
        np.testing.assert_allclose(out[shard]["y"].numpy(), t["y"][2 * r:2 * r + 2], atol=1e-5)
        # Each rank's objective is its tokens' mean: its input gradient is
        # world x the whole batch's.
        np.testing.assert_allclose(out[shard]["x_grad"].numpy() / 2, t["g_x"][2 * r:2 * r + 2],
                                   atol=1e-5)
        assert out[shard]["experts"] == ((2 * r, 2 * r + 2) if shard else (0, 4))
    np.testing.assert_allclose(np.mean([o[shard]["aux"] for o in t["ranks"]]), t["aux"],
                               atol=1e-5)
    for name, want in t["g_params"].items():
        for out in t["ranks"]:
            np.testing.assert_allclose(out[shard]["grads"][name].numpy(), want.numpy(),
                                       atol=1e-5, err_msg=name)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0, buf.getvalue()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


_LM = ["lm", "--vocab", "32", "--dim", "32", "--heads", "2", "--layers", "1", "--seq", "16",
       "--batch-size", "4", "--steps-per-epoch", "2", "--epochs", "1",
       "--limit-val-batches", "1", "--ffn", "moe", "--num-experts", "4"]


def test_lm_cli_moe_trains_on_the_cpu(tmp_path):
    got = _run(_LM + ["--device", "cpu", "--sample", "4", "--checkpoint-dir",
                      str(tmp_path / "ck")])
    assert got["steps"] == 2 and len(got["sample_tokens"]) == 8
    assert all(np.isfinite(got[k]) for k in ("train_loss", "val_loss"))


_RANK_CLI = r'''
import contextlib, io
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.models.moe import MoEMLP
runtime.shutdown_distributed()  # the command joins its own group
os.environ.update(NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
seen = []
forward = MoEMLP.forward
def spy(self, x, **kw):
    y = forward(self, x, **kw)
    seen.append((kw.get("group") is not None, kw.get("shard_experts"), self.computed_experts))
    return y
MoEMLP.forward = spy
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli.main(args["argv"] + ["--coordinator", f"file://{work}/rdzv2"]) == 0
out["summary"] = json.loads(buf.getvalue().strip().splitlines()[-1])
out["seen"] = seen
'''


def test_lm_cli_moe_two_ranks_split_the_experts(tmp_path):
    ranks = run_ranks(tmp_path, _RANK_CLI, 2,
                      args={"argv": _LM + ["--device", "cpu", "--no-tracking"]})
    for r, out in enumerate(ranks):
        assert out["summary"]["process_count"] == 2 and out["summary"]["steps"] == 2
        assert (True, True, (2 * r, 2 * r + 2)) in out["seen"]
    assert ranks[0]["summary"]["train_loss"] == ranks[1]["summary"]["train_loss"]
