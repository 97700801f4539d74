"""The port's GPipe pipeline and PipelinedLM against the JAX package's.

Four gloo ranks on the CPU (``torch_ranks``) run every case in one go; the
JAX side runs in this process on meshes of the conftest's CPU devices.
Tolerances are ``tests/test_pipeline_moe.py``'s:

- ``spmd_pipeline`` on a 2 pipe x 2 data grid (PP x DP) against JAX's on a
  ``("pipe", "data")`` mesh of the same shape, with ``batch_axis="data"``:
  outputs at 1e-5 (``:66``), the stage gradients (averaged over the data
  column) at atol 1e-5 / rtol 1e-4 (``:89``).
- The micro-count edges (1, 3 and 8 microbatches through 4 stages) and a
  single stage, against the stages applied in sequence at 1e-5
  (``:451-473``).
- ``PipelinedLM`` over 4 stages against JAX's on the same weights and
  against the same blocks run in sequence, at 2e-5 (``:374-375``); one
  ``PipelinedLMTask`` step's gradients, stage and replicated, against
  ``jax.grad`` of JAX's task loss at atol 1e-5 / rtol 1e-4.
- ``PipelinedTask`` and ``PipelinedLMTask`` under the port's ``Trainer``
  learn as ``:292-345`` and ``:379-428`` do; each rank holds only its
  stage; the checkpoint holds the stages stacked ``[n_stages, ...]`` and
  restores each rank's slice.
- ``pipeline_utilization`` exactly (``:142-154``); ZeRO-1 refused; the
  stage-count collision guard.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dss_ml_at_scale_tpu.models import PipelinedLM as JaxPipelinedLM
from dss_ml_at_scale_tpu.models import PipelinedLMTask as JaxPipelinedLMTask
from dss_ml_at_scale_tpu.parallel import spmd_pipeline as jax_pipeline
from dss_ml_at_scale_tpu.parallel import stack_stage_params as jax_stack
from dss_ml_at_scale_tpu_torch.models import PipelinedLM, block_state_from_flax
from dss_ml_at_scale_tpu_torch.parallel import (
    PipeGrid,
    PipelinedTask,
    Trainer,
    TrainerConfig,
    pipeline_utilization,
    spmd_pipeline,
)
from torch_ranks import run_ranks

LM_KW = dict(vocab_size=32, dim=16, num_heads=2, max_seq=12)

_STAGE = r'''
def mlp_stage(p, x):
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def init_stage(seed, d=16, h=32):
    g = torch.Generator().manual_seed(seed)
    return {"w1": torch.randn(d, h, generator=g) * 0.3, "b1": torch.zeros(h),
            "w2": torch.randn(h, d, generator=g) * 0.3, "b2": torch.zeros(d)}
'''

_RANK = _STAGE + r'''
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.models import PipelinedLM, PipelinedLMTask
from dss_ml_at_scale_tpu_torch.models import init_pipelined_lm_state, rms_norm
from dss_ml_at_scale_tpu_torch.models.transformer import TransformerBlock, _select_attention
from dss_ml_at_scale_tpu_torch.parallel import PipelinedTask, Trainer, TrainerConfig
from dss_ml_at_scale_tpu_torch.parallel import pipe_grid, spmd_pipeline


def stage_params(prefix, stage):
    return {k[len(prefix):]: torch.from_numpy(v[stage]) for k, v in inputs.items()
            if k.startswith(prefix)}


# PP x DP: 2 stages x 2 columns.
grid = pipe_grid(2)
out["grid"] = (grid.stage, grid.column)
run = spmd_pipeline(mlp_stage, grid)
params = {k: v.requires_grad_() for k, v in stage_params("dp.", grid.stage).items()}
cols = slice(grid.column * 2, grid.column * 2 + 2)
xs, tgt = torch.from_numpy(inputs["xs"])[:, cols], torch.from_numpy(inputs["tgt"])[:, cols]
ys = run(params, xs)
torch.mean((ys - tgt) ** 2).backward()
grads = {}
for k, p in params.items():
    g = p.grad.clone()
    torch.distributed.all_reduce(g, group=grid.data_group)
    grads[k] = g / 2
out["dp"] = {"ys": ys.detach(), "grads": grads}

# 4 stages: the micro-count edges.
grid4 = pipe_grid(4)
run4 = spmd_pipeline(mlp_stage, grid4)
p4 = stage_params("edge.", grid4.stage)
out["edges"] = {m: run4(p4, torch.from_numpy(inputs[f"edge_xs{m}"])) for m in (1, 3, 8)}

# PipelinedLM over 4 stages, the JAX weights.
kw = args["lm"]
lm = PipelinedLM(**kw, grid=grid4, device="cpu")
state = {k: torch.from_numpy(inputs[f"lm.{k}"]) for k in ("tok", "pos", "norm_scale", "head")}
stacked = {k[len("lm.stages."):]: v for k, v in inputs.items() if k.startswith("lm.stages.")}
state.update({f"block.{k}": torch.from_numpy(v[grid4.stage]) for k, v in stacked.items()})
lm.load_state_dict(state)
tokens = torch.from_numpy(inputs["lm_tokens"]).long()
with torch.no_grad():
    out["lm_logits"] = lm(tokens)
if rank == 0:  # the same blocks in sequence, on one process
    with torch.no_grad():
        x = torch.nn.functional.embedding(tokens, lm.tok) + lm.pos[:tokens.shape[2]]
        for s in range(4):
            blk = TransformerBlock(kw["dim"], kw["num_heads"], dtype=torch.float32)
            blk.load_state_dict({k: torch.from_numpy(v[s]) for k, v in stacked.items()})
            x = blk(x.reshape(-1, *x.shape[2:]), _select_attention("reference")).reshape(x.shape)
        out["lm_sequential"] = rms_norm(x, lm.norm_scale) @ lm.head
task = PipelinedLMTask(lm, learning_rate=3e-4)
metrics = task.compute_update({"tokens": tokens})
out["lm_step"] = {"loss": float(metrics["train_loss"]),
                  "grads": {n: p.grad.clone() for n, p in lm.named_parameters()}}

# PipelinedTask under the Trainer, 2 x 2, with checkpoints and a resume.
def batches(seed, n):
    r = np.random.default_rng(seed)
    x = r.normal(size=(8, 4, 16)).astype(np.float32)
    for _ in range(n):
        yield {"x": x, "y": np.sin(x)}

ck = f"{work}/ck"
task = PipelinedTask(mlp_stage, init_stage, grid, learning_rate=3e-2, device="cpu")
result = Trainer(TrainerConfig(max_epochs=2, steps_per_epoch=40, limit_val_batches=2,
                               log_every_steps=1000, checkpoint_dir=ck), device="cpu").fit(
    task, batches(0, 80), val_data_factory=lambda: batches(99, 2))
util = [m["value"] for m in telemetry.snapshot()["metrics"] if m["name"] == "pipeline_utilization"]
trained = {n: p.detach().clone() for n, p in task.model.named_parameters()}
again = PipelinedTask(mlp_stage, init_stage, grid, learning_rate=3e-2, device="cpu")
resumed = Trainer(TrainerConfig(max_epochs=2, steps_per_epoch=40, checkpoint_dir=ck,
                                resume=True), device="cpu").fit(again, batches(0, 1))
out["task"] = {"history": result.history, "steps": result.steps, "params": trained,
               "utilization": util, "resumed_steps": resumed.steps,
               "restored": {n: p.detach().clone() for n, p in again.model.named_parameters()},
               "moments": {n: again.optimizer.state[p]["exp_avg"].clone()
                           for n, p in again.model.named_parameters()},
               "trained_moments": {n: task.optimizer.state[p]["exp_avg"].clone()
                                   for n, p in task.model.named_parameters()}}

# PipelinedLMTask under the Trainer, 4 stages.
from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, token_batches
stream = TokenStreamConfig(vocab_size=16, batch_size=8, seq_len=24, concentration=0.05, seed=0)

def micro(source):
    for b in source:
        yield {"tokens": b["tokens"].reshape(4, 2, 24)}

plm = PipelinedLM(vocab_size=16, dim=32, num_heads=2, grid=grid4, max_seq=24, device="cpu")
plm.load_state_dict(init_pipelined_lm_state(plm, 0))
result = Trainer(TrainerConfig(max_epochs=2, steps_per_epoch=50, limit_val_batches=2,
                               log_every_steps=1000), device="cpu").fit(
    PipelinedLMTask(plm, learning_rate=1e-2), micro(token_batches(stream)),
    val_data_factory=lambda: micro(token_batches(stream, num_batches=2, sample_seed=777)))
out["lm_fit"] = {"history": result.history,
                 "n_params": sum(p.numel() for p in plm.block.parameters())}
'''


def _mlp_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _init_stage(rng, d=16, h=32):
    k1, k2 = jax.random.split(rng)
    return {"w1": jax.random.normal(k1, (d, h)) * 0.3, "b1": jnp.zeros((h,)),
            "w2": jax.random.normal(k2, (h, d)) * 0.3, "b2": jnp.zeros((d,))}


def _sequential(stacked, xs, n):
    out = np.asarray(xs)
    for i in range(n):
        p = {k: np.asarray(v[i]) for k, v in stacked.items()}
        out = np.tanh(out @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    rng = np.random.default_rng(0)
    devices = np.array(jax.devices()[:4])
    mesh22 = Mesh(devices.reshape(2, 2), ("pipe", "data"))
    stacked = jax_stack(_init_stage, jax.random.key(1), 2)
    xs = rng.normal(size=(6, 4, 16)).astype(np.float32)
    tgt = rng.normal(size=(6, 4, 16)).astype(np.float32)
    run = jax_pipeline(_mlp_stage, mesh22, "pipe", batch_axis="data")
    dp_out = np.asarray(jax.jit(run)(stacked, jnp.asarray(xs)))
    dp_grads = jax.jit(jax.grad(lambda p: jnp.mean((run(p, jnp.asarray(xs)) - tgt) ** 2)))(
        stacked)

    edge = jax_stack(_init_stage, jax.random.key(9), 4)
    edge_xs = {m: rng.normal(size=(m, 4, 16)).astype(np.float32) for m in (1, 3, 8)}

    mesh41 = Mesh(devices.reshape(4, 1), ("pipe", "data"))
    jlm = JaxPipelinedLM(**LM_KW, mesh=mesh41, batch_axis="data")
    lm_params = jlm.init(jax.random.key(0))
    lm_tokens = rng.integers(0, 32, (6, 2, 12)).astype(np.int32)
    lm_logits = np.asarray(jax.jit(jlm.apply)(lm_params, jnp.asarray(lm_tokens)))
    jtask = JaxPipelinedLMTask(model=jlm)
    lm_loss, lm_grads = jax.jit(jax.value_and_grad(jtask._loss))(lm_params,
                                                                 jnp.asarray(lm_tokens))

    inputs = {"xs": xs, "tgt": tgt, **{f"dp.{k}": np.asarray(v) for k, v in stacked.items()},
              **{f"edge.{k}": np.asarray(v) for k, v in edge.items()},
              **{f"edge_xs{m}": v for m, v in edge_xs.items()}, "lm_tokens": lm_tokens,
              **{f"lm.{k}": np.asarray(lm_params[k]) for k in ("tok", "pos", "norm_scale",
                                                              "head")}}
    for k, v in _stacked_blocks(lm_params["stages"], 4).items():
        inputs[f"lm.stages.{k}"] = v
    ranks = run_ranks(tmp_path_factory.mktemp("pipe4"), _RANK, 4, inputs, {"lm": LM_KW},
                      timeout=300)
    return dict(ranks=ranks, dp_out=dp_out, dp_grads=dp_grads, edge=edge, edge_xs=edge_xs,
                lm_logits=lm_logits, lm_loss=float(lm_loss), lm_grads=lm_grads)


def _stacked_blocks(stages, n) -> dict[str, np.ndarray]:
    """JAX's stacked stage params as the port's block names, stacked."""
    per = [block_state_from_flax(jax.tree_util.tree_map(lambda l, i=i: np.asarray(l[i]),
                                                        stages)) for i in range(n)]
    return {k: np.stack([p[k].numpy() for p in per]) for k in per[0]}


def test_pipeline_dp_matches_jax(four):
    for out in four["ranks"]:
        stage, column = out["grid"]
        cols = slice(column * 2, column * 2 + 2)
        np.testing.assert_allclose(out["dp"]["ys"].numpy(), four["dp_out"][:, cols],
                                   atol=1e-5, rtol=1e-5)
        for k, g in out["dp"]["grads"].items():
            np.testing.assert_allclose(g.numpy(), np.asarray(four["dp_grads"][k][stage]),
                                       atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("n_micro", [1, 3, 8])
def test_pipeline_micro_count_edges(four, n_micro):
    want = _sequential(four["edge"], four["edge_xs"][n_micro], 4)
    for out in four["ranks"]:  # the output is replicated over the pipe
        np.testing.assert_allclose(out["edges"][n_micro].numpy(), want, atol=1e-5, rtol=1e-5)


def test_pipeline_single_stage_degenerates_to_apply():
    stacked = jax_stack(_init_stage, jax.random.key(11), 1)
    xs = np.random.default_rng(3).normal(size=(4, 8, 16)).astype(np.float32)
    run = spmd_pipeline(lambda p, x: torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"],
                        PipeGrid(1, 1, 0, 0))
    got = run({k: torch.from_numpy(np.array(v[0])) for k, v in stacked.items()},
              torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), _sequential(stacked, xs, 1), atol=1e-5, rtol=1e-5)


def test_pipelined_lm_matches_jax_and_sequential_blocks(four):
    for out in four["ranks"]:
        assert out["lm_logits"].shape == (6, 2, 12, 32)
        np.testing.assert_allclose(out["lm_logits"].numpy(), four["lm_logits"],
                                   atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(four["ranks"][0]["lm_logits"].numpy(),
                               four["ranks"][0]["lm_sequential"].numpy(), atol=2e-5, rtol=2e-5)


def test_pipelined_lm_task_gradients_match_jax(four):
    g = four["lm_grads"]
    stages = _stacked_blocks(g["stages"], 4)
    for out in four["ranks"]:
        stage = out["grid"][0] * 2 + out["grid"][1]  # the 4-stage grid: rank = stage
        np.testing.assert_allclose(out["lm_step"]["loss"], four["lm_loss"], rtol=1e-5)
        for name, got in out["lm_step"]["grads"].items():
            want = (stages[name[len("block."):]][stage] if name.startswith("block.")
                    else np.asarray(g[name]))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4, err_msg=name)


def test_pipelined_task_trains_under_trainer_and_checkpoints_stacked(four, tmp_path_factory):
    outs = [o["task"] for o in four["ranks"]]
    for t in outs:
        assert len(t["history"]) == 2 and t["steps"] == 80
        assert t["history"][1]["train_loss"] < 0.6 * t["history"][0]["train_loss"]
        assert np.isfinite(t["history"][1]["val_loss"])
        assert t["utilization"] == [pipeline_utilization(8, 2)]
        # Each rank holds one stage; a resume restores its slice.
        assert set(t["params"]) == {"params.w1", "params.b1", "params.w2", "params.b2"}
        assert t["resumed_steps"] == 80
        for n, p in t["params"].items():
            assert torch.equal(t["restored"][n], p), n
            assert torch.equal(t["moments"][n], t["trained_moments"][n]), n
    # Stage 1's params differ from stage 0's (each rank its own stage), and
    # the two columns of a stage agree.
    by_rank = [o["grid"] for o in four["ranks"]]
    assert by_rank == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert torch.equal(outs[0]["params"]["params.w1"], outs[1]["params"]["params.w1"])
    assert not torch.equal(outs[0]["params"]["params.w1"], outs[2]["params"]["params.w1"])
    ck = next(iter(tmp_path_factory.getbasetemp().glob("pipe4*/ck/80/state.pt")))
    state = torch.load(ck, weights_only=True)
    w1 = state["model"]["params.w1"]
    assert w1.shape == (2, 16, 32)
    assert torch.equal(w1[0], outs[0]["params"]["params.w1"])
    assert torch.equal(w1[1], outs[2]["params"]["params.w1"])


def test_pipelined_lm_trains_under_trainer(four):
    from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, entropy_floor

    floor = entropy_floor(TokenStreamConfig(vocab_size=16, batch_size=8, seq_len=24,
                                            concentration=0.05, seed=0))
    for out in four["ranks"]:
        h = out["lm_fit"]["history"]
        assert len(h) == 2
        assert h[1]["val_loss"] < 0.75 * np.log(16)
        assert h[1]["val_loss"] > floor - 0.05
        assert out["lm_fit"]["n_params"] == 4 * 32 * 32 + 2 * 32 + 2 * 32 * 128 + 128 + 32


def test_pipeline_utilization_accounting():
    assert pipeline_utilization(8, 4) == pytest.approx(8 / 11)
    assert pipeline_utilization(4, 4) == 4 / 7
    assert pipeline_utilization(64, 4) > 0.95


@pytest.mark.parametrize("entry", [PipelinedLM, PipelinedTask])
def test_pipeline_entry_points_default_to_the_card(entry):
    # As every entry point of the port: the CPU only when the caller asks.
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_pipelined_task_refuses_zero1():
    task = PipelinedTask(lambda p, x: x * p["a"], lambda seed: {"a": torch.ones(1)},
                         PipeGrid(1, 1, 0, 0), device="cpu")
    trainer = Trainer(TrainerConfig(shard_opt_state=True), device="cpu")
    with pytest.raises(ValueError, match="shard_opt_state"):
        trainer.fit(task, iter([{"x": np.ones((1, 1, 1), np.float32),
                                 "y": np.ones((1, 1, 1), np.float32)}]))


@pytest.mark.parametrize("clash", ["vocab_size", "max_seq", "dim"])
def test_pipelined_lm_stage_count_collision_guard(clash):
    kw = dict(vocab_size=32, dim=16, num_heads=2, max_seq=12)
    kw[clash] = 4
    if clash == "dim":
        kw["num_heads"] = 2
    with pytest.raises(ValueError, match="stage count"):
        PipelinedLM(**kw, grid=PipeGrid(4, 1, 0, 0), device="cpu")
