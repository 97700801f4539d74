"""The port across ranks: two gloo processes on the CPU against the JAX
package on the whole batch, or against one process on the concatenated
batch.

Each test starts two fresh Python processes (torch and the port only, no
JAX) that meet at ``file://<tmp_path>/rdzv``, so parallel test workers
never contend for a port. The ranks read their inputs from an ``.npz``
the test writes and save what they computed with ``torch.save``; the test
compares in its own process.

- ``bn_act``, ``PlainBatchNorm`` and ``bn_relu_matmul(group=)`` at 2 ranks
  against the JAX op (or flax ``nn.BatchNorm``) on the whole batch:
  statistics at atol 1e-6 (``tests/test_fused_norm.py:174``), outputs and
  gradients at the tolerances of the port's single-process tests of the
  same ops. A rank's dgamma and dbeta are its own sums: the two ranks'
  add up to the whole batch's.
- The tiny-bottleneck ``ClassifierTask`` (f32, pallas level) at 2 ranks
  under ``Trainer.fit`` against one process on the concatenated batch:
  running statistics, parameters and Adam's moments after one step; ZeRO-1
  against a replicated Adam over two steps at rtol 2e-4 / atol 1e-5
  (``tests/test_trainer.py:183-236``); a checkpoint written at 2 ranks
  with ZeRO-1 restores at 1 rank.
- A supervised step with a NaN injected on one rank, then a spike on the
  other: both ranks discard both, and the state (replicated or ZeRO-1) is
  bit-equal on both ranks to before the steps.
- SIGTERM to one rank: both ranks stop after the same step, and a step
  discarded on both (a NaN under ``skip``) quarantines both ranks' rows,
  written by process 0 alone.
- ``train`` and ``lm`` with ``--coordinator`` at 2 ranks.
"""

import json
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.ops import fused_norm as jax_fn
from dss_ml_at_scale_tpu.ops.fused_matmul import bn_relu_matmul as jax_matmul
from torch_ranks import run_ranks

# The ranks' script after torch_ranks' prelude: ``args`` holds the case and
# its extra arguments.
_RANK = r'''
assert runtime.process_count() == world and runtime.process_index() == rank
case, extra = args["case"], args.get("extra")


def mine(a):
    n = len(a) // world
    return torch.tensor(a[rank * n:(rank + 1) * n], requires_grad=True)


def whole(a):
    return torch.tensor(a, requires_grad=True)


if case == "bn_act":
    from dss_ml_at_scale_tpu_torch.ops.fused_norm import bn_act
    for relu in (False, True):
        for with_res in (False, True):
            x, res = mine(inputs["x"]), mine(inputs["res"])
            scale, bias = whole(inputs["scale"]), whole(inputs["bias"])
            y, mean, var = bn_act(x, scale, bias, relu=relu, residual=res if with_res else None,
                                  group=runtime.stats_group())
            (y * mine(inputs["cot"]).detach()).sum().backward()
            out[(relu, with_res)] = dict(out=y.detach(), mean=mean, var=var, dx=x.grad,
                                         dscale=scale.grad, dbias=bias.grad,
                                         dres=res.grad if with_res else None)
elif case == "plain_bn":
    from dss_ml_at_scale_tpu_torch.models.resnet import PlainBatchNorm
    bn = PlainBatchNorm(inputs["x"].shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["scale"]))
        bn.bias.copy_(torch.from_numpy(inputs["bias"]))
    x = mine(inputs["x"])
    y = bn(x)
    (y * mine(inputs["cot"]).detach()).sum().backward()
    out = dict(out=y.detach(), running_mean=bn.running_mean, running_var=bn.running_var,
               dx=x.grad, dscale=bn.weight.grad, dbias=bn.bias.grad)
elif case == "fused_matmul":
    from dss_ml_at_scale_tpu_torch.ops.fused_matmul import bn_relu_matmul
    from dss_ml_at_scale_tpu_torch.ops.fused_norm import batch_stats
    group = runtime.stats_group()
    for with_res in (False, True):
        y, res = mine(inputs["y"]), mine(inputs["res"])
        gamma, beta, w = whole(inputs["gamma"]), whole(inputs["beta"]), whole(inputs["w"])
        k = y.shape[-1]
        mean, var, _ = batch_stats(y.detach().reshape(-1, k), group)
        o = bn_relu_matmul(y, gamma, beta, mean, var, w, residual=res if with_res else None,
                           group=group, global_count=len(inputs["y"]) * y[0].numel() // k)
        (o * mine(inputs["cot"]).detach()).sum().backward()
        out[with_res] = dict(out=o.detach(), dy=y.grad, dgamma=gamma.grad, dbeta=beta.grad,
                             dw=w.grad, dres=res.grad if with_res else None)
elif case == "classifier":
    task = classifier_fit(inputs, rank, world, **extra)
    opt = task.optimizer
    if hasattr(opt, "consolidate_state_dict"):
        opt.consolidate_state_dict(to=0)
    out = dict(model=task.model.state_dict(), optimizer=opt.state_dict() if rank == 0 else None,
               grads={n: p.grad for n, p in task.model.named_parameters()})
elif case == "supervised":
    import copy
    from dss_ml_at_scale_tpu_torch.models import seeded_resnet
    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, Trainer, TrainerConfig
    from dss_ml_at_scale_tpu_torch.resilience import health
    zero1 = extra["zero1"]
    model = seeded_resnet(0, device="cpu", stage_sizes=[1, 1], block_cls=BottleneckBlock,
                          num_filters=8, num_classes=4, dtype=torch.float32, fused_bn="pallas")
    task = ClassifierTask(model=model, learning_rate=1e-2)
    Trainer(TrainerConfig(shard_opt_state=zero1), device="cpu").data_parallel(task)
    per = inputs["labels"].shape[1] // world
    batches = [{"image": torch.from_numpy(inputs["images"][s][rank * per:(rank + 1) * per]),
                "label": torch.from_numpy(inputs["labels"][s][rank * per:(rank + 1) * per])}
               for s in range(len(inputs["images"]))]
    guarded = health.guard_train_step(task, health.HealthConfig(policy="skip", warmup_steps=1))

    def state():
        opt = getattr(task.optimizer, "optim", task.optimizer)  # ZeRO-1: this rank's shard
        return dict(model={k: v.clone() for k, v in task.model.state_dict().items()},
                    adam=copy.deepcopy(opt.state_dict()["state"]), step=task.step)

    h = health.HealthState.create()
    h, m = guarded(h, batches[0], health.INJECT_NONE)  # commits: moments exist
    verdicts = [m["health_verdict"]]
    before = state()
    # A NaN on rank 0 only, then a spike on rank 1 only: both ranks discard both.
    for s, inject in ((1, health.INJECT_NONFINITE), (2, health.INJECT_SPIKE)):
        h, m = guarded(h, batches[s], inject if rank == s - 1 else health.INJECT_NONE)
        verdicts.append(m["health_verdict"])
    out = dict(verdicts=verdicts, before=before, after=state())
elif case == "preempt":
    import signal
    from dss_ml_at_scale_tpu_torch.models import seeded_resnet
    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, Trainer, TrainerConfig
    model = seeded_resnet(0, device="cpu", stage_sizes=[1, 1], block_cls=BottleneckBlock,
                          num_filters=8, num_classes=4, dtype=torch.float32, fused_bn="pallas")
    from dss_ml_at_scale_tpu_torch.resilience import faults
    from dss_ml_at_scale_tpu_torch.resilience.health import HealthConfig
    from dss_ml_at_scale_tpu_torch.resilience.rollback import QuarantineList, RowRange
    task = ClassifierTask(model=model, learning_rate=1e-2)
    per = inputs["labels"].shape[1] // world

    def stream():
        for s in range(len(inputs["images"])):
            if rank == 0 and s == 4:  # the evictor signals rank 0 alone
                os.kill(os.getpid(), signal.SIGTERM)
            yield {"image": inputs["images"][s][rank * per:(rank + 1) * per],
                   "label": inputs["labels"][s][rank * per:(rank + 1) * per],
                   "_provenance": [RowRange(f"mem://rank{rank}", s, 0, per)]}

    faults.install_from_spec("grads.nonfinite=1@1")  # every rank runs the same plan
    health = HealthConfig(policy="skip", quarantine=QuarantineList(f"{work}/q.jsonl"))
    result = Trainer(TrainerConfig(max_epochs=1, steps_per_epoch=8, log_every_steps=1000,
                                   checkpoint_dir=f"{work}/ck", feeder_depth=1, health=health),
                     device="cpu").fit(task, stream())
    out = dict(preempted=result.preempted, steps=result.steps,
               skipped=result.skipped_steps)
elif case == "cli":
    from dss_ml_at_scale_tpu_torch.config import cli
    import contextlib, io
    runtime.shutdown_distributed()  # the command joins through its own flags
    argv = extra
    env = {"NUM_PROCESSES": str(world), "PROCESS_ID": str(rank)}
    os.environ.update(env)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--coordinator", f"file://{work}/rdzv2"])
    assert rc == 0, buf.getvalue()
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
'''


def _ranks(tmp_path, case, inputs=None, extra=None, world=2, timeout=180):
    """Run ``case`` on ``world`` gloo ranks; returns each rank's output."""
    return run_ranks(tmp_path, _CLASSIFIER + _RANK, world, inputs,
                     {"case": case, "extra": extra}, timeout)


def _cat(a, b):
    return np.concatenate([np.asarray(a), np.asarray(b)])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def test_bn_act_across_two_ranks_matches_jax_on_the_whole_batch(tmp_path):
    rng = np.random.default_rng(0)
    shape, k = (4, 4, 4, 6), 6
    inputs = dict(x=rng.normal(size=shape).astype(np.float32),
                  res=rng.normal(size=shape).astype(np.float32),
                  cot=rng.normal(size=shape).astype(np.float32),
                  scale=rng.normal(1.0, 0.3, k).astype(np.float32),
                  bias=rng.normal(0.0, 0.3, k).astype(np.float32))
    r0, r1 = _ranks(tmp_path, "bn_act", inputs)
    for (relu, with_res), a in r0.items():
        b = r1[(relu, with_res)]

        def loss(x, scale, bias, res, relu=relu, with_res=with_res):
            out, _, _ = jax_fn.bn_act(x, scale, bias, eps=1e-5, relu=relu,
                                      residual=res if with_res else None)
            return jnp.sum(out * inputs["cot"])

        args = tuple(jnp.asarray(inputs[n]) for n in ("x", "scale", "bias", "res"))
        j_out, j_mean, j_var = jax_fn.bn_act(*args[:3], eps=1e-5, relu=relu,
                                            residual=args[3] if with_res else None)
        j_dx, j_ds, j_db, j_dr = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
        for r in (a, b):  # the statistics are global on both ranks
            np.testing.assert_allclose(r["mean"], j_mean, rtol=0, atol=1e-6)
            np.testing.assert_allclose(r["var"], j_var, rtol=0, atol=1e-6)
        np.testing.assert_allclose(_cat(a["out"], b["out"]), j_out, rtol=0, atol=2e-4)
        np.testing.assert_allclose(_cat(a["dx"], b["dx"]), j_dx, rtol=0, atol=2e-4)
        np.testing.assert_allclose(a["dscale"] + b["dscale"], j_ds, rtol=0, atol=2e-4)
        np.testing.assert_allclose(a["dbias"] + b["dbias"], j_db, rtol=0, atol=2e-4)
        if with_res:
            np.testing.assert_allclose(_cat(a["dres"], b["dres"]), j_dr, rtol=0, atol=2e-4)


def test_plain_batchnorm_across_two_ranks_matches_flax_on_the_whole_batch(tmp_path):
    rng = np.random.default_rng(1)
    shape, k = (4, 3, 3, 5), 5
    inputs = dict(x=rng.normal(2.0, 1.5, size=shape).astype(np.float32),
                  cot=rng.normal(size=shape).astype(np.float32),
                  scale=rng.normal(1.0, 0.3, k).astype(np.float32),
                  bias=rng.normal(0.0, 0.3, k).astype(np.float32))
    r0, r1 = _ranks(tmp_path, "plain_bn", inputs)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.key(0), jnp.asarray(inputs["x"]))
    params = {"scale": jnp.asarray(inputs["scale"]), "bias": jnp.asarray(inputs["bias"])}

    def loss(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * inputs["cot"]), (y, upd["batch_stats"])

    (_, (j_out, j_stats)), (j_dp, j_dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(inputs["x"]))
    for r in (r0, r1):
        np.testing.assert_allclose(r["running_mean"], j_stats["mean"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["running_var"], j_stats["var"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(_cat(r0["out"], r1["out"]), j_out, rtol=1e-5, atol=1e-5)
    assert _rel(_cat(r0["dx"], r1["dx"]), j_dx) < 5e-4
    assert _rel(r0["dscale"] + r1["dscale"], j_dp["scale"]) < 5e-4
    assert _rel(r0["dbias"] + r1["dbias"], j_dp["bias"]) < 5e-4


def test_bn_relu_matmul_group_across_two_ranks_matches_jax_on_the_whole_batch(tmp_path):
    rng = np.random.default_rng(42)
    shape, k, n = (4, 6, 6, 24), 24, 40
    inputs = dict(y=rng.normal(size=shape).astype(np.float32),
                  res=rng.normal(size=shape).astype(np.float32),
                  cot=rng.normal(size=shape[:-1] + (n,)).astype(np.float32),
                  gamma=rng.normal(1.0, 0.2, k).astype(np.float32),
                  beta=rng.normal(0.0, 0.2, k).astype(np.float32),
                  w=rng.normal(0.0, 0.1, (k, n)).astype(np.float32))
    r0, r1 = _ranks(tmp_path, "fused_matmul", inputs)
    for with_res in (False, True):
        a, b = r0[with_res], r1[with_res]

        def loss(y, gamma, beta, w, res, with_res=with_res):
            yf = y.reshape(-1, k)
            mean = jnp.mean(yf, 0)
            var = jnp.mean(jnp.square(yf), 0) - jnp.square(mean)
            out = jax_matmul(y, gamma, beta, mean, var, w, eps=1e-5,
                             residual=res if with_res else None)
            return jnp.sum(out * inputs["cot"]), out

        args = tuple(jnp.asarray(inputs[x]) for x in ("y", "gamma", "beta", "w", "res"))
        (_, j_out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
        np.testing.assert_allclose(_cat(a["out"], b["out"]), j_out, rtol=1e-5, atol=1e-5)
        got = {"dy": _cat(a["dy"], b["dy"]), "dgamma": a["dgamma"] + b["dgamma"],
               "dbeta": a["dbeta"] + b["dbeta"], "dw": a["dw"] + b["dw"]}
        if with_res:
            got["dres"] = _cat(a["dres"], b["dres"])
        for name, want in zip(("dy", "dgamma", "dbeta", "dw", "dres"), grads):
            if name in got:
                assert _rel(got[name], want) < 1e-5, name


# ---------------------------------------------------------------------------
# The classifier step and ZeRO-1 under Trainer.fit
# ---------------------------------------------------------------------------

# Run by the ranks and by the test itself, so both sides build the same task.
_CLASSIFIER = r'''
def classifier_fit(inputs, rank, world, *, steps=1, zero1=False, checkpoint_dir=None,
                   resume=False, epochs=1):
    """Fit the f32 pallas-level tiny-bottleneck for ``steps`` steps on this
    rank's rows of ``inputs`` (every row on one rank)."""
    import torch
    from dss_ml_at_scale_tpu_torch.models import seeded_resnet
    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, Trainer, TrainerConfig

    model = seeded_resnet(0, device="cpu", stage_sizes=[1, 1], block_cls=BottleneckBlock,
                          num_filters=8, num_classes=4, dtype=torch.float32, fused_bn="pallas")
    with torch.no_grad():  # the zero-init last BN scale would hide the backward
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.fill_(0.5)
    task = ClassifierTask(model=model, learning_rate=1e-2)
    images, labels = inputs["images"], inputs["labels"]
    per = len(labels) // world
    rows = slice(rank * per, (rank + 1) * per)
    batches = [{"image": images[s][rows], "label": labels[s][rows]}
               for s in range(len(images))]
    trainer = Trainer(TrainerConfig(max_epochs=epochs, steps_per_epoch=steps // epochs or 1,
                                    log_every_steps=1000, shard_opt_state=zero1,
                                    checkpoint_dir=checkpoint_dir, resume=resume,
                                    keep_checkpoints=4), device="cpu")
    trainer.fit(task, iter(batches))
    return task
'''
exec(_CLASSIFIER)


def _images(steps=2, batch=8):
    rng = np.random.default_rng(3)
    return dict(images=rng.normal(size=(steps, batch, 32, 32, 3)).astype(np.float32),
                labels=rng.integers(0, 4, (steps, batch)).astype(np.int64))


def _optimizer_moments(state):
    return {(i, k): v for i, st in state["state"].items() for k, v in st.items()
            if k in ("exp_avg", "exp_avg_sq")}


def _classifier(tmp_path, **kw):
    return _ranks(tmp_path, "classifier", _images(), kw)


def test_two_rank_classifier_step_matches_one_rank_on_the_concatenated_batch(tmp_path):
    """The running statistics, the gradients and Adam's moments after one
    step. (The parameters are not compared: Adam's first update is about
    +-lr for any nonzero gradient, so where a gradient is zero up to
    rounding, as the stem BN's bias is ahead of the next BN, the update
    itself is rounding noise.)"""
    r0, r1 = _classifier(tmp_path, steps=1)
    one = classifier_fit(_images(), 0, 1, steps=1)
    for name, value in one.model.state_dict().items():
        # Both ranks hold the same model: the statistics are global and
        # the gradients averaged.
        assert torch.equal(r0["model"][name], r1["model"][name]), name
        if "running" in name:
            np.testing.assert_allclose(r0["model"][name], value, rtol=0, atol=1e-6,
                                       err_msg=name)
    grads = dict(one.model.named_parameters())
    assert set(r0["grads"]) == set(grads)
    for name, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][name]), name
        assert _rel(g, grads[name].grad) < 1e-4, name
    assert r0["grads"]["layer1.0.conv3.weight"].abs().max() > 0  # through K1-K3's site
    got_m, want_m = _optimizer_moments(r0["optimizer"]), _optimizer_moments(
        one.optimizer.state_dict())
    assert set(got_m) == set(want_m) and got_m
    for key, value in want_m.items():
        assert _rel(got_m[key], value) < 1e-4, key


@pytest.mark.parametrize("zero1", [False, True], ids=["ddp", "zero1"])
def test_a_poisoned_step_is_discarded_on_every_rank(tmp_path, zero1):
    """The loss and grad-norm signals are summed over the ranks before the
    verdict, so a NaN or a spike on one rank alone makes both discard: the
    parameters, the BN statistics, Adam's state (each rank's shard under
    ZeRO-1) and the step count stay bit-equal to before, on both ranks."""
    ranks = _ranks(tmp_path, "supervised", _images(steps=3), {"zero1": zero1})
    for r in ranks:
        assert r["verdicts"] == [0, 1, 2]
        assert r["after"]["step"] == r["before"]["step"] == 1
        for k, v in r["before"]["model"].items():
            assert torch.equal(v, r["after"]["model"][k]), k
        assert r["before"]["adam"] and r["before"]["adam"].keys() == r["after"]["adam"].keys()
        for i, st in r["before"]["adam"].items():
            for k, v in st.items():
                assert torch.equal(v, r["after"]["adam"][i][k]), (i, k)
    for k, v in ranks[0]["after"]["model"].items():
        assert torch.equal(v, ranks[1]["after"]["model"][k]), k


def test_ranks_agree_on_the_step_to_stop_at_for_a_preemption(tmp_path):
    """SIGTERM reaches rank 0 alone: both ranks stop after the same step
    (rank 0 would otherwise leave rank 1 blocked in its next all-reduce)
    and one mid-epoch checkpoint of that step is saved."""
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity

    from dss_ml_at_scale_tpu_torch.resilience.rollback import QuarantineList

    r0, r1 = _ranks(tmp_path, "preempt", _images(steps=8))
    assert r0["preempted"] is r1["preempted"] is True
    assert r0["steps"] == r1["steps"] and 0 < r0["steps"] < 7
    assert r0["skipped"] == r1["skipped"] == 1
    assert integrity.list_steps(tmp_path / "ck") == [r0["steps"]]
    # The discarded step's rows of both ranks, written once, by process 0.
    entries = QuarantineList(tmp_path / "q.jsonl").entries
    assert sorted(Path(e["path"]).name for e in entries) == ["rank0", "rank1"]
    assert {e["row_group"] for e in entries} == {1}


def test_zero1_matches_replicated_adam_and_restores_at_one_rank(tmp_path):
    (tmp_path / "repl").mkdir()
    (tmp_path / "zero").mkdir()
    repl = _classifier(tmp_path / "repl", steps=2)
    zero = _classifier(tmp_path / "zero", steps=2, zero1=True, epochs=2,
                       checkpoint_dir=str(tmp_path / "ckpt"))
    for name, value in repl[0]["model"].items():
        np.testing.assert_allclose(zero[0]["model"][name], value, rtol=2e-4, atol=1e-5,
                                   err_msg=name)
        assert torch.equal(zero[0]["model"][name], zero[1]["model"][name]), name
    got_m, want_m = (_optimizer_moments(zero[0]["optimizer"]),
                     _optimizer_moments(repl[0]["optimizer"]))
    assert set(got_m) == set(want_m) and got_m
    for key, value in want_m.items():
        np.testing.assert_allclose(got_m[key], value, rtol=2e-4, atol=1e-5, err_msg=str(key))
    # Rank 0 alone wrote the consolidated state; one process restores it
    # (the fit restores step 2 and takes no step: max_epochs is reached).
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["1", "2"]
    restored = classifier_fit(_images(), 0, 1, steps=2, epochs=2,
                              checkpoint_dir=str(tmp_path / "ckpt"), resume=True)
    for name, value in zero[0]["model"].items():
        assert torch.equal(restored.model.state_dict()[name], value), name
    back = _optimizer_moments(restored.optimizer.state_dict())
    for key, value in got_m.items():
        assert torch.equal(back[key], value), key


# ---------------------------------------------------------------------------
# The commands with --coordinator
# ---------------------------------------------------------------------------

def test_train_command_with_a_coordinator_shards_the_table(tmp_path):
    from dss_ml_at_scale_tpu_torch.datagen import write_image_delta

    write_image_delta(tmp_path / "t", 32, classes=4, size=32, seed=0, max_rows_per_file=8)
    ckpt = tmp_path / "ckpt"
    argv = ["train", "--data", str(tmp_path / "t"), "--val-data", str(tmp_path / "t"),
            "--model", "tiny-bottleneck", "--pallas-fused", "--batch-size", "4",
            "--crop", "32", "--num-classes", "4", "--epochs", "1", "--device", "cpu",
            "--workers", "1", "--limit-val-batches", "2", "--checkpoint-dir", str(ckpt),
            "--shard-opt-state", "--augment", "--lr-schedule", "cosine"]
    r0, r1 = _ranks(tmp_path, "cli", extra=argv)
    # 32 rows, 4 per process and step, 2 processes: 4 steps an epoch.
    assert r0["steps"] == r1["steps"] == 4
    assert (r0["process_index"], r1["process_index"]) == (0, 1)
    assert r0["process_count"] == 2
    # The epoch's metrics are means over the ranks: the same on both.
    assert r0["train_loss"] == r1["train_loss"] and r0["val_acc"] == r1["val_acc"]
    assert sorted(p.name for p in ckpt.iterdir()) == ["4", "dsst_model.json"]
    meta = json.loads((ckpt / "dsst_model.json").read_text())
    assert meta["decay_steps"] == 4 and meta["fused_bn"] == "pallas"


def test_lm_command_with_a_coordinator_draws_a_trajectory_per_process(tmp_path):
    argv = ["lm", "--vocab", "32", "--dim", "32", "--heads", "2", "--layers", "1",
            "--seq", "16", "--batch-size", "2", "--steps-per-epoch", "2", "--epochs", "1",
            "--limit-val-batches", "1", "--device", "cpu"]
    r0, r1 = _ranks(tmp_path, "cli", extra=argv)
    assert r0["steps"] == r1["steps"] == 2
    assert (r0["process_index"], r1["process_index"], r0["process_count"]) == (0, 1, 2)
    assert r0["val_loss"] == r1["val_loss"] and np.isfinite(r0["train_loss"])
