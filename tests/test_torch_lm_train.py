"""The port's LM training against the JAX package's.

- One ``LMTask`` train step and one eval step on a tiny f32 LM (vocab 64,
  dim 64, 2 heads, 2 layers, seq 32, flash attention: Pallas in interpret
  mode on the JAX side, the plain version and the chunked-recompute
  backward on the port's) with identical weights and batch, under
  ``optax.adam(3e-4)`` and the port's Adam. The rules of
  ``tests/test_torch_train.py``: metrics at rtol 1e-5; Adam's moments
  within 5e-4 of their max-abs; the update within 1e-3 of ``lr`` on the
  elements whose gradient is above 1e-3 of its tensor's max-abs and
  within ``lr`` everywhere (each plus the f32 rounding of the parameter).
- The cosine schedule against ``optax.warmup_cosine_decay_schedule`` at
  every step of a 40-step run, at peak 1: within 1e-7 (optax computes in
  f32, the port in f64). One scheduled step leaves every parameter as it
  was (optax's first update runs at lr 0) and moves Adam's moments, as
  under optax; the second update matches optax's by the rules above.
- ``dsst_lm.json``: the port's resolver against ``_resolve_lr_schedule``,
  with and without an explicit flag.
- The ``lm`` command on the CPU prints every key of the JAX command's
  summary.
"""

import argparse
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dss_ml_at_scale_tpu.config.commands import _resolve_lr_schedule
from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
from dss_ml_at_scale_tpu.parallel.trainer import LMTask as JaxLMTask
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.models import TransformerLM, init_lm_state, lm_state_from_flax
from dss_ml_at_scale_tpu_torch.parallel import LMTask, warmup_cosine_decay_schedule

LR = 3e-4
KW = dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, max_seq=32)


def _tokens(seed=0, batch=4):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (batch, 32)).astype(np.int32)


def _pair(tx=None, lr=LR):
    """A JAX LMTask state and the port's LMTask on the same weights."""
    jm = JaxLM(attention="flash", dtype=jnp.float32, **KW)
    jtask = JaxLMTask(model=jm, tx=tx)
    state0 = jtask.init_state(jax.random.key(0), {"tokens": _tokens()})
    tm = TransformerLM(attention="flash", dtype=torch.float32, device="cpu", **KW)
    tm.load_state_dict(lm_state_from_flax(jax.tree_util.tree_map(np.asarray, state0.params)))
    return jtask, state0, LMTask(model=tm, learning_rate=lr)


def _port(tree) -> dict[str, torch.Tensor]:
    return lm_state_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _check_update(before, got, want, grads, lr, most=1.0):
    """``most``: Adam's largest step over ``lr``. 1 on the first update; on
    the second, with the gradients weighted w = (0.09, 0.1) / 0.19 in the
    bias-corrected first moment and u = (0.000999, 0.001) / 0.001999 in the
    second, Cauchy-Schwarz bounds it by sqrt(w1^2/u1 + w2^2/u2) = 1.00136."""
    for name, g in grads.items():
        d_port, d_jax = got[name] - before[name], want[name] - before[name]
        ulp = 2 * torch.finfo(torch.float32).eps * before[name].abs()
        assert (d_port.abs() <= lr * (most + 1e-3) + ulp).all(), name
        sure = g.abs() > 1e-3 * g.abs().max()
        assert ((d_port - d_jax).abs() <= 1e-3 * lr + ulp)[sure].all(), name


def _check_moments(adam_state, task):
    mu, nu = _port(adam_state.mu), _port(adam_state.nu)
    for name, p in task.model.named_parameters():
        st = task.optimizer.state[p]
        for got, want in ((st["exp_avg"], mu[name]), (st["exp_avg_sq"], nu[name])):
            err = (got - want).abs().max().item() / (want.abs().max().item() + 1e-30)
            assert err < 5e-4, f"{name}: moment rel err {err}"


@pytest.fixture(scope="module")
def stepped():
    jtask, state0, task = _pair()
    batch = {"tokens": _tokens()}
    state1, jmetrics = jax.jit(jtask.train_step)(state0, batch)
    jeval = jax.jit(jtask.eval_step)(state1, {"tokens": _tokens(1)})
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    tbatch = {"tokens": torch.from_numpy(batch["tokens"])}
    tmetrics = task.train_step(tbatch)
    grads = {n: p.grad.clone() for n, p in task.model.named_parameters()}
    teval = task.eval_step({"tokens": torch.from_numpy(_tokens(1))})
    return dict(state1=state1, jmetrics=jmetrics, jeval=jeval, task=task, before=before,
                grads=grads, tmetrics=tmetrics, teval=teval)


def test_train_metrics_match(stepped):
    for key in ("train_loss", "train_ppl", "grad_norm"):
        np.testing.assert_allclose(float(stepped["tmetrics"][key]),
                                   float(stepped["jmetrics"][key]), rtol=1e-5, err_msg=key)


def test_eval_metrics_match(stepped):
    for key in ("val_loss", "val_ppl"):
        np.testing.assert_allclose(float(stepped["teval"][key]),
                                   float(stepped["jeval"][key]), rtol=1e-5, err_msg=key)


def test_adam_moments_match(stepped):
    _check_moments(stepped["state1"].opt_state[0], stepped["task"])


def test_parameter_update_matches(stepped):
    _check_update(stepped["before"], stepped["task"].model.state_dict(),
                  _port(stepped["state1"].params), stepped["grads"], LR)


def test_lm_task_defaults_and_refusals():
    task = LMTask(model=torch.nn.Linear(1, 1))
    assert task.optimizer.param_groups[0]["lr"] == 3e-4 and task.scheduler is None
    assert (task.default_best_metric, task.default_best_mode) == ("val_loss", "min")
    # On a dense model the aux term adds 0, as JAX's empty collect_aux_loss.
    losses = []
    for weight in (0.0, 0.01):
        tm = TransformerLM(attention="reference", dtype=torch.float32, device="cpu", **KW)
        tm.load_state_dict(init_lm_state(tm, 0))
        aux = LMTask(model=tm, aux_loss_weight=weight)
        losses.append(aux.compute_update({"tokens": torch.from_numpy(_tokens())})["train_loss"])
    assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize("warmup", [0, 1, 2, 10, 39])
def test_cosine_schedule_matches_optax(warmup):
    want = optax.warmup_cosine_decay_schedule(0.0, 1.0, warmup, 40)
    got = warmup_cosine_decay_schedule(1.0, warmup, 40)
    for step in range(46):  # past the end of the decay too
        assert abs(got(step) - float(want(step))) <= 1e-7, step


def test_cosine_schedule_refuses_what_optax_refuses():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1.0, 5, 5)
    with pytest.raises(ValueError, match="decay_steps"):
        warmup_cosine_decay_schedule(1.0, 5, 5)


def test_scheduled_first_update_is_lr_zero_as_in_optax():
    jsched = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10)
    jtask, state0, task = _pair(tx=optax.adam(jsched), lr=warmup_cosine_decay_schedule(LR, 2, 10))
    step = jax.jit(jtask.train_step)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    state1, _ = step(state0, {"tokens": _tokens()})
    task.train_step({"tokens": torch.from_numpy(_tokens())})
    after1 = task.model.state_dict()
    for name, value in before.items():  # lr 0: no parameter moves, on either side
        assert torch.equal(after1[name], value), name
        np.testing.assert_array_equal(_port(state1.params)[name], value)
    assert any(s["exp_avg"].abs().max() > 0 for s in task.optimizer.state.values())
    _check_moments(state1.opt_state[0], task)
    # The second update runs at schedule(1) = LR / 2 on both sides.
    assert task.optimizer.param_groups[0]["lr"] == pytest.approx(LR / 2, rel=1e-12)
    before = {k: v.clone() for k, v in after1.items()}
    state2, _ = step(state1, {"tokens": _tokens(2)})
    task.train_step({"tokens": torch.from_numpy(_tokens(2))})
    grads = {n: p.grad.clone() for n, p in task.model.named_parameters()}
    _check_update(before, task.model.state_dict(), _port(state2.params), grads, LR / 2,
                  most=1.00136)


def _ns(schedule=None, warmup=None, lr=0.01):
    return argparse.Namespace(lr_schedule=schedule, warmup_steps=warmup, learning_rate=lr)


@pytest.mark.parametrize("flags,meta,total", [
    ((None, None), {}, 100),                                   # constant by default
    (("cosine", None), {}, 100),                               # fresh explicit cosine
    ((None, None), {"lr_schedule": "cosine", "warmup_steps": 5, "decay_steps": 100}, 999),
    (("cosine", None), {"lr_schedule": "cosine", "warmup_steps": 5, "decay_steps": 100}, 200),
    ((None, 1), {"lr_schedule": "cosine", "warmup_steps": 5, "decay_steps": 100}, 999),
    (("constant", None), {"lr_schedule": "cosine", "warmup_steps": 5, "decay_steps": 100}, 50),
    (("cosine", 50), {}, 10),                                  # warmup clamped to decay...
    ((None, None), {"lr_schedule": "cosine"}, 40),             # no persisted trajectory
])
def test_lr_metadata_resolves_as_in_jax(flags, meta, total):
    jmeta, pmeta = dict(meta), dict(meta)
    try:
        want = _resolve_lr_schedule(_ns(*flags), jmeta, total_steps=total)
    except ValueError:  # optax refuses warmup == decay; so must the port
        with pytest.raises(ValueError):
            cli.resolve_lr_schedule(_ns(*flags), pmeta, total_steps=total)
        return
    got = cli.resolve_lr_schedule(_ns(*flags), pmeta, total_steps=total)
    assert pmeta == jmeta
    if callable(want):
        for step in range(0, pmeta["decay_steps"] + 3):
            # optax's f32 against the port's f64 over decays up to 200 steps:
            # 1e-6 of the peak, a few f32 spacings (2^-23) of its cosine.
            assert abs(got(step) - float(want(step))) <= 1e-6 * 0.01, step
    else:
        assert got == want


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_lm_cli_prints_the_jax_summary_keys(tmp_path):
    from dss_ml_at_scale_tpu.config.cli import main as jax_main

    common = ["lm", "--vocab", "16", "--dim", "16", "--heads", "2", "--layers", "1",
              "--seq", "16", "--batch-size", "8", "--steps-per-epoch", "3", "--epochs", "1",
              "--limit-val-batches", "1", "--sample", "4", "--attention", "reference"]
    want = _run(jax_main, common + ["--no-tracking", "--checkpoint-dir", str(tmp_path / "j")])
    got = _run(cli.main, common + ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "t")])
    assert set(want) <= set(got)
    assert got["steps"] == want["steps"] == 3
    assert got["entropy_floor_nats"] == want["entropy_floor_nats"]
    assert got["sample_chance_prob"] == want["sample_chance_prob"]
    assert len(got["sample_tokens"]) == len(want["sample_tokens"]) == 8
    assert got["best_checkpoint"] == str(tmp_path / "t" / "3")
    assert all(np.isfinite(got[k]) for k in ("train_loss", "val_loss", "val_ppl",
                                              "tokens_per_sec"))


@pytest.mark.parametrize("flag", [["--ffn", "moe"]])
def test_lm_cli_refuses_what_later_slices_bring(flag, tmp_path):
    # The flag this test once saw refused now runs: a CPU `lm --ffn moe`
    # prints every key of the JAX command's summary.
    from dss_ml_at_scale_tpu.config.cli import main as jax_main

    common = ["lm", "--vocab", "16", "--dim", "16", "--heads", "2", "--layers", "1",
              "--seq", "16", "--batch-size", "8", "--steps-per-epoch", "2", "--epochs", "1",
              "--limit-val-batches", "1", "--num-experts", "4", "--attention", "reference",
              *flag]
    want = _run(jax_main, common + ["--no-tracking"])
    got = _run(cli.main, common + ["--device", "cpu"])
    assert set(want) <= set(got)
    assert got["steps"] == want["steps"] == 2
    assert all(np.isfinite(got[k]) for k in ("train_loss", "val_loss", "val_ppl"))


@pytest.mark.parametrize("flag", [["--resume-auto"], ["--health-policy", "skip"],
                                  ["--max-rollbacks", "3"], ["--experiment", "x"]])
def test_lm_cli_accepts_the_resilience_and_tracking_flags(flag, capsys, tmp_path):
    argv = ["lm", "--device", "cpu", "--vocab", "32", "--dim", "32", "--heads", "2",
            "--layers", "1", "--seq", "16", "--batch-size", "2", "--steps-per-epoch", "1",
            "--epochs", "1", "--limit-val-batches", "1", "--checkpoint-dir",
            str(tmp_path / "ck"), "--tracking-root", str(tmp_path / "runs"), *flag]
    assert cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 1 and summary["preempted"] is False
    assert ("skipped_steps" in summary) == (flag[0] == "--health-policy")
