"""The port's health supervisor vs the JAX package's
(``resilience/health.py``, ``parallel/trainer.py``).

- The guard's arithmetic: on the same loss and grad-norm signals, the
  port's :func:`guard_signals` gives JAX's ``guard_train_step`` verdict,
  z-score and EWMA state at rtol 1e-6, over a sequence that crosses the
  warmup and each injection code.
- The guarded step on the same weights and batch (the tiny-bottleneck
  ``ClassifierTask``, the tiny ``LMTask``) for each injection code: the
  same verdict, and the z-score and EWMA within the step's loss tolerance
  (rtol 1e-5, ``tests/test_torch_train.py``).
- A discarded step (``INJECT_NONFINITE``, ``INJECT_SPIKE``) leaves the
  parameters, Adam's moments and step, the BatchNorm running statistics,
  the schedule's count and ``task.step`` bit-equal to before
  (``tests/test_health.py`` holds discards with ``assert_array_equal``).
- The same verdict sequence gives the same commit/skip/rollback/abort
  sequence from both supervisors.
- A fit with ``grads.nonfinite=1@K`` under ``skip`` (with on-device
  augmentation, keyed by the step) equals, bit for bit, a clean fit whose
  stream leaves batch K out (JAX ``trainer.py:743-756``).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
from dss_ml_at_scale_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from dss_ml_at_scale_tpu.models.resnet import ResNet as JaxResNet
from dss_ml_at_scale_tpu.parallel.trainer import ClassifierTask as JaxTask
from dss_ml_at_scale_tpu.parallel.trainer import LMTask as JaxLMTask
from dss_ml_at_scale_tpu.resilience import health as jax_health
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.data.augment import AugmentConfig
from dss_ml_at_scale_tpu_torch.models import ResNet, TransformerLM, resnet_state_from_flax
from dss_ml_at_scale_tpu_torch.models.convert import lm_state_from_flax
from dss_ml_at_scale_tpu_torch.parallel import (
    ClassifierTask, LMTask, Trainer, TrainerConfig, warmup_cosine_decay_schedule,
)
from dss_ml_at_scale_tpu_torch.resilience import faults, health

LM = dict(vocab_size=32, dim=32, num_heads=2, num_layers=1, max_seq=16)
CODES = [health.INJECT_NONE, health.INJECT_NONFINITE, health.INJECT_SPIKE]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


def _counter(name):
    for m in telemetry.snapshot()["metrics"]:
        if m["name"] == name and not m.get("labels"):
            return m["value"]
    return 0.0


def _jh(h: health.HealthState):
    return jax_health.HealthState(mean=jnp.float32(h.mean.item()), var=jnp.float32(h.var.item()),
                                  count=jnp.int32(h.count.item()))


def _assert_h(got: health.HealthState, want, rtol):
    np.testing.assert_allclose(got.mean.item(), float(want.mean), rtol=rtol, atol=1e-7)
    np.testing.assert_allclose(got.var.item(), float(want.var), rtol=rtol, atol=1e-7)
    assert got.count.item() == int(want.count)


def test_guard_arithmetic_is_jaxs():
    cfg = health.HealthConfig(policy="skip", warmup_steps=5)
    jcfg = jax_health.HealthConfig(policy="skip", warmup_steps=5)
    jguard = jax.jit(jax_health.guard_train_step(
        lambda state, batch: (state, dict(batch)), jcfg))
    rng = np.random.default_rng(0)
    h, jcarry = health.HealthState.create(), (jnp.zeros(()), jax_health.HealthState.create())
    seen = set()
    for i in range(40):
        loss, gn = np.float32(2.0 + 0.05 * rng.normal()), np.float32(abs(rng.normal()))
        if i == 17:
            loss = np.float32(9.0)  # a real spike
        inject = CODES[i % 3] if i > 8 else health.INJECT_NONE
        metrics = {"train_loss": torch.tensor(loss), "grad_norm": torch.tensor(gn)}
        got, new_h, verdict = health.guard_signals(metrics, h, cfg, inject)
        jcarry, want = jguard(jcarry, {"train_loss": jnp.float32(loss),
                                        "grad_norm": jnp.float32(gn)}, jnp.int32(inject))
        assert int(verdict) == int(want["health_verdict"]), i
        np.testing.assert_allclose(got["loss_zscore"].item(), float(want["loss_zscore"]),
                                   rtol=1e-6)
        h = new_h if int(verdict) == health.VERDICT_OK else h
        _assert_h(h, jcarry[1], rtol=1e-6)
        seen.add(int(verdict))
    assert seen == {0, 1, 2}


@functools.lru_cache(maxsize=None)
def _jax_classifier():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck, num_classes=5, num_filters=8,
                   dtype=jnp.float32, fused_bn="pallas")
    variables = jax.tree_util.tree_map(np.array, jm.init(jax.random.key(0), images[:1]))
    for name, block in variables["params"].items():
        if name.startswith("BottleneckBlock"):
            scale = block["BatchNorm_2"]["scale"]
            block["BatchNorm_2"]["scale"] = rng.normal(1.0, 0.2, scale.shape).astype(np.float32)
    jtask = JaxTask(model=jm, learning_rate=1e-3)
    batch = {"image": images, "label": np.array([0, 1, 2, 3], np.int32)}
    return jtask, jtask.state_from_variables(variables), resnet_state_from_flax(variables), batch


def _classifier_pair(learning_rate=1e-3):
    jtask, state, weights, batch = _jax_classifier()
    tm = ResNet(stage_sizes=[1, 1], num_classes=5, num_filters=8, dtype=torch.float32,
                fused_bn="pallas")
    tm.load_state_dict(weights)
    return jtask, state, ClassifierTask(model=tm, learning_rate=learning_rate), batch


@functools.lru_cache(maxsize=None)
def _jax_lm():
    tokens = np.random.default_rng(1).integers(0, LM["vocab_size"], (4, 16)).astype(np.int32)
    jtask = JaxLMTask(model=JaxLM(attention="flash", dtype=jnp.float32, **LM))
    state = jtask.init_state(jax.random.key(0), {"tokens": tokens})
    return (jtask, state, lm_state_from_flax(jax.tree_util.tree_map(np.asarray, state.params)),
            {"tokens": tokens})


def _lm_pair(learning_rate=1e-3):
    jtask, state, weights, batch = _jax_lm()
    tm = TransformerLM(attention="flash", dtype=torch.float32, device="cpu", **LM)
    tm.load_state_dict(weights)
    return jtask, state, LMTask(model=tm, learning_rate=learning_rate), batch


@functools.lru_cache(maxsize=None)
def _jax_guard(pair):
    jtask = pair()[0]
    return (jax.jit(jtask.train_step),
            jax.jit(jax_health.guard_train_step(
                jtask.train_step, jax_health.HealthConfig(policy="skip", warmup_steps=3))))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("inject", CODES, ids=["none", "nonfinite", "spike"])
@pytest.mark.parametrize("pair", [_classifier_pair, _lm_pair], ids=["classifier", "lm"])
def test_guarded_step_verdict_and_ewma_match_jax(pair, inject):
    jtask, state, task, batch = pair()
    step, jguard = _jax_guard(pair)
    cfg = health.HealthConfig(policy="skip", warmup_steps=3)
    # A warmed detector around the step's loss, so the spike rung is armed.
    loss0 = float(step(state, batch)[1]["train_loss"])
    h = health.HealthState(mean=torch.tensor(loss0 + 0.01), var=torch.tensor(0.04),
                           count=torch.tensor(5, dtype=torch.int32))
    (_, jh), want = jguard((state, _jh(h)), batch, jnp.int32(inject))
    new_h, got = health.guard_train_step(task, cfg)(h, _torch_batch(batch), inject)
    assert got["health_verdict"] == int(want["health_verdict"]) == inject
    # The loss's tolerance (rtol 1e-5) carried through |loss - mean| / std.
    np.testing.assert_allclose(got["loss_zscore"].item(), float(want["loss_zscore"]),
                               rtol=1e-5, atol=1e-5 * abs(loss0) / 0.2)
    _assert_h(new_h, jh, rtol=1e-5)
    assert (new_h is h) == (inject != health.INJECT_NONE)


def _state(task) -> dict:
    opt = task.optimizer.state_dict()
    return {
        "model": {k: v.clone() for k, v in task.model.state_dict().items()},
        "adam": copy.deepcopy(opt["state"]),
        "lr": [g["lr"] for g in opt["param_groups"]],
        "schedule": task.scheduler.state_dict()["last_epoch"],
        "step": task.step,
    }


def _assert_bit_equal(a, b):
    assert a["step"] == b["step"] and a["schedule"] == b["schedule"] and a["lr"] == b["lr"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert a["adam"].keys() == b["adam"].keys()
    for i, st in a["adam"].items():
        for k, v in st.items():
            assert torch.equal(v, b["adam"][i][k]), (i, k)


@pytest.mark.parametrize("inject", [health.INJECT_NONFINITE, health.INJECT_SPIKE],
                         ids=["nonfinite", "spike"])
@pytest.mark.parametrize("pair", [_classifier_pair, _lm_pair], ids=["classifier", "lm"])
def test_discarded_step_leaves_the_state_bit_equal(pair, inject):
    _, _, task, batch = pair(warmup_cosine_decay_schedule(1e-3, 2, 10))
    tbatch = _torch_batch(batch)
    guarded = health.guard_train_step(task, health.HealthConfig(policy="skip", warmup_steps=1))
    h = health.HealthState.create()
    h, m = guarded(h, tbatch, health.INJECT_NONE)  # moments and counts exist
    assert m["health_verdict"] == health.VERDICT_OK and task.step == 1
    before = _state(task)
    assert any(k.endswith("running_mean") for k in before["model"]) == (pair is _classifier_pair)
    h2, m = guarded(h, tbatch, inject)
    assert m["health_verdict"] == inject and h2 is h
    _assert_bit_equal(_state(task), before)
    h3, m = guarded(h, tbatch, health.INJECT_NONE)  # and the next step commits
    assert m["health_verdict"] == health.VERDICT_OK and task.step == 2
    assert not torch.equal(next(iter(task.model.parameters())),
                           next(iter(before["model"].values())))


@pytest.mark.parametrize("policy", ["skip", "rollback", "abort"])
def test_supervisor_ladder_is_jaxs(policy):
    verdicts = [0, 1, 0, 2, 1, 1, 0, 1, 1, 1, 0, 2, 2, 2, 0, 1, 1, 1, 1]
    port = health.HealthSupervisor(health.HealthConfig(policy=policy, max_consecutive_skips=2,
                                                       max_rollbacks=1))
    ref = jax_health.HealthSupervisor(jax_health.HealthConfig(
        policy=policy, max_consecutive_skips=2, max_rollbacks=1))
    got, want = [], []
    for step, v in enumerate(verdicts, 1):
        m = {"health_verdict": v, "train_loss": 1.0 if v != 1 else float("nan"),
             "loss_zscore": 7.0}
        a, b = port.observe(step, m), ref.observe(step, m)
        got.append(a)
        want.append(b)
        if a == "rollback":
            port.record_rollback(step, 0, 0.0, 0.0)
            ref.record_rollback(step, 0, 0.0, 0.0)
        if a == "abort":
            break
    assert got == want
    assert (port.skipped_steps, port.rollbacks, port.bad_streak) == (
        ref.skipped_steps, ref.rollbacks, ref.bad_streak)


def _model(seed=0):
    from dss_ml_at_scale_tpu_torch.models.convert import seeded_resnet
    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock

    return seeded_resnet(seed, device="cpu", stage_sizes=[1, 1], num_filters=8,
                         block_cls=BottleneckBlock, num_classes=4, fused_bn="pallas",
                         dtype=torch.float32)


def _batches(n):
    rng = np.random.default_rng(3)
    return [{"image": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 4, 4).astype(np.int32)} for _ in range(n)]


def _fit(batches, health_cfg, **cfg):
    task = ClassifierTask(model=_model(), learning_rate=1e-2, augment=AugmentConfig())
    result = Trainer(TrainerConfig(log_every_steps=1000, health=health_cfg, **cfg),
                     device="cpu").fit(task, iter(batches))
    return result, task


def test_poisoned_fit_equals_the_clean_fit_without_that_batch():
    batches = _batches(10)
    before = _counter("nonfinite_steps_total")
    faults.install_from_spec("grads.nonfinite=1@3")
    poisoned, ptask = _fit(batches, health.HealthConfig(policy="skip"), max_epochs=2,
                           steps_per_epoch=4)
    faults.clear()
    clean, ctask = _fit([b for i, b in enumerate(batches) if i != 3],
                        health.HealthConfig(policy="skip"), max_epochs=2, steps_per_epoch=4)
    assert poisoned.steps == clean.steps == 8 == ptask.step
    assert poisoned.skipped_steps == 1 and poisoned.health_rollbacks == 0
    assert clean.skipped_steps == 0
    assert _counter("nonfinite_steps_total") - before == 1
    for (k, a), b in zip(ptask.model.state_dict().items(), ctask.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert ptask.scheduler is None and ctask.scheduler is None


def test_supervised_fit_registers_the_health_counters():
    _fit(_batches(2), health.HealthConfig(policy="skip"), max_epochs=1, steps_per_epoch=2)
    text = telemetry.render_prometheus()
    for name in ("nonfinite_steps_total", "loss_spikes_total", "health_rollbacks_total",
                 "quarantined_batches_total"):
        assert name in text


def test_unsupervised_step_is_the_plain_step():
    """health=None runs ``train_step`` as before: the same update as a
    guarded step that commits, and no verdict in the metrics."""
    batches = _batches(3)
    plain, ptask = _fit(batches, None, max_epochs=1, steps_per_epoch=3)
    guarded, gtask = _fit(batches, health.HealthConfig(policy="skip"), max_epochs=1,
                          steps_per_epoch=3)
    assert "health_verdict" not in plain.history[0]
    assert guarded.history[0]["health_verdict"] == 0
    for a, b in zip(ptask.model.state_dict().values(), gtask.model.state_dict().values()):
        assert torch.equal(a, b)
