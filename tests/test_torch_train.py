"""The port's ClassifierTask vs the JAX package's, one Adam step and one
eval step on identical weights and batch.

Both models are the ``tiny-bottleneck`` geometry at the pallas level in
f32, with the last BN scale of every block nonzero; the batch is numpy,
made from a seed. ``optax.adam(1e-5)`` and ``torch.optim.Adam(lr=1e-5,
betas=(0.9, 0.999), eps=1e-8)`` compute the same update. Checked:
``train_loss``, ``train_acc`` and ``grad_norm`` at rtol 1e-5; the updated
batch statistics at rtol 1e-5 / atol 1e-6; Adam's two moments at a max-abs
error under 5e-4 of their max-abs (the gradient tolerance of
``tests/test_fused_matmul.py:407``); and the parameter update. On the first
step Adam moves each parameter by ``lr * g / (|g| + eps)``, about ``lr``
times the sign of its gradient, so an element whose gradient is near zero
may move differently under a gradient error of that tolerance: the update
is compared at 1e-3 of ``lr`` on the elements whose gradient is above 1e-3
of its tensor's max-abs, and held within ``lr`` everywhere (each plus the
f32 rounding of the updated parameter). The eval step's
loss, accuracy and top-k accuracy match at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from dss_ml_at_scale_tpu.models.resnet import ResNet as JaxResNet
from dss_ml_at_scale_tpu.parallel.trainer import ClassifierTask as JaxTask
from dss_ml_at_scale_tpu_torch.models import ResNet, resnet_state_from_flax
from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

LR = 1e-5
CLASSES = 5


@pytest.fixture(scope="module")
def stepped():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    jm = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck, num_classes=CLASSES,
                   num_filters=8, dtype=jnp.float32, fused_bn="pallas")
    variables = jax.tree_util.tree_map(np.array, jm.init(jax.random.key(0), images[:1]))
    for name, block in variables["params"].items():
        if name.startswith("BottleneckBlock"):
            scale = block["BatchNorm_2"]["scale"]
            block["BatchNorm_2"]["scale"] = rng.normal(1.0, 0.2, scale.shape).astype(np.float32)
    jtask = JaxTask(model=jm, learning_rate=LR, eval_topk=(3,))
    state0 = jtask.state_from_variables(variables)
    batch = {"image": images, "label": labels}
    state1, jmetrics = jax.jit(jtask.train_step)(state0, batch)
    jeval = jax.jit(jtask.eval_step)(state1, batch)

    tm = ResNet(stage_sizes=[1, 1], num_classes=CLASSES, num_filters=8,
                dtype=torch.float32, fused_bn="pallas")
    tm.load_state_dict(resnet_state_from_flax(variables))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    ttask = ClassifierTask(model=tm, learning_rate=LR, eval_topk=(3,))
    tbatch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    tmetrics = ttask.train_step(tbatch)
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    teval = ttask.eval_step(tbatch)
    return dict(variables=variables, state1=state1, jmetrics=jmetrics, jeval=jeval,
                tm=tm, ttask=ttask, before=before, grads=grads, tmetrics=tmetrics,
                teval=teval)


def _flax_to_port(tree, stats):
    return resnet_state_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, tree),
         "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})


def test_train_metrics_match(stepped):
    for key in ("train_loss", "train_acc", "grad_norm"):
        np.testing.assert_allclose(float(stepped["tmetrics"][key]),
                                   float(stepped["jmetrics"][key]), rtol=1e-5, err_msg=key)


def test_batch_stats_match(stepped):
    want = _flax_to_port(stepped["state1"].params, stepped["state1"].batch_stats)
    got = stepped["tm"].state_dict()
    for key, value in want.items():
        if "running" in key:
            np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-6, err_msg=key)


def test_adam_moments_match(stepped):
    adam = stepped["state1"].opt_state[0]  # optax ScaleByAdamState
    stats = stepped["state1"].batch_stats
    mu, nu = _flax_to_port(adam.mu, stats), _flax_to_port(adam.nu, stats)
    opt = stepped["ttask"].optimizer
    for name, p in stepped["tm"].named_parameters():
        st = opt.state[p]
        for got, want in ((st["exp_avg"], mu[name]), (st["exp_avg_sq"], nu[name])):
            err = (got - want).abs().max().item() / (want.abs().max().item() + 1e-30)
            assert err < 5e-4, f"{name}: moment rel err {err}"


def test_parameter_update_matches(stepped):
    want = _flax_to_port(stepped["state1"].params, stepped["state1"].batch_stats)
    got = stepped["tm"].state_dict()
    for name, g in stepped["grads"].items():
        before = stepped["before"][name]
        d_port, d_jax = got[name] - before, want[name] - before
        ulp = 2 * torch.finfo(torch.float32).eps * before.abs()  # the f32 rounding of p - update
        assert (d_port.abs() <= LR * (1 + 1e-3) + ulp).all(), name
        sure = g.abs() > 1e-3 * g.abs().max()
        assert ((d_port - d_jax).abs() <= 1e-3 * LR + ulp)[sure].all(), name


def test_eval_step_matches(stepped):
    for key in ("val_loss", "val_acc", "val_top3_acc"):
        np.testing.assert_allclose(float(stepped["teval"][key]),
                                   float(stepped["jeval"][key]), rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_uint8_images_are_normalized_in_the_step(layout):
    """uint8 bytes (either layout) normalize inside the step exactly as the
    JAX task does."""
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    arr = raw if layout == "nhwc" else raw.transpose(0, 3, 1, 2)
    want = JaxTask(model=None, tx=object())._images({"image": arr})
    task = ClassifierTask(model=torch.nn.Linear(1, 1))
    got = task.images({"image": torch.from_numpy(np.ascontiguousarray(arr))})
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
