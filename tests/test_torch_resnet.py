"""The port's ResNet vs the JAX package's flax ResNet, on the same weights.

flax variables go through ``resnet_state_from_flax`` into the port; the
same numpy images go into both models, in f32. Checked at every
``fused_bn`` level (False, True, "pallas"): train-mode logits and updated
batch statistics at rtol 1e-5 (``tests/test_fused_matmul.py:308-312``),
eval logits at the same tolerance, and every parameter gradient of a
cross-entropy loss at a max-abs error under 5e-4 of the flax gradient's
max-abs (``:385-407``). The last BN scale of every block is set nonzero in
both models first: at its zero init the gradient reaching the fused site is
exactly zero and the backward would pass without being tested.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dss_ml_at_scale_tpu.models.pretrained import export_torchvision
from dss_ml_at_scale_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from dss_ml_at_scale_tpu.models.resnet import ResNet as JaxResNet
from dss_ml_at_scale_tpu.models.resnet import ResNetBlock as JaxBasic
from dss_ml_at_scale_tpu_torch.models import (
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet50,
    ResNetBlock,
    init_resnet_state,
    resnet_state_from_flax,
    seeded_resnet,
)
from dss_ml_at_scale_tpu_torch.models.resnet import _same_pad

GEOMETRIES = {
    # name: (jax block, port block, stage sizes, num_filters, crop)
    "tiny-bottleneck": (JaxBottleneck, BottleneckBlock, [1, 1], 8, 32),
    "resnet50-2block": (JaxBottleneck, BottleneckBlock, [1, 1], 64, 32),
    "tiny-basic": (JaxBasic, ResNetBlock, [1, 1], 8, 32),
}
LEVELS = (False, True, "pallas")
NUM_CLASSES = 7


def _flax_variables(jm, x, seed=1):
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x)))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    rng = np.random.default_rng(seed)
    for name, block in params.items():
        last = {"BottleneckBlock": "BatchNorm_2", "ResNetBlock": "BatchNorm_1"}.get(
            name.rsplit("_", 1)[0])
        if last:
            scale = block[last]["scale"]
            block[last]["scale"] = rng.normal(1.0, 0.2, scale.shape).astype(np.float32)
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _pair(geometry, fused, torch_padding=False, batch=2):
    jblock, tblock, stages, nf, crop = GEOMETRIES[geometry]
    x = np.random.default_rng(0).normal(size=(batch, crop, crop, 3)).astype(np.float32)
    jm = JaxResNet(stage_sizes=stages, block_cls=jblock, num_classes=NUM_CLASSES,
                   num_filters=nf, dtype=jnp.float32, fused_bn=fused,
                   torch_padding=torch_padding)
    variables = _flax_variables(jm, x)
    tm = ResNet(stage_sizes=stages, block_cls=tblock, num_classes=NUM_CLASSES, num_filters=nf,
                dtype=torch.float32, fused_bn=fused, torch_padding=torch_padding)
    tm.load_state_dict(resnet_state_from_flax(variables))  # strict: every key
    return jm, variables, tm, x


def _cases():
    for geometry in GEOMETRIES:
        for fused in LEVELS:
            if fused == "pallas" and geometry == "tiny-basic":
                continue
            yield geometry, fused


@pytest.mark.parametrize("geometry,fused", list(_cases()))
def test_train_forward_stats_grads_and_eval_match_flax(geometry, fused):
    jm, variables, tm, x = _pair(geometry, fused)
    labels = np.array([1, 3])

    def loss(params):
        logits, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(labels, NUM_CLASSES)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1)), (logits, upd)

    (_, (j_logits, j_upd)), j_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    tm.train()
    t_logits = tm(torch.from_numpy(x))
    F.cross_entropy(t_logits, torch.from_numpy(labels)).backward()

    np.testing.assert_allclose(t_logits.detach(), j_logits, rtol=1e-5, atol=1e-5)
    want_stats = resnet_state_from_flax(
        {"params": variables["params"], "batch_stats": j_upd["batch_stats"]})
    got = tm.state_dict()
    for key, value in want_stats.items():
        if "running" in key:
            np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-6, err_msg=key)
    want_grads = resnet_state_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, j_grads),
         "batch_stats": variables["batch_stats"]})
    for name, p in tm.named_parameters():
        want = want_grads[name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 5e-4, f"{name}: grad rel err {err}"
    fused_site = tm.layer1[0].conv3.weight.grad if geometry != "tiny-basic" else None
    if fused_site is not None:
        assert fused_site.abs().max() > 0  # the backward of the fused site ran

    # Eval follows the running statistics (flax's untouched ones).
    tm.load_state_dict(resnet_state_from_flax(variables))
    tm.eval()
    with torch.no_grad():
        t_eval = tm(torch.from_numpy(x))
    j_eval = jm.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(t_eval, j_eval, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", LEVELS)
def test_torch_padding_matches_flax(fused):
    jm, variables, tm, x = _pair("tiny-bottleneck", fused, torch_padding=True)
    tm.train()
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach(),
        jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])[0],
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,k,stride,want", [
    (224, 7, 2, (2, 3)),   # the stem on 224
    (112, 3, 2, (0, 1)),   # the max-pool and a 3x3 stride-2 conv on an even input
    (56, 1, 2, (0, 0)),    # a stride-2 projection
    (7, 3, 2, (1, 1)),     # odd input
    (56, 3, 1, (1, 1)),    # stride 1
])
def test_same_padding_is_xla_s(size, k, stride, want):
    assert _same_pad(size, k, stride) == want


@pytest.mark.parametrize("crop", [32, 33])
def test_stride2_padding_at_odd_and_even_sizes_matches_flax(crop):
    """Odd and even inputs take different SAME pads at every stride-2 op."""
    jm = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck, num_classes=NUM_CLASSES,
                   num_filters=8, dtype=jnp.float32, fused_bn="pallas")
    x = np.random.default_rng(3).normal(size=(2, crop, crop, 3)).astype(np.float32)
    variables = _flax_variables(jm, x)
    tm = ResNet(stage_sizes=[1, 1], num_classes=NUM_CLASSES, num_filters=8,
                dtype=torch.float32, fused_bn="pallas")
    tm.load_state_dict(resnet_state_from_flax(variables))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got, jm.apply(variables, jnp.asarray(x), train=False),
                               rtol=1e-5, atol=1e-5)


def test_state_from_flax_agrees_with_export_torchvision(tmp_path):
    jm, variables, tm, x = _pair("tiny-bottleneck", "pallas")
    exported = export_torchvision(variables, jm, tmp_path / "w.npz")
    ours = resnet_state_from_flax(variables)
    assert sorted(exported) == sorted(ours) == sorted(tm.state_dict())
    for key, value in exported.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    loaded = dict(np.load(tmp_path / "w.npz"))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in loaded.items()})


def test_resnet50_keys_follow_torchvision():
    keys = set(ResNet50(num_classes=1000).state_dict())
    # torchvision's resnet50 state_dict has 320 keys, 53 of them
    # num_batches_tracked, which the port's BatchNorm does not keep.
    assert len(keys) == 267
    for key in ("conv1.weight", "bn1.running_var", "layer1.0.conv3.weight",
                "layer1.0.downsample.0.weight", "layer1.0.downsample.1.running_mean",
                "layer3.5.bn2.bias", "layer4.2.bn3.weight", "fc.weight", "fc.bias"):
        assert key in keys


def test_pallas_level_needs_bottleneck_blocks():
    with pytest.raises(ValueError, match="BottleneckBlock"):
        ResNet18(num_classes=4, num_filters=8, fused_bn="pallas")


def test_seeded_init_follows_flax_kinds():
    model = ResNet(stage_sizes=[1, 1], num_classes=NUM_CLASSES, num_filters=8)
    a, b = init_resnet_state(model, 0), init_resnet_state(model, 0)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], init_resnet_state(model, 1)["conv1.weight"])
    w = a["layer2.0.conv2.weight"]  # fan_in 16 * 3 * 3
    assert abs(w.std().item() * 12.0 - 1.0) < 0.1
    assert w.abs().max().item() <= 2.0 / 12.0 / 0.87962566103423978 + 1e-6
    assert (a["layer1.0.bn3.weight"] == 0).all() and (a["layer1.0.bn1.weight"] == 1).all()
    assert (a["fc.bias"] == 0).all() and (a["layer1.0.bn2.running_var"] == 1).all()
    seeded = seeded_resnet(0, device="cpu", stage_sizes=[1, 1], num_classes=NUM_CLASSES,
                           num_filters=8)
    assert torch.equal(seeded.state_dict()["conv1.weight"], a["conv1.weight"])
    assert seeded.training
