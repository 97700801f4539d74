"""The port's torchvision-layout loader and exporter vs the JAX package's
(``models/pretrained.py``), on seeded weights (no download).

The JAX package's ``export_torchvision`` writes a ``.npz`` from seeded flax
variables; the port loads it and its eval logits agree with the flax
model's at rtol 1e-4 / atol 5e-4 (``tests/test_pretrained.py:489``). The
port's ``export_torchvision`` writes its own model, and the JAX loader
reads it back within atol 1e-6. Head re-initialization, backbone-only
files, a missing key, a shape mismatch, the wrapper prefixes and
Lightning's envelope are checked as the JAX tests check them, and
``train --pretrained`` fine-tunes from such a file.
"""

import argparse
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.models import pretrained as jax_pretrained
from dss_ml_at_scale_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from dss_ml_at_scale_tpu.models.resnet import ResNet as JaxResNet
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.models import pretrained, resnet_state_from_flax, seeded_resnet
from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock

CROP = 32


def _jax_model(num_classes=4):
    return JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck, num_filters=8,
                     num_classes=num_classes, dtype=jnp.float32, torch_padding=True)


def _port_model(num_classes=4, seed=5):
    return seeded_resnet(seed, device="cpu", stage_sizes=[1, 1], block_cls=BottleneckBlock,
                         num_filters=8, num_classes=num_classes, dtype=torch.float32,
                         torch_padding=True).eval()


def _seeded_variables(jm, seed=1):
    """Seeded flax variables with every leaf drawn (BN statistics too)."""
    x = jnp.zeros((1, CROP, CROP, 3))
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(seed), x))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1])
        if "var" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (leaf + rng.normal(0.0, 0.05, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _images(n=2):
    return np.random.default_rng(0).normal(size=(n, CROP, CROP, 3)).astype(np.float32)


def test_jax_export_loads_into_the_port_with_the_same_logits(tmp_path):
    jm = _jax_model()
    variables = _seeded_variables(jm)
    path = tmp_path / "w.npz"
    jax_pretrained.export_torchvision(variables, jm, path)
    model = _port_model()
    loaded = pretrained.load_pretrained_resnet(path, model)
    assert set(loaded) == set(model.state_dict())
    x = _images()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4)
    # And every tensor is flax's, by the port's own converter too.
    for name, value in resnet_state_from_flax(variables).items():
        np.testing.assert_array_equal(model.state_dict()[name], value, err_msg=name)


def test_port_export_loads_into_jax(tmp_path):
    model = _port_model()
    with torch.no_grad():  # nonzero statistics and last BN scales
        for name, t in model.state_dict().items():
            if "running" in name or name.endswith("bn3.weight"):
                t.copy_(torch.rand(t.shape) + 0.5)
    path = tmp_path / "port.npz"
    out = pretrained.export_torchvision(model, path)
    assert set(out) == set(model.state_dict())
    jm = _jax_model()
    variables = jax_pretrained.load_pretrained_resnet(path, jm, image_size=CROP)
    x = _images()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4)
    back = resnet_state_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(back[name], value, rtol=0, atol=1e-6, err_msg=name)


def test_export_refuses_a_path_without_npz(tmp_path):
    with pytest.raises(ValueError, match=".npz"):
        pretrained.export_torchvision(_port_model(), tmp_path / "w.pt")


def test_head_of_another_class_count_is_fresh(tmp_path):
    source = _port_model(num_classes=4, seed=7)
    path = tmp_path / "w.npz"
    pretrained.export_torchvision(source, path)
    model = _port_model(num_classes=7)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    pretrained.load_pretrained_resnet(path, model)
    got = model.state_dict()
    assert torch.equal(got["conv1.weight"], source.state_dict()["conv1.weight"])
    assert got["fc.weight"].shape == (7, 64)
    assert torch.equal(got["fc.weight"], fresh["fc.weight"])
    assert torch.equal(got["fc.bias"], fresh["fc.bias"])


def test_backbone_only_file_gets_a_fresh_head(tmp_path):
    state = {k: v.numpy() for k, v in _port_model(seed=7).state_dict().items()
             if not k.startswith("fc.")}
    path = tmp_path / "backbone.npz"
    np.savez(path, **state)
    model = _port_model()
    fresh_fc = model.fc.weight.detach().clone()
    pretrained.load_pretrained_resnet(path, model)
    np.testing.assert_array_equal(model.state_dict()["conv1.weight"], state["conv1.weight"])
    assert torch.equal(model.fc.weight, fresh_fc)


def test_missing_key_raises(tmp_path):
    state = {k: v.numpy() for k, v in _port_model().state_dict().items()}
    del state["layer1.0.conv2.weight"]
    np.savez(tmp_path / "w.npz", **state)
    with pytest.raises(KeyError, match="layer1.0.conv2.weight"):
        pretrained.load_pretrained_resnet(tmp_path / "w.npz", _port_model())


def test_shape_mismatch_raises(tmp_path):
    state = {k: v.numpy() for k, v in _port_model().state_dict().items()}
    state["layer1.0.conv1.weight"] = np.zeros((3, 3, 1, 1), np.float32)
    np.savez(tmp_path / "w.npz", **state)
    with pytest.raises(ValueError, match="layer1.0.conv1.weight"):
        pretrained.load_pretrained_resnet(tmp_path / "w.npz", _port_model())


@pytest.mark.parametrize("prefix", ["", "model.", "module.", "backbone.net."])
@pytest.mark.parametrize("lightning", [False, True])
def test_torch_files_with_wrappers_load(tmp_path, prefix, lightning):
    source = _port_model(seed=9)
    state = {prefix + k: v for k, v in source.state_dict().items()}
    state[prefix + "layer1.0.bn1.num_batches_tracked"] = torch.tensor(3)  # ignored
    payload = ({"state_dict": state, "epoch": 2,
                "hyper_parameters": argparse.Namespace(lr=1e-5, batch_size=212)}
               if lightning else state)
    path = tmp_path / ("ckpt.pth" if lightning else "w.pt")
    torch.save(payload, path)
    loaded = pretrained.load_state_dict(path)
    assert "conv1.weight" in loaded and "fc.weight" in loaded
    assert set(loaded) == set(jax_pretrained.load_state_dict(path))
    model = _port_model()
    pretrained.load_pretrained_resnet(path, model)
    for name, value in source.state_dict().items():
        assert torch.equal(model.state_dict()[name], value), name


def test_strip_prefix_needs_a_module_boundary():
    state = {"aux_fc.weight": 1, "fc.bias": 2}
    assert pretrained._strip_wrapper_prefix(state) == state
    assert (pretrained._strip_wrapper_prefix(state)
            == jax_pretrained._strip_wrapper_prefix(state))
    two = {"a.fc.weight": 1, "b.fc.weight": 2}  # ambiguous: left alone
    assert pretrained._strip_wrapper_prefix(two) == two


def test_train_fine_tunes_from_a_pretrained_file(tmp_path):
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model

    table, ckpt = str(tmp_path / "t"), tmp_path / "ckpt"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["datagen", "images", "--out", table, "--n", "16", "--classes", "4",
                         "--size", "32"]) == 0
    source = build_classifier_model("tiny", num_classes=4, torch_padding=True, device="cpu")
    with torch.no_grad():
        source.conv1.weight.mul_(-1.5)
    pretrained.export_torchvision(source, tmp_path / "w.npz")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", "--data", table, "--model", "tiny", "--batch-size", "8",
                         "--crop", "32", "--num-classes", "4", "--epochs", "1",
                         "--device", "cpu", "--workers", "1", "--learning-rate", "0",
                         "--pretrained", str(tmp_path / "w.npz"),
                         "--checkpoint-dir", str(ckpt)]) == 0
    assert json.loads(out.getvalue().strip().splitlines()[-1])["steps"] == 2
    meta = json.loads((ckpt / "dsst_model.json").read_text())
    assert meta["torch_padding"] is True  # --pretrained turns it on
    state = torch.load(ckpt / "2" / "state.pt", weights_only=True)["model"]
    # At learning rate 0 the weights are the file's.
    assert torch.equal(state["conv1.weight"], source.state_dict()["conv1.weight"])
