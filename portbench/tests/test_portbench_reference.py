"""The references at a tiny width: against plain forwards written here from
``torch.nn.functional``'s own layers, against the port's models computed
in float32 (the same equations), and the control's rounding."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from portbench import spec, weights
from portbench.reference._plain import Precision, cross_entropy, train_readings
from portbench.tests.tiny import TINY


def _config(name):
    c = spec.load_json("configs", name)
    c.update(TINY[name])
    return c


def _reference(name, crop, dtype=torch.float64, seed=5):
    mod = spec.load_module("reference", name)
    config = _config(name)
    model = mod.Reference(config, crop, device="cpu")
    state = weights.draw(mod.weight_specs(config, crop), seed, "cpu")
    model.load_state_dict(state)
    return model.to(dtype), state, config


def _tf_same(x, k, stride):
    h, w = x.shape[2], x.shape[3]
    ph = max((math.ceil(h / stride) - 1) * stride + k - h, 0)
    pw = max((math.ceil(w / stride) - 1) * stride + k - w, 0)
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def _plain_resnet(state, config, x):
    """ResNet forward from ``F.conv2d`` / ``F.batch_norm`` / ``F.max_pool2d``
    over the state dict, TensorFlow SAME padding computed here."""
    def conv(x, name, stride):
        w = state[name]
        t, b, l, r = _tf_same(x, w.shape[-1], stride)
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)

    def bn(x, name):
        return F.batch_norm(x, None, None, state[f"{name}.weight"], state[f"{name}.bias"],
                            training=True, eps=config["bn_eps"])

    x = x.permute(0, 3, 1, 2)
    x = F.relu(bn(conv(x, "conv1.weight", 2), "bn1"))
    t, b, l, r = _tf_same(x, 3, 2)
    x = F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), 3, 2)
    for i, count in enumerate(config["stage_sizes"]):
        for j in range(count):
            p = f"layer{i + 1}.{j}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(bn(conv(x, f"{p}.conv1.weight", 1), f"{p}.bn1"))
            y = F.relu(bn(conv(y, f"{p}.conv2.weight", stride), f"{p}.bn2"))
            y = bn(conv(y, f"{p}.conv3.weight", 1), f"{p}.bn3")
            if f"{p}.downsample.0.weight" in state:
                x = bn(conv(x, f"{p}.downsample.0.weight", stride), f"{p}.downsample.1")
            x = F.relu(y + x)
    return F.linear(x.mean((2, 3)), state["fc.weight"], state["fc.bias"])


def _plain_vit(state, config, x):
    """ViT forward from ``F.layer_norm``, ``F.scaled_dot_product_attention``
    and ``F.gelu`` over the state dict."""
    d, heads, eps = config["hidden_size"], config["num_heads"], config["layer_norm_eps"]
    p = config["patch_size"]
    x = F.conv2d(x.permute(0, 3, 1, 2), state["patch_embed.weight"], state["patch_embed.bias"],
                 stride=p).flatten(2).transpose(1, 2)
    b = x.shape[0]
    x = torch.cat([state["cls_token"].expand(b, 1, d), x], 1) + state["pos_embed"]
    for i in range(config["num_layers"]):
        s = {k[len(f"blocks.{i}."):]: v for k, v in state.items() if k.startswith(f"blocks.{i}.")}
        h = F.layer_norm(x, (d,), s["ln_attn.weight"], s["ln_attn.bias"], eps)
        q, k, v = (F.linear(h, s[f"{n}.weight"], s[f"{n}.bias"]).view(b, -1, heads, d // heads)
                   .transpose(1, 2) for n in "qkv")
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, -1, d)
        x = x + F.linear(o, s["attn_out.weight"], s["attn_out.bias"])
        h = F.layer_norm(x, (d,), s["ln_mlp.weight"], s["ln_mlp.bias"], eps)
        x = x + F.linear(F.gelu(F.linear(h, s["mlp_in.weight"], s["mlp_in.bias"])),
                         s["mlp_out.weight"], s["mlp_out.bias"])
    x = F.layer_norm(x, (d,), state["ln_final.weight"], state["ln_final.bias"], eps)
    return F.linear(x[:, 0], state["head.weight"], state["head.bias"])


@pytest.mark.parametrize("name,plain", [("resnet50", _plain_resnet), ("vit_s16", _plain_vit)])
def test_reference_against_plain_forward(name, plain):
    model, state, config = _reference(name, 32)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    state64 = {k: v.double() for k, v in state.items()}
    torch.testing.assert_close(model(x), plain(state64, config, x), rtol=1e-9, atol=1e-9)


def test_reference_running_statistics_follow_flax_momentum():
    model, _, _ = _reference("resnet50", 32)
    x = torch.randn(4, 32, 32, 3, dtype=torch.float64)
    model(x)
    y = F.pad(x.permute(0, 3, 1, 2), _tf_same_pad_args(x))
    y = F.conv2d(y, model.conv1.weight, stride=2)
    mean, var = y.mean((0, 2, 3)), y.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(model.bn1.running_mean, 0.1 * mean)
    torch.testing.assert_close(model.bn1.running_var, 0.9 + 0.1 * var)


def _tf_same_pad_args(x):
    t, b, l, r = _tf_same(x.permute(0, 3, 1, 2), 7, 2)
    return (l, r, t, b)


def _port_f32(name, config, crop):
    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from dss_ml_at_scale_tpu_torch.models.vit import ViT

    if name == "resnet50":
        return ResNet(stage_sizes=config["stage_sizes"], block_cls=BottleneckBlock,
                      num_classes=config["num_classes"], num_filters=config["num_filters"],
                      dtype=torch.float32, fused_bn="pallas")
    return ViT(config["num_classes"], image_size=crop, patch=config["patch_size"],
               dim=config["hidden_size"], depth=config["num_layers"],
               num_heads=config["num_heads"], dtype=torch.float32)


@pytest.mark.parametrize("name", ["resnet50", "vit_s16"])
def test_reference_computes_the_ports_model(name):
    """The same state in the port's model at float32: logits and the three
    steps' readings agree to float32 rounding."""
    model, state, config = _reference(name, 32, dtype=torch.float32)
    port = _port_f32(name, config, 32)
    port.load_state_dict(state, strict=True)
    gen = torch.Generator().manual_seed(2)
    batches = [{"image": torch.randn(6, 32, 32, 3, generator=gen),
                "label": torch.randint(0, config["num_classes"], (6,), generator=gen)}
               for _ in range(3)]
    torch.testing.assert_close(port(batches[0]["image"]), model(batches[0]["image"]),
                               rtol=1e-4, atol=1e-4)
    ref = train_readings(model, batches, 1e-3)
    port_ref = train_readings(port, batches, 1e-3)
    assert ref.losses == pytest.approx(port_ref.losses, rel=1e-5)
    for key in ref.grad:
        assert port_ref.grad[key] == pytest.approx(ref.grad[key], rel=1e-3, abs=1e-6), key


def test_cross_entropy_is_the_mean_nll():
    logits = torch.randn(5, 7, dtype=torch.float64)
    labels = torch.tensor([0, 3, 6, 2, 2])
    torch.testing.assert_close(cross_entropy(logits, labels), F.cross_entropy(logits, labels))


def test_float8_control_rounds_operands_and_gradients():
    x = torch.randn(1000, dtype=torch.float32, requires_grad=True)
    y = Precision("float8").act(x)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).max().item()
    assert 0 < rel <= 2 ** -4 + 1e-6 or (y - x).abs().max() < 1e-2
    assert len(torch.unique(y.detach())) < 260  # e4m3 has 253 finite values
    g = torch.randn(1000)
    y.backward(g)
    assert len(torch.unique(x.grad)) < 260 and not torch.equal(x.grad, g)
    assert Precision(None).act(x) is x
    with pytest.raises(ValueError):
        Precision("int4")
