"""Weights for the port's models: carried over from flax, or seeded.

:func:`lm_state_from_flax` maps the JAX package's parameter tree onto the
port's ``state_dict``, so a test can hand both models the same weights. A
flax ``Dense`` kernel is ``[in, out]`` and a torch ``Linear.weight``
``[out, in]``, so every kernel is transposed; everything else is carried as
it is.

:func:`init_lm_state` is the port's own seeded init, for serving without
JAX (the JAX CLI serves random weights from ``--seed`` too; there is no LM
checkpoint format yet). It draws from a CPU ``torch.Generator``, so the
same seed gives the same weights on every device. It follows flax's
initialisers in kind, not in bits: ``jax.random`` and torch draw different
numbers from one seed.

:func:`resnet_state_from_flax` and :func:`seeded_resnet` do the same for the
ResNet: flax's ``params``/``batch_stats`` onto torchvision's key names, and
seeded LeCun-normal weights of the kinds flax draws.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from .resnet import ResNet
from .transformer import TransformerLM


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def lm_state_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``TransformerLM`` params (nested, or flat with ``/``-joined
    keys; with or without the outer ``"params"``) -> the port's
    ``state_dict``, as f32 CPU tensors."""
    flat = _flatten(params.get("params", params))
    out: dict[str, torch.Tensor] = {}

    def take(src: str, dst: str, transpose: bool = False) -> None:
        a = flat.pop(src).astype(np.float32)
        out[dst] = torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))

    take("tok_embed/embedding", "tok_embed.weight")
    take("pos_embed", "pos_embed")
    n_layers = len({k.split("/")[0] for k in flat if k.startswith("block_")})
    for i in range(n_layers):
        src, dst = f"block_{i}", f"blocks.{i}"
        take(f"{src}/RMSNorm_0/scale", f"{dst}.norm1.scale")
        take(f"{src}/qkv/kernel", f"{dst}.qkv.weight", transpose=True)
        take(f"{src}/proj/kernel", f"{dst}.proj.weight", transpose=True)
        take(f"{src}/RMSNorm_1/scale", f"{dst}.norm2.scale")
        for name in ("mlp_up", "mlp_down"):
            take(f"{src}/{name}/kernel", f"{dst}.{name}.weight", transpose=True)
            take(f"{src}/{name}/bias", f"{dst}.{name}.bias")
    take("RMSNorm_0/scale", "norm.scale")
    take("lm_head/kernel", "lm_head.weight", transpose=True)
    if flat:
        raise ValueError(f"flax params not carried over: {sorted(flat)}")
    return out


def init_lm_state(model: TransformerLM, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``model``, as an f32 CPU ``state_dict``.

    Like flax's defaults: Dense kernels LeCun-normal (std
    ``1/sqrt(fan_in)``), biases zero, RMSNorm scales one, the position
    table normal(0.02), the token table normal with std
    ``1/sqrt(vocab)``.
    """
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith(".bias"):
            t = torch.zeros(shape)
        elif name.endswith("scale"):
            t = torch.ones(shape)
        elif name == "pos_embed":
            t = torch.randn(shape, generator=gen) * 0.02
        elif name == "tok_embed.weight":
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        else:  # Linear weight [out, in]
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[1])
        state[name] = t
    return state


def seeded_lm(seed: int = 0, *, device="cuda", **config) -> TransformerLM:
    """A ``TransformerLM(**config)`` on ``device`` with :func:`init_lm_state`
    weights — what ``serve-lm`` serves."""
    model = TransformerLM(device="meta", **config)
    model = model.to_empty(device=device)
    model.load_state_dict(init_lm_state(model, seed))
    return model.eval()


def _hwio_to_oihw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)), np.float32))


def resnet_state_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ResNet ``{"params", "batch_stats"}`` (any of the three
    ``fused_bn`` levels; the pallas site's ``Conv_2`` is the block's third
    conv) -> the port's ``state_dict``, as f32 CPU tensors.

    Conv kernels go HWIO -> OIHW, the Dense kernel ``[in, out]`` ->
    ``[out, in]``, BN ``scale/bias/mean/var`` -> ``weight/bias/
    running_mean/running_var``. Blocks are grouped into ``layer1..4`` by
    the width of their first conv, which each stage doubles.
    """
    params = {k: v for k, v in variables["params"].items()}
    stats = dict(variables.get("batch_stats", {}))
    out: dict[str, torch.Tensor] = {}

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32))  # a writable copy

    def bn(dst: str, src: str, p: Mapping, s: Mapping) -> None:
        out[f"{dst}.weight"] = f32(p[src]["scale"])
        out[f"{dst}.bias"] = f32(p[src]["bias"])
        out[f"{dst}.running_mean"] = f32(s[src]["mean"])
        out[f"{dst}.running_var"] = f32(s[src]["var"])

    out["conv1.weight"] = _hwio_to_oihw(np.asarray(params["conv_init"]["kernel"]))
    bn("bn1", "norm_init", params, stats)
    blocks = sorted(
        (k for k in params if k.startswith(("BottleneckBlock_", "ResNetBlock_"))),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    layer, index, width = 0, 0, None
    for name in blocks:
        p, s = params[name], stats.get(name, {})
        w = np.asarray(p["Conv_0"]["kernel"]).shape[-1]
        if w != width:
            layer, index, width = layer + 1, 0, w
        prefix = f"layer{layer}.{index}"
        index += 1
        for sub in p:
            if sub.startswith("Conv_"):
                out[f"{prefix}.conv{int(sub[5:]) + 1}.weight"] = _hwio_to_oihw(
                    np.asarray(p[sub]["kernel"]))
            elif sub.startswith("BatchNorm_"):
                bn(f"{prefix}.bn{int(sub[10:]) + 1}", sub, p, s)
            elif sub == "conv_proj":
                out[f"{prefix}.downsample.0.weight"] = _hwio_to_oihw(
                    np.asarray(p[sub]["kernel"]))
            elif sub == "norm_proj":
                bn(f"{prefix}.downsample.1", sub, p, s)
            else:
                raise ValueError(f"flax module {name}/{sub} has no port counterpart")
    dense = params["Dense_0"]
    out["fc.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(dense["kernel"], np.float32).T))
    out["fc.bias"] = f32(dense["bias"])
    return out


def init_resnet_state(model: ResNet, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``model``, as an f32 CPU ``state_dict``.

    Like flax's defaults: conv and head kernels LeCun-normal (a normal of
    std ``1/sqrt(fan_in)`` truncated at two deviations, rescaled as flax's
    ``variance_scaling`` does), the head bias zero, and the model's own BN
    init (scale one, the last BN of each block zero; bias, mean zero; var
    one).
    """
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, t in model.state_dict().items():
        t = t.detach().to("cpu", torch.float32).clone()
        if name.endswith(".weight") and t.ndim in (2, 4):
            fan_in = math.prod(t.shape[1:])
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        elif name.endswith(".bias"):
            t.zero_()
        state[name] = t
    return state


def seeded_resnet(seed: int = 0, *, device="cuda", **config) -> ResNet:
    """A ``ResNet(**config)`` on ``device`` with :func:`init_resnet_state`
    weights, in train mode."""
    model = ResNet(**config)
    model.load_state_dict(init_resnet_state(model, seed))
    return model.to(device)
