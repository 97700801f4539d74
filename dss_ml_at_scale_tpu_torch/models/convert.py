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
seeded LeCun-normal weights of the kinds flax draws; :func:`vit_state_from_flax`
and :func:`seeded_vit` for the ViT.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from .resnet import ResNet
from .transformer import TransformerLM
from .vit import ViT


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

    def carry(take, flat):
        take("tok_embed/embedding", "tok_embed.weight")
        take("pos_embed", "pos_embed")
        n_layers = len({k.split("/")[0] for k in flat if k.startswith("block_")})
        for i in range(n_layers):
            _take_block(take, flat, f"block_{i}/", f"blocks.{i}.")
        take("RMSNorm_0/scale", "norm.scale")
        take("lm_head/kernel", "lm_head.weight", transpose=True)

    return _carry(params, carry)


def _carry(params: Mapping, carry) -> dict[str, torch.Tensor]:
    """``carry(take, flat)`` takes each flax param (``flat``, by ``/``-joined
    key) onto a port name, kernels transposed; every param must be taken."""
    flat = _flatten(params.get("params", params))
    out: dict[str, torch.Tensor] = {}

    def take(src: str, dst: str, transpose: bool = False) -> None:
        a = flat.pop(src).astype(np.float32)
        out[dst] = torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))

    carry(take, flat)
    if flat:
        raise ValueError(f"flax params not carried over: {sorted(flat)}")
    return out


def _take_block(take, flat: Mapping, src: str, dst: str) -> None:
    """One flax ``TransformerBlock``'s params (keys under ``src``), dense or
    MoE, onto the port's names under ``dst``."""
    take(f"{src}RMSNorm_0/scale", f"{dst}norm1.scale")
    take(f"{src}qkv/kernel", f"{dst}qkv.weight", transpose=True)
    take(f"{src}proj/kernel", f"{dst}proj.weight", transpose=True)
    take(f"{src}RMSNorm_1/scale", f"{dst}norm2.scale")
    if f"{src}moe/router/kernel" in flat:
        take(f"{src}moe/router/kernel", f"{dst}moe.router.weight", transpose=True)
        for name in ("w_up", "b_up", "w_down", "b_down"):
            take(f"{src}moe/{name}", f"{dst}moe.{name}")
        return
    for name in ("mlp_up", "mlp_down"):
        take(f"{src}{name}/kernel", f"{dst}{name}.weight", transpose=True)
        take(f"{src}{name}/bias", f"{dst}{name}.bias")


def block_state_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """One flax ``TransformerBlock``'s params -> the port's
    ``TransformerBlock`` ``state_dict``, as f32 CPU tensors."""
    return _carry(params, lambda take, flat: _take_block(take, flat, "", ""))


def init_lm_state(model: TransformerLM, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``model``, as an f32 CPU ``state_dict``.

    Like flax's defaults: Dense kernels (every Linear weight, the MoE
    router and ``lm_head``) LeCun-normal, a normal of std
    ``1/sqrt(fan_in)`` truncated at two deviations and rescaled by
    ``1/0.87962566`` as flax's ``variance_scaling`` does (as
    :func:`init_resnet_state`); the MoE expert kernels ``[E, d, h]`` and
    ``[E, h, d]`` too, with flax's fan-in of a 3-D kernel, which counts the
    expert axis as receptive field (``E * d`` and ``E * h``); biases
    (``b_up``, ``b_down`` too) zero, RMSNorm scales one, the position table
    normal(0.02), the token table an untruncated normal with std
    ``1/sqrt(vocab)`` (``nn.Embed``).
    """
    gen = torch.Generator().manual_seed(int(seed))
    return {name: _init_tensor(name, tuple(p.shape), gen)
            for name, p in model.state_dict().items()}


def _init_tensor(name: str, shape: tuple, gen: torch.Generator) -> torch.Tensor:
    """One parameter of :func:`init_lm_state`, drawn from ``gen``."""
    if name.endswith((".bias", ".b_up", ".b_down")):
        return torch.zeros(shape)
    if name.endswith("scale"):
        return torch.ones(shape)
    if name == "pos_embed":
        return torch.randn(shape, generator=gen) * 0.02
    if name == "tok_embed.weight":
        return torch.randn(shape, generator=gen) / math.sqrt(shape[0])
    # A Linear weight [out, in], or an expert kernel [E, in, out].
    fan_in = shape[0] * shape[1] if name.endswith((".w_up", ".w_down")) else shape[1]
    t = torch.empty(shape)
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return t


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


def vit_state_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``ViT`` params (with or without the outer ``"params"``) -> the
    port's ``state_dict``, as f32 CPU tensors: the patch kernel HWIO ->
    OIHW, Dense kernels transposed, LayerNorm ``scale`` -> ``weight``."""
    flat = _flatten(params.get("params", params))
    out: dict[str, torch.Tensor] = {}

    def take(src: str, dst: str, transpose: bool = False) -> None:
        a = flat.pop(src).astype(np.float32)
        out[dst] = torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))

    out["patch_embed.weight"] = _hwio_to_oihw(flat.pop("patch_embed/kernel"))
    take("patch_embed/bias", "patch_embed.bias")
    take("cls_token", "cls_token")
    take("pos_embed", "pos_embed")
    depth = len({k.split("/")[0] for k in flat if k.startswith("block_")})
    for i in range(depth):
        for name in ("ln_attn", "ln_mlp"):
            take(f"block_{i}/{name}/scale", f"blocks.{i}.{name}.weight")
            take(f"block_{i}/{name}/bias", f"blocks.{i}.{name}.bias")
        for name in ("q", "k", "v", "attn_out", "mlp_in", "mlp_out"):
            take(f"block_{i}/{name}/kernel", f"blocks.{i}.{name}.weight", transpose=True)
            take(f"block_{i}/{name}/bias", f"blocks.{i}.{name}.bias")
    take("ln_final/scale", "ln_final.weight")
    take("ln_final/bias", "ln_final.bias")
    take("head/kernel", "head.weight", transpose=True)
    take("head/bias", "head.bias")
    if flat:
        raise ValueError(f"flax params not carried over: {sorted(flat)}")
    return out


def init_vit_state(model: ViT, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``model``, as an f32 CPU ``state_dict``,
    of the kinds flax draws: Dense and patch kernels LeCun-normal (the
    truncated normal of :func:`init_lm_state`, fan-in ``in`` for a Linear
    and ``patch^2 * 3`` for the patch conv), biases zero, LayerNorm scales
    one, ``cls_token`` zero, ``pos_embed`` normal(0.02)."""
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, t in model.state_dict().items():
        t = torch.zeros(tuple(t.shape))
        if name == "pos_embed":
            t = torch.randn(tuple(t.shape), generator=gen) * 0.02
        elif name.split(".")[-2:][0].startswith("ln_"):  # a LayerNorm
            if name.endswith(".weight"):
                t.fill_(1.0)
        elif name.endswith(".weight"):
            std = 1.0 / math.sqrt(math.prod(t.shape[1:])) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        state[name] = t
    return state


def seeded_vit(seed: int = 0, *, device="cuda", preset=ViT, **config) -> ViT:
    """``preset(**config)`` (``ViT`` or one of its presets, ``vit_s16``...)
    on ``device`` with :func:`init_vit_state` weights."""
    model = preset(device="meta", **config)
    model = model.to_empty(device=device)
    model.load_state_dict(init_vit_state(model, seed))
    return model
