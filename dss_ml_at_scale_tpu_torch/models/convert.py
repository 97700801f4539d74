"""Weights for the port's TransformerLM: carried over from flax, or seeded.

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
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

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
