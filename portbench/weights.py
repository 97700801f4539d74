"""Weights drawn on the device from the run's seed, in a few large calls.

A configuration's reference names every tensor of the training state and
says how it is drawn: ``("normal", std)`` or ``("const", value)``. One
``randn`` over all of them, on the card's own generator, and one
multiply-add by per-element scales give a flat float32 buffer; each tensor
is a view of it. The same seed gives the same tensors, which both the port
and the reference are given.
"""

from __future__ import annotations

import math

import torch

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one of the run's streams (0 weights, 1
    traffic): the same run seed always gives the same streams, and any
    whole number up to 2**63 is taken."""
    return (int(seed) * 2654435761 + stream * 0x9E3779B97F4A7C15) & _MASK64


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def draw(specs: list[tuple[str, tuple, tuple]], seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` (float32 on ``device``) for ``specs`` of
    ``(name, shape, init)``."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    stds = torch.tensor([float(init[1]) if init[0] == "normal" else 0.0 for _, _, init in specs])
    consts = torch.tensor([float(init[1]) if init[0] == "const" else 0.0 for _, _, init in specs])
    counts = torch.tensor(sizes)
    flat = torch.randn(sum(sizes), generator=generator(seed, 0, device), device=device)
    flat.mul_(torch.repeat_interleave(stds.to(device), counts.to(device)))
    flat.add_(torch.repeat_interleave(consts.to(device), counts.to(device)))
    out, at = {}, 0
    for (name, shape, _), size in zip(specs, sizes):
        out[name] = flat[at:at + size].view(shape)
        at += size
    return out
