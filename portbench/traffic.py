"""The one generator of traffic: a mix's parameters (``traffic/<name>.json``)
in, the device-resident inputs of a run out.

A ``closed_train`` mix is a training job's feed: ``pool`` distinct batches
of ``batch`` images, ``crop`` pixels a side, NHWC float32 drawn N(0, 1),
with labels uniform over the configuration's classes, all drawn on the
device from the run's seed in two calls. The run cycles through the pool,
dispatching each step as soon as the last one is queued. Every seed draws
the same sizes; only the values differ.
"""

from __future__ import annotations

import torch

from .weights import generator

KINDS = ("closed_train",)


def make_pool(traffic: dict, num_classes: int, seed: int, device) -> list[dict]:
    if traffic.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {traffic.get('kind')!r} is not one of {KINDS}")
    n, b, crop = int(traffic["pool"]), int(traffic["batch"]), int(traffic["crop"])
    if n < 4:
        raise ValueError("the check's first three steps and the window need a pool of 4 or more")
    gen = generator(seed, 1, device)
    images = torch.randn((n, b, crop, crop, 3), generator=gen, device=device)
    labels = torch.randint(0, num_classes, (n, b), generator=gen, device=device)
    return [{"image": images[i], "label": labels[i]} for i in range(n)]
