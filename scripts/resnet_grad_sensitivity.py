#!/usr/bin/env python3
"""How far two implementations of ResNet-50's gradients can differ, on the CPU.

Run from the root of a checkout (no card needed):

    python3 scripts/resnet_grad_sensitivity.py

Builds the port's ResNet-50 at its three BatchNorm levels (False: flax
BatchNorm semantics; True: the fused BN; "pallas": the fused BN-apply 1x1
conv, here through its plain versions) with identical seeded weights and
the last BN scale of every block set to 0.1 +- 0.02, and takes the
gradient of one cross-entropy loss on one batch (16 images of 64 px) in
f32 and in bf16. For every conv3 weight and middle-BN gamma/beta it prints
the max-abs difference of two levels over the max-abs of the fused level's
gradient: pallas vs fused in f32, pallas vs fused in bf16, and unfused vs
fused in bf16 (two levels the JAX package itself has, neither of which
runs a kernel). This is what decides how the pallas model's gradients can
be checked on the card: to a tight tolerance in f32, and in bf16 only
block by block.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BATCH, CROP = 16, 64
SUFFIXES = ("conv3.weight", "bn2.weight", "bn2.bias")


def grads(level, dtype, x, labels):
    import torch
    import torch.nn.functional as F

    from dss_ml_at_scale_tpu_torch.models import seeded_resnet

    model = seeded_resnet(0, device="cpu", fused_bn=level, stage_sizes=[3, 4, 6, 3],
                          num_classes=1000, dtype=dtype)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + 0.1)
    F.cross_entropy(model(x), labels).backward()
    return {n: p.grad for n, p in model.named_parameters() if n.endswith(SUFFIXES)}


def main() -> int:
    import torch

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(BATCH, CROP, CROP, 3, generator=gen)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen)
    g = {(level, str(dtype).removeprefix("torch.")): grads(level, dtype, x, labels)
         for level in ("pallas", True, False) for dtype in (torch.float32, torch.bfloat16)}
    pairs = {
        "pallas_vs_fused_f32": (("pallas", "float32"), (True, "float32")),
        "pallas_vs_fused_bf16": (("pallas", "bfloat16"), (True, "bfloat16")),
        "unfused_vs_fused_bf16": ((False, "bfloat16"), (True, "bfloat16")),
        "fused_bf16_vs_fused_f32": ((True, "bfloat16"), (True, "float32")),
    }
    for label, (a, b) in pairs.items():
        errs = [((g[a][n].float() - g[b][n].float()).abs().max()
                 / g[b][n].float().abs().max()).item() for n in g[b]]
        print(json.dumps({"pair": label, "tensors": len(errs), "max": max(errs),
                          "median": statistics.median(errs), "min": min(errs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
