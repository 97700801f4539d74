#!/usr/bin/env python3
"""How far the f32 ResNet-50's whole-model gradients differ between its
BatchNorm levels, and why.

Run from the root of a checkout, on a card (or ``--device cpu``):

    python3 scripts/f32_level_parity_probe.py [--device cuda] [--batch 212 8]

Builds the port's ResNet-50 in f32 at crop 224 with identical seeded
weights (the last BN scale of every block 0.1 +- 0.02, as the parity phases
of ``chip_smoke.py`` set it) and takes the gradient of one cross-entropy
loss on one seeded batch, cuDNN deterministic, at four levels: ``pallas``
through K1f-K3f, ``pallas`` through the kernels' plain versions, the fused
BN level and flax's BN level. For each pair it prints the logits', loss's
and running statistics' max-abs differences and every parameter gradient's
(each over the second model's max-abs): the worst five, the median, and how
many exceed 5e-4, JAX's model-level bar (tests/test_fused_matmul.py:407).

It also counts, at each of the 16 middle-BN sites, the elements whose ReLU
mask differs between the pallas and the fused level: the pallas level's
argument ``y*s + t`` against the fused level's ``(y - mean) * (inv * gamma)
+ beta``, each from its own model's conv output; and the smallest |argument|
at the site. One JSON document on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONFIG = dict(stage_sizes=[3, 4, 6, 3], num_classes=1000)
EPS = 1e-5


def _rel(a, b) -> float:
    return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()


def run(torch, state, level, x, labels, device, plain_versions=False) -> dict:
    import torch.nn.functional as F

    import chip_smoke
    from dss_ml_at_scale_tpu_torch.models import seeded_resnet

    model = seeded_resnet(0, device=device, fused_bn=level, dtype=torch.float32, **CONFIG)
    model.load_state_dict(state)
    sites = {}
    for name, module in model.named_modules():
        if name.endswith(".bn2"):
            module.register_forward_hook(
                lambda m, args, out, name=name: sites.__setitem__(name, args[0].detach()))
    ctx = chip_smoke._plain_fused_matmul() if plain_versions else contextlib.nullcontext()
    with ctx:
        logits = model(x)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
    return {"logits": logits.detach(), "loss": loss.item(),
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "stats": {n: v.clone() for n, v in model.state_dict().items() if "running" in n},
            "bn2_in": sites,
            "bn2": {n[:-len(".weight")]: p.detach() for n, p in model.named_parameters()
                    if n.endswith("bn2.weight")}}


def compare(a: dict, b: dict) -> dict:
    g = {n: _rel(a["grads"][n], b["grads"][n]) for n in a["grads"]}
    return {"logits": _rel(a["logits"], b["logits"]),
            "loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "stats_max": max(_rel(a["stats"][n], b["stats"][n]) for n in a["stats"]),
            "grad_max": max(g.values()), "grad_median": statistics.median(g.values()),
            "grads_over_5e-4": sum(v > 5e-4 for v in g.values()), "grads": len(g),
            "worst": {n: g[n] for n in sorted(g, key=g.get)[-5:]}}


def mask_flips(torch, pallas: dict, fused: dict, state: dict) -> dict:
    """Per middle-BN site: elements whose ReLU mask differs between the two
    levels' arguments, and the smallest |argument| of the pallas level."""
    out = {}
    for site, yp in pallas["bn2_in"].items():
        gamma, beta = state[f"{site}.weight"], state[f"{site}.bias"]
        args = []
        for y in (yp, fused["bn2_in"][site]):
            y32 = y.reshape(-1, y.shape[-1]).float()
            mean = y32.mean(0)
            var = torch.clamp_min(y32.square().mean(0) - mean.square(), 0.0)
            inv = torch.rsqrt(var + EPS)
            args.append((y32, mean, inv))
        (y1, m1, i1), (y2, m2, i2) = args
        s = gamma * i1
        zp = y1 * s + (beta - m1 * s)
        zf = (y2 - m2) * (i2 * gamma) + beta
        out[site] = {"rows": y1.shape[0], "flips": int(((zp > 0) != (zf > 0)).sum()),
                     "min_abs_arg": zp.abs().min().item()}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, nargs="+", default=[212, 8])
    args = parser.parse_args()
    import torch

    from dss_ml_at_scale_tpu_torch.models import seeded_resnet

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("f32_level_parity_probe: no card (pass --device cpu)", file=sys.stderr)
            return 1
        from dss_ml_at_scale_tpu_torch.ops import _build

        _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = seeded_resnet(0, device=args.device, fused_bn="pallas", dtype=torch.float32,
                          **CONFIG)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + 0.1)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    gen = torch.Generator(device=args.device).manual_seed(3)
    x = torch.randn(max(args.batch), 224, 224, 3, generator=gen, device=args.device)
    labels = torch.randint(0, 1000, (max(args.batch),), generator=gen, device=args.device)
    report = {"device": (torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu")}
    for batch in args.batch:
        xb, lb = x[:batch], labels[:batch]
        levels = {"kernels": run(torch, state, "pallas", xb, lb, args.device),
                  "plain_versions": run(torch, state, "pallas", xb, lb, args.device, True),
                  "fused": run(torch, state, True, xb, lb, args.device),
                  "flax": run(torch, state, False, xb, lb, args.device)}
        report[f"batch_{batch}"] = {
            f"{a} vs {b}": compare(levels[a], levels[b])
            for a, b in (("kernels", "plain_versions"), ("kernels", "fused"),
                         ("plain_versions", "fused"), ("fused", "flax"))}
        report[f"batch_{batch}"]["bn2_mask_flips_pallas_vs_fused"] = mask_flips(
            torch, levels["plain_versions"], levels["fused"], state)
        del levels
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
