#!/usr/bin/env python3
"""Where the port's on-device crop and the JAX package's differ on the CPU.

Compiles the JAX package's ``augment_for_step`` (white noise, b6 h40 w48,
crops 32/24/56, steps 0/3/11, as ``tests/test_torch_augment.py``), prints
what XLA's optimized HLO does to ``compute_weight_mat`` (the reduce-window
split of the weight sum, the reciprocal constant that replaces
``1 / (crop / box)``), and then the max-abs error against JAX of numpy
re-creations of the port's weights with each rewrite reproduced:

- ``port``: the port's arithmetic (``data/augment.py::weight_matrices``);
- ``inv``: ``inv_scale = box * f32(1 / crop)``, XLA's rewrite;
- ``inv+tree``: also the weight sum as XLA's windows of 32, each summed in
  order, then the windows in order;
- ``+fmaA``/``+fmaB``: also the sample position's multiply-add contracted
  one way or the other (in float64, then rounded).

Run from the root of the checkout on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/augment_contraction_probe.py
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dss_ml_at_scale_tpu.data import augment as jax_aug  # noqa: E402
from dss_ml_at_scale_tpu_torch.data import augment as aug  # noqa: E402

F32, F64 = np.float32, np.float64
B, H, W = 6, 40, 48


def _fma(a, b, c):
    return (a.astype(F64) * b.astype(F64) + c.astype(F64)).astype(F32)


def weights(size, out, box, translation, crop, variant):
    if variant == "port":
        inv = (F32(1) / (F32(crop) / box)).astype(F32)
    else:
        inv = (box * F32(1.0 / crop)).astype(F32)
    inv = inv[:, None, None]
    kernel_scale = np.maximum(inv, F32(1))
    t = translation[:, None, None]
    a = (np.arange(out, dtype=F32) + F32(0.5))[None, None, :]
    ti = (t * inv).astype(F32)
    if variant.endswith("fmaA"):
        sample = (_fma(a, inv, -ti) - F32(0.5)).astype(F32)
    elif variant.endswith("fmaB"):
        sample = (_fma(-t, inv, (a * inv).astype(F32)) - F32(0.5)).astype(F32)
    else:
        sample = ((a * inv).astype(F32) - ti - F32(0.5)).astype(F32)
    x = (np.abs(sample - np.arange(size, dtype=F32)[None, :, None]) / kernel_scale).astype(F32)
    w = np.maximum(F32(1) - np.abs(x), F32(0)).astype(F32)
    if "tree" in variant:
        total = np.zeros((w.shape[0], 1, out), F32)
        for s0 in range(0, size, 32):
            part = np.zeros_like(total)
            for i in range(s0, min(s0 + 32, size)):
                part = (part + w[:, i:i + 1, :]).astype(F32)
            total = (total + part).astype(F32)
    else:
        total = w.sum(1, keepdims=True, dtype=F32)
    w = np.where(np.abs(total) > F32(1000 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, F32(1)), F32(0))
    inside = (sample >= -0.5) & (sample <= size - 0.5)
    return np.where(inside, w, F32(0)).astype(F32)


def main() -> int:
    x = np.random.default_rng(0).normal(size=(B, H, W, 3)).astype(F32)
    cfg = aug.AugmentConfig()
    for crop in (32, 24, 56):
        f = jax.jit(lambda s, x, crop=crop: jax_aug.augment_for_step(
            s, x, crop, jax_aug.AugmentConfig()))
        hlo = f.lower(jnp.int32(0), jnp.asarray(x)).compile().as_text()
        windows = sorted(set(re.findall(r"reduce-window\([^)]*\), window=\{size=([0-9x]+)", hlo)))
        recip = f"{F32(1.0 / crop):.9g}"
        print(f"crop {crop}: weight-sum reduce-windows {windows}; reciprocal constant "
              f"{recip} in the HLO: {f'constant({recip})' in hlo}")
        for variant in ("port", "inv", "inv+tree", "inv+tree+fmaA", "inv+tree+fmaB"):
            errs = []
            for step in (0, 3, 11):
                want = np.asarray(f(jnp.int32(step), jnp.asarray(x)))
                top, left, bh, bw, flip = aug.draws(
                    aug.ThreefryKey.from_seed(cfg.seed).fold_in(step), B, H, W, cfg)
                top, left, bh, bw = (np.asarray(v, F32) for v in (top, left, bh, bw))
                sy, sx = F32(crop) / bh, F32(crop) / bw
                wy = weights(H, crop, bh, (-top * sy).astype(F32), crop, variant)
                wx = weights(W, crop, bw, (-left * sx).astype(F32), crop, variant)
                xi = np.where(np.asarray(flip)[:, None, None, None], x[:, :, ::-1, :], x)
                rows = np.einsum("bhy,bhwc->bywc", wy, xi)
                out = np.einsum("bwx,bywc->byxc", wx, rows)
                errs.append(float(np.abs(out - want).max()))
            print(f"  {variant:>14}: max-abs error vs JAX at steps 0/3/11 {errs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
