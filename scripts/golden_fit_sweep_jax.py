#!/usr/bin/env python3
"""The JAX package's ``sarimax_fit`` over the golden fixture's fit bars,
on the CPU: the reference side of ``scripts/golden_fit_sweep_torch.py``,
with the same options, the same perturbed copies of the series and the
same JSON line.

    python3 scripts/golden_fit_sweep_jax.py [--max-iter 200] [--dtype float32]
        [--orders 4,2,1 ...] [--perturb 0]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def fit_tol(order) -> float:
    """``tests/test_sarimax_golden.py``'s per-order bar (nats)."""
    p, d, q = order
    if d == 0 and (p or q):
        return 30.0
    return max(1.0, 1.5 * (p + q))


EPS = 1e-5  # relative size of a perturbation


def copies(y: np.ndarray, perturb: int) -> np.ndarray:
    """The fixture's series and ``perturb`` copies scaled by ``1 + EPS z``."""
    z = [np.random.default_rng(s).standard_normal(y.shape) for s in range(1, perturb + 1)]
    return np.stack([y] + [y * (1.0 + EPS * zs) for zs in z])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--orders", nargs="*", default=[],
                    help="only these orders, as p,d,q (default: every d >= 1 order)")
    ap.add_argument("--perturb", type=int, default=0, help="perturbed copies of the series")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import jax.numpy as jnp

    from dss_ml_at_scale_tpu.ops import SarimaxConfig, sarimax_fit

    fix = json.loads((ROOT / "tests" / "fixtures" / "sarimax_golden.json").read_text())
    want = {tuple(int(v) for v in o.split(",")) for o in args.orders}
    bars = [b for b in fix["fits"] if tuple(b["order"]) in want
            or (not want and b["order"][1] >= 1)]
    dt = getattr(jnp, args.dtype)
    ys = jnp.asarray(copies(np.asarray(fix["y"]), args.perturb), dt)
    exog = jnp.asarray(fix["exog"], dt)
    orders = jnp.asarray([b["order"] for b in bars])
    cfg = SarimaxConfig(k_exog=3, max_iter=args.max_iter)
    fit = jax.vmap(jax.vmap(lambda y, o: sarimax_fit(cfg, y, exog, o, fix["n_valid"]).loglike,
                            (None, 0)), (0, None))
    t0 = time.perf_counter()
    ll = np.asarray(fit(ys, orders), np.float64)
    seconds = time.perf_counter() - t0
    short = {str(tuple(b["order"])): [round(b["loglike"] - float(v), 3) for v in ll[:, i]]
             for i, b in enumerate(bars)}
    over = {o: s for o, s, b in zip(short, short.values(), bars)
            if max(s) > fit_tol(b["order"])}
    print(json.dumps(dict(package="jax", max_iter=args.max_iter, dtype=args.dtype,
                          device="cpu", eps=EPS, seconds=seconds, orders=len(bars),
                          copies=ll.shape[0], over_bar=over,
                          max_shortfall=max(max(s) for s in short.values()),
                          shortfall=short if len(bars) <= 4 else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
