#!/usr/bin/env python3
"""The port's ``sarimax_fit`` over every order of the golden fixture's fit
bars (``tests/fixtures/sarimax_golden.json``), against the oracle's
loglike and ``tests/test_sarimax_golden.py``'s per-order bar.

    python3 scripts/golden_fit_sweep_torch.py [--max-iter 200] [--dtype float32]
        [--device cuda] [--orders 4,2,1 ...] [--perturb 0]

``--perturb S`` adds S copies of the series, each scaled by
``1 + 1e-5 z`` with ``z`` a standard normal draw seeded by the copy's
index (1..S): the same copies as ``scripts/golden_fit_sweep_jax.py``
makes, so the two packages' spread over nearby starts can be compared.
Runs on the card unless ``--device cpu`` is given. Prints one JSON line:
each order's shortfall behind the oracle in every copy (copy 0 is the
fixture's series), the orders over their bar, and the seconds the batched
fit took on that device.
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


def select_bars(fix: dict, orders: list[str]) -> list[dict]:
    """The fit bars of ``orders``, else of every d >= 1 order."""
    want = {tuple(int(v) for v in o.split(",")) for o in orders}
    return [b for b in fix["fits"] if tuple(b["order"]) in want
            or (not want and b["order"][1] >= 1)]


def report(bars, loglike: np.ndarray, **head) -> dict:
    """``loglike`` is ``[copies, orders]``."""
    short = {str(tuple(b["order"])): [round(b["loglike"] - float(v), 3) for v in loglike[:, i]]
             for i, b in enumerate(bars)}
    over = {o: s for o, s, b in zip(short, short.values(), bars)
            if max(s) > fit_tol(b["order"])}
    return dict(head, orders=len(bars), copies=loglike.shape[0], over_bar=over,
                max_shortfall=max(max(s) for s in short.values()),
                shortfall=short if len(bars) <= 4 else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--orders", nargs="*", default=[],
                    help="only these orders, as p,d,q (default: every d >= 1 order)")
    ap.add_argument("--perturb", type=int, default=0, help="perturbed copies of the series")
    args = ap.parse_args()
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": f"--device {args.device}: no CUDA device is available "
                          "(pass --device cpu to run on the CPU)"}), flush=True)
        return 1
    from dss_ml_at_scale_tpu_torch.ops import sarimax as sx

    fix = json.loads((ROOT / "tests" / "fixtures" / "sarimax_golden.json").read_text())
    dt = getattr(torch, args.dtype)
    bars = select_bars(fix, args.orders)
    ys = copies(np.asarray(fix["y"]), args.perturb)
    y = torch.tensor(ys, dtype=dt, device=args.device)[:, None, :]
    exog = torch.tensor(fix["exog"], dtype=dt, device=args.device)
    orders = torch.tensor([b["order"] for b in bars], device=args.device)
    t0 = time.perf_counter()
    res = sx.sarimax_fit(sx.SarimaxConfig(k_exog=3, max_iter=args.max_iter), y, exog, orders,
                         torch.tensor(fix["n_valid"], device=args.device))
    ll = res.loglike.cpu().double().numpy()
    seconds = time.perf_counter() - t0
    print(json.dumps(report(bars, ll, package="torch", max_iter=args.max_iter,
                            dtype=args.dtype, device=args.device, eps=EPS,
                            seconds=seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
