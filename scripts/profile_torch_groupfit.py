#!/usr/bin/env python3
"""Where the group fit's time goes on the card: the reference's demand
panel (50 SKUs x 157 weeks, 75 orders, the default ``SarimaxConfig``).

Run from the root of a checkout on the machine with the card:

    python3 scripts/profile_torch_groupfit.py [--out DIR]

Prints, each on its own line: the card line; one Nelder-Mead evaluation
(180,000 series: 11,250 fits x 16 points) and one BFGS value-and-gradient
(11,250 lanes), each timed after a warm-up and then under
``torch.profiler`` (device and host ms, launches, the top kernels); the
grid fit of the whole panel with each Nelder-Mead round, the BFGS rounds
and status counts, and the peak memory; and at the 1,024-group chunk
shape (230,400 fits) one evaluation of the 16 points of every fit and
one value-and-gradient, with and without lane chunks, with their peak
memory. ``--out`` writes the profiler tables there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for the profiler tables")
    args = ap.parse_args()
    import numpy as np
    import torch

    from dss_ml_at_scale_tpu_torch.datagen.demand import DemandConfig, generate_demand
    from dss_ml_at_scale_tpu_torch.ops import bfgs, sarimax as sx
    from dss_ml_at_scale_tpu_torch.parallel.group_apply import pad_groups
    from dss_ml_at_scale_tpu_torch.workloads.forecasting import EXO_FIELDS, add_exo_variables

    if not torch.cuda.is_available():
        print("profile_torch_groupfit: needs the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    table = add_exo_variables(generate_demand(DemandConfig()))
    pg = pad_groups(table, ["Product", "SKU"], ["Demand", *EXO_FIELDS], sort_by="Date")
    y = torch.tensor(pg.values["Demand"], device=dev)
    ex = torch.tensor(np.stack([pg.values[f] for f in EXO_FIELDS], -1), device=dev)
    nv = torch.tensor(pg.n_valid, device=dev).long()
    nt = nv - 40
    cfg = sx.SarimaxConfig(k_exog=3)
    orders = torch.tensor(sx.grid_orders(cfg), device=dev).long()
    K, N = orders.shape[0], y.shape[1]

    def objective(groups: int):
        """The NM/BFGS objective of ``groups`` groups (the panel's, tiled)."""
        gi = torch.arange(groups, device=dev) % y.shape[0]
        _, yl, el, ol, nl = sx._lanes(y[gi][:, None].expand(groups, K, N),
                                      ex[gi][:, None].expand(groups, K, N, 3),
                                      orders[None].expand(groups, K, 3),
                                      nt[gi][:, None].expand(groups, K))
        rep = lambda a: a.repeat_interleave(3, 0)  # noqa: E731
        return sx._Objective(cfg, rep(yl), rep(el), rep(ol), rep(nl))

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    def profiled(name, fn):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            sync()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        host_ms = sum(e.self_cpu_time_total for e in events) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        print(f"{name}: profiled device {dev_ms:.1f} ms, host {host_ms:.1f} ms, launches "
              f"{sum(e.count for e in kernels)}; top: " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
                  for e in top), flush=True)
        if out:
            (out / f"{name}.txt").write_text(events.table(sort_by="self_cuda_time_total",
                                                          row_limit=40))

    obj = objective(y.shape[0])
    L = obj.y.shape[0]
    x16 = torch.zeros(L, 16, cfg.n_params - 1, device=dev)
    x1 = torch.zeros(L, cfg.n_params - 1, device=dev)
    print(f"nm eval ({L} fits x 16 points): {timed(lambda: obj.points(x16)):.4f} s", flush=True)
    print(f"bfgs value-and-gradient ({L} lanes): "
          f"{timed(lambda: bfgs.value_and_grad(obj, x1, sx.GRAD_LANES)):.4f} s", flush=True)
    profiled("nm_eval", lambda: obj.points(x16))
    profiled("bfgs_vg", lambda: bfgs.value_and_grad(obj, x1, sx.GRAD_LANES))

    # The whole panel's grid fit, with its stages timed.
    report: dict = {"nm_rounds_s": [], "bfgs_rounds": 0}
    nm, mb, vg = sx.nelder_mead, sx.minimize_bfgs, bfgs.value_and_grad

    def nm_timed(*a, **k):
        sync()
        t0 = time.perf_counter()
        r = nm(*a, **k)
        sync()
        report["nm_rounds_s"].append(round(time.perf_counter() - t0, 2))
        return r

    def vg_counted(*a, **k):
        report["bfgs_rounds"] += 1
        return vg(*a, **k)

    def bfgs_timed(*a, **k):
        sync()
        t0 = time.perf_counter()
        r = mb(*a, **k)
        sync()
        report["bfgs_s"] = round(time.perf_counter() - t0, 2)
        report["bfgs_nit_max"] = int(r.nit.max())
        report["bfgs_nit_mean"] = round(float(r.nit.float().mean()), 2)
        report["bfgs_status"] = {int(s): int(c) for s, c in zip(*torch.unique(
            r.status, return_counts=True))}
        return r

    sx.nelder_mead, sx.minimize_bfgs, bfgs.value_and_grad = nm_timed, bfgs_timed, vg_counted
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sx.sarimax_fit_grid(cfg, y, ex, orders, nt, nv)
    sync()
    sx.nelder_mead, sx.minimize_bfgs, bfgs.value_and_grad = nm, mb, vg
    report.update(grid_fit_s=round(time.perf_counter() - t0, 2),
                  peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
                  finite=bool(torch.isfinite(res.pred).all()))
    print("grid fit (50 groups): " + json.dumps(report), flush=True)

    # The 1,024-group chunk shape.
    del obj, x16, x1
    torch.cuda.empty_cache()
    obj = objective(1024)
    L = obj.y.shape[0]
    x16 = torch.zeros(L, 16, cfg.n_params - 1, device=dev)
    torch.cuda.reset_peak_memory_stats()
    s = timed(lambda: obj.points(x16))
    print(f"chunk nm eval ({L} fits x 16 points): {s:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    del x16
    x1 = torch.zeros(L, cfg.n_params - 1, device=dev)
    for chunk in (sx.GRAD_LANES, 1 << 16):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s = timed(lambda: bfgs.value_and_grad(obj, x1, chunk))
        print(f"chunk bfgs value-and-gradient ({L} lanes, {chunk} per pass): {s:.3f} s, peak "
              f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.2f} GiB", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
