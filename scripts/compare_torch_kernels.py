#!/usr/bin/env python3
"""This tree's K4 and K1-K3 against an earlier build of the same kernels, on one card.

Run from the root of a checkout, on the machine with the card, after
putting the earlier sources in a directory (the card's machine has no git):

    git show <rev>:dss_ml_at_scale_tpu_torch/csrc/flash_attention.cu > build/old/flash_attention.cu
    git show <rev>:dss_ml_at_scale_tpu_torch/csrc/fused_matmul.cu > build/old/fused_matmul.cu
    python3 scripts/compare_torch_kernels.py --old build/old [--out FILE]

The earlier sources must have the C signatures of the first designs of the
port (K4: no split plan; K1: no SM count). Both builds run in one process
on one card, in turns (old, new, new, old; device time of 20 launches
behind a GPU sleep, median of 3, ``chip_smoke.device_ms``):

- K4, causal b1 h8 d128 at the serving buckets 128/512/1024: the old
  kernel, this kernel as the wrapper launches it (with its key-split plan
  where it has one), without the plan, and with a plan made as if every
  tile were long enough to split (``_MAX_UNSPLIT`` lifted), which shows
  where the split stops paying;
- K1 at the four ResNet-50 stage shapes, with and without a residual: the
  old kernel, this kernel, and this kernel built with a one-stage ring
  (its loads then wait for the previous stage's products), which shows
  what the copy ring contributes; each held against the plain version;
- K2 and K3 at the same shapes without a residual: times of both builds,
  and whether their outputs agree bit for bit.

One JSON line per measurement; all of them to ``--out`` (default
``chiprun_out/compare_torch_kernels.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int


def build(old: Path) -> dict[str, ctypes.CDLL]:
    """The old sources and this tree's K1 with a one-stage ring, built
    beside them with this tree's flags; this tree's kernels as usual."""
    from dss_ml_at_scale_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_matmul.cu").read_text()
    fn = src[src.index("int fwd_stages(int K, bool res) {"):]
    fn = fn[:fn.index("\n}\n") + 3]
    one_stage = src.replace(fn, "int fwd_stages(int K, bool res) { return 1; }\n").replace(
        "if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);", "")
    (old / "fused_matmul_one_stage.cu").write_text(one_stage)
    jobs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(old / f"{name}.so"), str(old / f"{name}.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        for name in ("flash_attention", "fused_matmul", "fused_matmul_one_stage")}
    _build.build_all()
    libs = {}
    for name, job in jobs.items():
        if job.wait() != 0:
            chip_smoke.fail(f"nvcc failed on {old / name}.cu")
        libs[name] = ctypes.CDLL(str(old / f"{name}.so"))
    libs["flash_attention"].dsst_flash_attention_fwd.argtypes = [P] * 4 + [I] * 6 + [P]
    old_fm = libs["fused_matmul"]
    old_fm.dsst_bn_relu_matmul_fwd.argtypes = [P] * 6 + [I] * 3 + [P]
    old_fm.dsst_bn_relu_matmul_bwd_da.argtypes = [P] * 11 + [I] * 3 + [P]
    old_fm.dsst_bn_relu_matmul_bwd_dw.argtypes = [P] * 7 + [I] * 5 + [P]
    libs["fused_matmul_one_stage"].dsst_bn_relu_matmul_fwd.argtypes = [P] * 6 + [I] * 4 + [P]
    return libs


def turns(fns: dict) -> dict[str, list[float]]:
    """Each function's ms, timed in the order a, b, ..., b, a."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(chip_smoke.device_ms(fns[n]))
    return times


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="directory with the earlier flash_attention.cu and fused_matmul.cu")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out/compare_torch_kernels.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build(args.old)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for s in (128, 512, 1024):
        q, k, v = (torch.randn(1, 8, s, 128, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))

        def old_k4():
            out = torch.empty_like(q)
            rc = libs["flash_attention"].dsst_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 8, s, s, 128, 1, 1,
                stream())
            chip_smoke.check(rc == 0, f"old K4 launch: CUDA error {rc}")
            return out

        ref = fa.attention_reference(q, k, v, causal=True).float()
        for name, fn in (("old", old_k4), ("split", lambda: fa._launch(q, k, v, True)),
                         ("no split", lambda: fa._launch(q, k, v, True, split=False))):
            err = (fn().float() - ref).abs().max().item()
            chip_smoke.check(err <= chip_smoke.ATOL, f"K4 {name} s{s}: max abs err {err}")
        plan = fa.split_plan(8, s, s, True, sm_count)
        fns = {"old": old_k4,
               "new": lambda: fa.flash_attention(q, k, v, causal=True),
               "new_nosplit": lambda: fa._launch(q, k, v, True, split=False)}
        unsplit, fa._MAX_UNSPLIT = fa._MAX_UNSPLIT, 0
        fa._plans.clear()  # the plan cache holds the wrapper's plans only
        forced = fa._device_plan(8, s, s, True, q.device)
        fa._plans.clear()
        if forced is not None:

            def forced_k4():
                items, combine, n_items, n_combine, n_slots = forced
                out = torch.empty_like(q)
                po = torch.empty((8, n_slots, 64, 128), dtype=torch.float32, device="cuda")
                pl = torch.empty((8, n_slots, 64), dtype=torch.float32, device="cuda")
                rc = fa._kernel().dsst_flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 8, s, s, 128, 1, 1,
                    items.data_ptr(), n_items, combine.data_ptr(), n_combine, po.data_ptr(),
                    pl.data_ptr(), n_slots, stream())
                chip_smoke.check(rc == 0, f"K4 forced split launch: CUDA error {rc}")
                return out

            err = (forced_k4().float() - ref).abs().max().item()
            chip_smoke.check(err <= chip_smoke.ATOL, f"K4 forced split s{s}: max abs err {err}")
            fns["new_forced_split"] = forced_k4
        fa._MAX_UNSPLIT = unsplit
        emit({"kernel": "K4", "shape": f"causal b1 h8 s{s} d128", "card": card,
              "split_items": None if plan is None else len(plan[0]),
              "forced_split_items": None if forced is None else forced[2], **turns(fns)})

    for name, m, k, n in chip_smoke.FUSED_SHAPES[:4]:
        y = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        mean = y.float().mean(0)
        inv = torch.rsqrt(y.float().var(0) + 1e-5)
        s_ = (torch.randn(k, generator=gen, device="cuda") * 0.2 + 1) * inv
        t_ = torch.randn(k, generator=gen, device="cuda") * 0.2 - mean * s_
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        g = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        for res in (None, torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)):
            rp = None if res is None else res.data_ptr()

            def k1(lib, *extra):
                out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
                rc = lib.dsst_bn_relu_matmul_fwd(y.data_ptr(), rp, s_.data_ptr(), t_.data_ptr(),
                                                 w.data_ptr(), out.data_ptr(), m, k, n, *extra,
                                                 stream())
                chip_smoke.check(rc == 0, f"K1 variant launch: CUDA error {rc}")
                return out

            fns = {"old": lambda: k1(libs["fused_matmul"]),
                   "new": lambda: fm.bn_relu_matmul_fwd(y, s_, t_, w, res),
                   "new_one_stage": lambda: k1(libs["fused_matmul_one_stage"], sm_count)}
            ref = fm.bn_relu_matmul_fwd_reference(y, s_, t_, w, res).float()
            for what, fn in fns.items():
                diff = (fn().float() - ref).abs()
                bad = int((diff > chip_smoke.FUSED_ATOL + chip_smoke.FUSED_RTOL * ref.abs()).sum())
                chip_smoke.check(bad == 0, f"K1 {what} {name}: {bad} elements out of tolerance")
            emit({"kernel": "K1", "shape": f"{name} M{m} K{k} N{n}" + (" +res" if rp else ""),
                  "card": card, **turns(fns)})
        old_fm = libs["fused_matmul"]

        def old_k2():
            tiles = (m + 127) // 128
            gt = torch.empty(m, k, dtype=torch.bfloat16, device="cuda")
            part = torch.empty(tiles, 2 * k, device="cuda")
            sums = torch.empty(2, k, device="cuda")
            rc = old_fm.dsst_bn_relu_matmul_bwd_da(
                g.data_ptr(), w.data_ptr(), y.data_ptr(), None, s_.data_ptr(), t_.data_ptr(),
                mean.data_ptr(), inv.data_ptr(), gt.data_ptr(), part.data_ptr(), sums.data_ptr(),
                m, k, n, stream())
            chip_smoke.check(rc == 0, f"old K2 launch: CUDA error {rc}")
            return gt, sums[0], sums[1]

        def old_k3():
            splits, chunk = fm.dw_splits(m, k, n, sm_count)
            part = torch.empty(splits, k, n, device="cuda")
            dw = torch.empty(k, n, device="cuda")
            rc = old_fm.dsst_bn_relu_matmul_bwd_dw(
                y.data_ptr(), None, s_.data_ptr(), t_.data_ptr(), g.data_ptr(), part.data_ptr(),
                dw.data_ptr(), m, k, n, splits, chunk, stream())
            chip_smoke.check(rc == 0, f"old K3 launch: CUDA error {rc}")
            return dw

        new_k2 = lambda: fm.bn_relu_matmul_bwd_da(g, w, y, s_, t_, mean, inv)  # noqa: E731
        new_k3 = lambda: fm.bn_relu_matmul_bwd_dw(y, s_, t_, g)  # noqa: E731
        same = (all(torch.equal(a, b) for a, b in zip(old_k2(), new_k2()))
                and torch.equal(old_k3(), new_k3()))
        emit({"kernel": "K2/K3", "shape": f"{name} M{m} K{k} N{n}", "card": card,
              "bit_identical": same,
              "K2": turns({"old": old_k2, "new": new_k2}),
              "K3": turns({"old": old_k3, "new": new_k3})})
        del y, g, w
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
