#!/usr/bin/env python3
"""This tree's K2 and K3 against an earlier build of the same kernels, on one card.

Run from the root of a checkout, on the machine with the card, after
putting the earlier source in a directory (the card's machine has no git):

    git show <rev>:dss_ml_at_scale_tpu_torch/csrc/fused_matmul.cu > build/old/fused_matmul.cu
    python3 scripts/compare_torch_kernels.py --old build/old [--out FILE]

The earlier source must have the C signatures of the mma.sync designs of
K2 and K3 (K2 without a tile width or an SM count, K3 without a tile
height; K3 split by their plan, ``old_dw_splits`` below). Every build runs
in one process on one card, in turns (old, new, ..., new, old; device time
of 20 launches behind a GPU sleep, median of 3, ``chip_smoke.device_ms``),
at the four ResNet-50 stage shapes without a residual:

- K3: the old kernel, this kernel, and this kernel built with the
  shortest ring it can run on (``new_short_ring``: one stage, or one per
  warpgroup where the two take alternate stages), whose loads then wait
  for the previous stage's products: what the ring contributes; and this
  kernel with the second pass in the form the tree does not take at its
  row count: the 32 x 16 form where the plan has fewer than 32 runs of M
  (stages 3-4, ``new_sum_rows_32x16``), one thread per column elsewhere
  (``new_sum_rows_per_column``);
- K2: the same three (its shortest ring is two stages: a slot is freed only
  once the next stage's products are issued), this kernel with its ring
  capped at 4 stages instead of 6 (``new_4_stages``), and with its second
  pass (132 rows at every stage shape) one thread per column;
- each held against the plain version (2^-7 of its max-abs).

What should agree bit for bit is checked in every build, with and without
a residual: K2's ReLU mask and K3's ``a``. The mask: gt is zero wherever
the plain mask is off; with g and W positive (no sum can cancel) gt is
nonzero exactly where it is on; with random W and four draws of g
(``MASK_DRAWS``), every element where the mask is on and one of gt and the
plain gt is zero and the other not is listed with its z, both values and
the exact product (in f64, where bf16 products and their sums are exact):
a sum that cancels in one order and not in the other, not a mask that
differs. ``a`` is read back from dW
with ``g`` the identity (each entry of dW one product, so no summation
order). gt, the sums and dW themselves change their summation order.

One JSON line per shape; all of them to ``--out`` (default
``chiprun_out/compare_torch_kernels.json``).

``--flash`` compares K4 instead: this tree's ``flash_attention.cu`` against
the earlier one in ``--old`` (with the ``hopper.cuh`` it includes beside
it; the C interface must be this tree's up to head_dim 128), at every bf16
head dim up to 128 both builds take, causal, at the serving shapes and the
LM training shape: the outputs bit for bit, and the times in turns (old,
new, new, old). Then the wide heads in bf16 and the f32 kernel
(``FLASH_REDESIGNED``), whose designs differ: each build against the plain
version (bf16 atol 2e-2, f32 2e-5) and the times in turns; the earlier
build takes its own padding there (a multiple of 128 above 128) and no
split plan (it had none at these shapes). Beside them, builds of this
tree's source with one decision changed (``FLASH_VARIANTS``, their ptxas
spill lines printed): 256-column slices on the warp-specialized kernel
(three warpgroups), with and without setmaxnreg; 192-column slices on the
lockstep kernel; the lockstep kernel with its second barrier a tile (K
freed after Q·Kᵀ); the f32 kernel at two CTAs an SM at every width.

    git show <rev>:dss_ml_at_scale_tpu_torch/csrc/flash_attention.cu > build/old/flash_attention.cu
    git show <rev>:dss_ml_at_scale_tpu_torch/csrc/hopper.cuh > build/old/hopper.cuh
    python3 scripts/compare_torch_kernels.py --old build/old --flash

``--fused-f32`` compares the f32 kernels instead: this tree's
``fused_matmul_f32.cu`` against the parent's in ``--old`` (with the parent's
``hopper.cuh``, ``fused_matmul.cu`` and ``flash_attention.cu`` beside it),
whose C interface it carries: K2f and K3f as this tree's, K1f the FFMA
design's (no W scratch, no grid). First the parent's bf16 K1-K3 (four stage
shapes, with and without a residual) and K4 (``FLASH_SHAPES`` and
``FLASH_REDESIGNED``) against this tree's builds, bit for bit
(``parent_bitwise``). Then, at the four stage shapes with and without a
residual: K1f of each build held to JAX's element-by-element bar (rtol/atol
1e-5 against the plain version; the elements past it and the worst one's
share of its bar), the parent's and this one failing the script past it;
K2f and K3f bit for bit between the builds (the same design), and each
build held against the plain version as ``chip_smoke.py`` holds them (gt
within 1e-5 of the plain max-abs; the ReLU mask bit for bit: gt zero
wherever it is off and, with g and W positive, nonzero exactly where it is
on; a gt that cancels to exactly zero where the plain one does not is
counted, and fails past 1e-5 of the max-abs; the sums and dW within 1e-5 of
the max-abs of an f64 sum of their terms, or no worse than twice the plain
version's error); the variants recorded; and every kernel's times in turns
(old, new, variants, variants, new, old). The variants are builds of this
tree's source with one decision changed (``F32_VARIANTS``, each timed for
the kernels ``VARIANT_KERNELS`` names, their ptxas register and spill lines
printed): the wgmma chain never flushed into the f32 accumulator (one chain
a tile of K1f and K2f, a run of K3f: how the tensor cores' sum holds over a
long chain); one set of A-fragment registers instead of two (K1f then builds
the next stage's fragment after the products instead of during them); K1f
refilling its ring a stage later, on a ring of two stages, staging its
epilogue in 32-column boxes (a ring one stage deeper), and walking M first
within a band of N; and, for where the
time goes, with wrong results, one TF32 product a k8 step, no product, K1f
and K3f without their BN prologue, K1f with neither, and K1f without its TMA
stores. At stage 1 K3f also runs its 664,832 rows as one run (``one_run``),
flushed every stage and never.

    for f in fused_matmul_f32.cu fused_matmul.cu flash_attention.cu hopper.cuh; do
      git show <rev>:dss_ml_at_scale_tpu_torch/csrc/$f > build/old/$f; done
    python3 scripts/compare_torch_kernels.py --old build/old --fused-f32
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
MASK_DRAWS = 4  # draws of g for the mask check


def old_dw_splits(m: int, k: int, n: int, sm_count: int) -> tuple[int, int]:
    """The mma.sync design's K3 plan: 64 x 128 tiles, about four CTAs per SM,
    chunks of whole 32-row stages and at least 256 rows."""
    tiles = math.ceil(n / 128) * math.ceil(k / 64)
    splits = max(1, min(math.ceil(4 * sm_count / tiles), math.ceil(m / 256)))
    chunk = math.ceil(math.ceil(m / splits) / 32) * 32
    return math.ceil(m / chunk), chunk


# Builds of this tree's source with one decision changed: name -> (what the
# source says, what the variant says instead).
VARIANTS = {
    # The shortest rings the kernels run on.
    "fused_matmul_short_ring": (
        ("return std::min(6, (kSmemLimit - da_smem_bytes(bn, res, 0))",
         "return std::min(2, (kSmemLimit - da_smem_bytes(bn, res, 0))"),
        ("return alt ? n & ~1 : n;", "return alt ? 2 : 1;")),
    # K2's ring capped at 4 stages, as K1's is.
    "fused_matmul_k2_4_stages": (
        ("return std::min(6, (kSmemLimit - da_smem_bytes(bn, res, 0))",
         "return std::min(4, (kSmemLimit - da_smem_bytes(bn, res, 0))"),),
    # The second pass in one form at every row count: 32 x 16, or one
    # thread per column.
    "fused_matmul_sum_rows_32x16": (("  if (rows < 32) {", "  if (false) {"),),
    "fused_matmul_sum_rows_per_column": (("  if (rows < 32) {", "  if (true) {"),),
}


def build(old: Path) -> dict[str, ctypes.CDLL]:
    """The old source and the variants of this tree's, built beside them
    with this tree's flags; this tree's kernels as usual."""
    from dss_ml_at_scale_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_matmul.cu").read_text()
    for name, edits in VARIANTS.items():
        text = src
        for before, after in edits:
            if before not in text:
                chip_smoke.fail(f"variant {name}: {before!r} not in fused_matmul.cu")
            text = text.replace(before, after)
        (old / f"{name}.cu").write_text(text)
    jobs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(old / f"{name}.so"), str(old / f"{name}.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
        for name in ("fused_matmul", *VARIANTS)}
    _build.build_all()
    libs = {}
    for name, job in jobs.items():
        if job.wait() != 0:
            chip_smoke.fail(f"nvcc failed on {old / name}.cu")
        lib = libs[name] = ctypes.CDLL(str(old / f"{name}.so"))
        lib.dsst_bn_relu_matmul_bwd_da.argtypes = [P] * 11 + [I] * 5 + [P]
        lib.dsst_bn_relu_matmul_bwd_dw.argtypes = [P] * 7 + [I] * 6 + [P]
        for fn in (lib.dsst_bn_relu_matmul_bwd_da, lib.dsst_bn_relu_matmul_bwd_dw):
            fn.restype = I
    # The old design's K2 takes no tile width and no SM count, its K3 no
    # tile height.
    libs["fused_matmul"].dsst_bn_relu_matmul_bwd_da.argtypes = [P] * 11 + [I] * 3 + [P]
    libs["fused_matmul"].dsst_bn_relu_matmul_bwd_dw.argtypes = [P] * 7 + [I] * 5 + [P]
    return libs


def turns(fns: dict) -> dict[str, list[float]]:
    """Each function's ms, timed in the order a, b, ..., b, a."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(chip_smoke.device_ms(fns[n]))
    return times


def mask_check(torch, fm, k2: dict, gs: list, w, y, s_, t_, mean, inv, res) -> dict:
    """K2's ReLU mask in every build, as the docstring says, over the draws
    of g in ``gs`` (the positive-operand check on the first); raises through
    ``chip_smoke.check`` if a mask differs."""
    mask = fm._z(y, s_, t_, res) > 0
    out = {}
    for what, fn in k2.items():
        positive_same = torch.equal(fn(gs[0].abs(), w.abs(), res)[0] != 0, mask)
        off_zero, count, big, listed = True, 0, 0, []
        for draw, g in enumerate(gs):
            gt = fn(g, w, res)[0]
            off_zero &= not gt[~mask].any()
            da = torch.matmul(g.float(), w.float().t())  # the plain version's product
            plain = torch.where(mask, da, torch.zeros_like(da))
            differ = mask & ((gt == 0) != (plain == 0))
            count += int(differ.sum().item())
            # Only a sum near zero may cancel: none past the tolerance.
            big += int((differ & (plain.abs() > chip_smoke.FUSED_REL * plain.abs().max()))
                       .sum().item())
            for r, c in differ.nonzero()[:8 - len(listed)].tolist():
                z = fm._z(y[r:r + 1], s_, t_, None if res is None else res[r:r + 1])[0, c]
                listed.append({"draw": draw, "row": r, "col": c, "z": z.item(),
                               "gt": gt[r, c].item(), "plain_gt": plain[r, c].item(),
                               "exact": torch.dot(g[r].double(), w[c].double()).item()})
            del gt, da, plain, differ
        out[what] = {"off_zero": off_zero, "positive_operands_same": positive_same,
                     "on_zero_in_one_only": count, "of_them_past_tolerance": big,
                     "listed": listed}
        chip_smoke.check(off_zero and positive_same and big == 0,
                         f"K2 {what}: the ReLU mask differs")
    return out


# K4 cases of --flash: (b, h, s, d), causal.
FLASH_SHAPES = ((1, 8, 128, 128), (1, 8, 512, 128), (1, 8, 1024, 128), (1, 8, 512, 64),
                (8, 8, 2048, 128), (8, 8, 2048, 64))


# Builds of this tree's flash_attention.cu with one decision changed.
_WS = ("{ return dv > 192; }", "{ return dv > 256; }")
FLASH_VARIANTS = {
    "wide256_warp_specialized": (_WS,),
    "wide256_setmaxnreg": (_WS, (
        "    const int pt = threadIdx.x - 2 * kThreads;",
        '    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n'
        "    const int pt = threadIdx.x - 2 * kThreads;"), (
        "  const int wi = threadIdx.x / kThreads;\n  const int lane = threadIdx.x % 32;",
        '  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n'
        "  const int wi = threadIdx.x / kThreads;\n  const int lane = threadIdx.x % 32;")),
    "wide192_lockstep": (("{ return dv > 192; }", "{ return dv > 128; }"),),
    "lockstep_two_barriers": (("const bool late = hold && rk >= 2 * nc;",
                               "const bool late = false;"),),
    "f32_two_ctas": (("__launch_bounds__(kF32Threads, DV > 128 ? 1 : 2)",
                      "__launch_bounds__(kF32Threads, 2)"),),
}


def build_flash_variants(old: Path) -> dict[str, ctypes.CDLL]:
    """Each of FLASH_VARIANTS built beside the old source with this tree's
    flags; their ptxas lines of spilling wide or f32 kernels printed."""
    import re

    from dss_ml_at_scale_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    # Not beside the old source: its hopper.cuh would be included first.
    old = old / "variants"
    old.mkdir(exist_ok=True)
    jobs = {}
    for name, edits in FLASH_VARIANTS.items():
        text = src
        for before, after in edits:
            if before not in text:
                chip_smoke.fail(f"variant {name}: {before!r} not in flash_attention.cu")
            text = text.replace(before, after)
        (old / f"{name}.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(old / f"{name}.so"), str(old / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            chip_smoke.fail(f"nvcc failed on {old / name}.cu:\n{log[-3000:]}")
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            entry = m.group(1) if m else entry
            if ("wide" in entry or "f32" in entry) and (
                    "C75" in line or ("spill" in line and " 0 bytes spill stores" not in line)
                    or "registers" in line):
                print(f"ptxas {name} {re.sub(r'.*?(flash_fwd_\w+?kernel)', r'\1', entry)[:60]}: "
                      f"{line.split(':', 1)[-1].strip()[:160]}", flush=True)
        libs[name] = ctypes.CDLL(str(old / f"{name}.so"))
    return libs


# K4 cases whose kernels were redesigned (b, h, s, d, causal, dtype).
FLASH_REDESIGNED = tuple(
    (1, 8, 2048, d, causal, dt) for dt in ("bfloat16", "float32") for d in (192, 256, 512)
    for causal in (True, False)) + (
    (8, 8, 2048, 256, True, "bfloat16"), (1, 8, 512, 128, True, "float32"))


def _old_launch(torch, lib, q, k, v, causal: bool):
    """The earlier build's K4 without a split plan: head_dim padded to a
    multiple of 128 above 128, its own C interface."""
    b, h, sq, d = q.shape
    dp = -(-d // 128) * 128 if d > 128 else d
    qq, kk, vv = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
    o = torch.empty_like(qq)
    rc = lib.dsst_flash_attention_fwd(
        qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(), b * h, sq, k.shape[2], dp,
        int(causal), int(q.dtype == torch.bfloat16), None, 0, None, 0, None, None, 0,
        torch.cuda.current_stream().cuda_stream, 1.0 / math.sqrt(d))
    chip_smoke.check(rc == 0, f"old K4 launch: CUDA error {rc}")
    return o[..., :d]


def flash_compare(torch, old: Path) -> list[dict]:
    """K4 of this tree against the build of ``old/flash_attention.cu``."""
    import importlib

    from dss_ml_at_scale_tpu_torch.ops import _build

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    out = old / "flash_attention.so"
    job = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(old / "flash_attention.cu")], capture_output=True, text=True)
    if job.returncode != 0:
        chip_smoke.fail(f"nvcc failed on {old}/flash_attention.cu:\n{job.stdout}{job.stderr}")
    new_lib = fa._kernel()
    old_lib = ctypes.CDLL(str(out))
    old_lib.dsst_flash_attention_fwd.argtypes = new_lib.dsst_flash_attention_fwd.argtypes
    old_lib.dsst_flash_attention_fwd.restype = I

    def launch_causal(lib, q, k, v, causal):
        # _launch with another library: the wrapper's checks, plan and
        # scratch are this tree's either way.
        saved, fa._lib = fa._lib, lib
        try:
            return fa._launch(q, k, v, causal)
        finally:
            fa._lib = saved

    def launch(lib, q, k, v):
        return launch_causal(lib, q, k, v, True)

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for b, h, s_, d in FLASH_SHAPES:
        q, k, v = (torch.randn(b, h, s_, d, generator=gen, device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        same = torch.equal(launch(old_lib, q, k, v), launch(new_lib, q, k, v))
        row = {"shape": f"causal b{b} h{h} s{s_} d{d}", "bit_identical": same,
               **turns({"old": lambda: launch(old_lib, q, k, v),
                        "new": lambda: launch(new_lib, q, k, v)})}
        print(json.dumps(row), flush=True)
        rows.append(row)
        chip_smoke.check(same, f"K4 {row['shape']}: output differs between builds")
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import attention_reference

    variants = build_flash_variants(old)
    for lib in variants.values():
        lib.dsst_flash_attention_fwd.argtypes = new_lib.dsst_flash_attention_fwd.argtypes
        lib.dsst_flash_attention_fwd.restype = I
    for b, h, s_, d, causal, dt in FLASH_REDESIGNED:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, h, s_, d, generator=gen, device="cuda", dtype=dtype)
                   for _ in range(3))
        fns = {"old": lambda: _old_launch(torch, old_lib, q, k, v, causal),
               "new": lambda: fa._launch(q, k, v, causal)}
        for name, lib in variants.items():
            if (name.startswith("f32") == (dt == "float32")
                    and (d == 192) == name.startswith("wide192")
                    and not (name.startswith("lockstep") and d == 192)):
                fns[name] = lambda lib=lib: launch_causal(lib, q, k, v, causal)
        ref = attention_reference(q, k, v, causal=causal).float()
        atol = chip_smoke.ATOL if dt == "bfloat16" else chip_smoke.ATOL_F32
        errs = {w: (fn().float() - ref).abs().max().item() for w, fn in fns.items()}
        row = {"shape": f"{'f32 ' if dt == 'float32' else ''}{'' if causal else 'non-'}causal "
                        f"b{b} h{h} s{s_} d{d}", "max_abs_err": errs, **turns(fns)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        chip_smoke.check(all(e <= atol for e in errs.values()),
                         f"K4 {row['shape']}: max abs err {errs} > {atol}")
        del q, k, v, ref
        torch.cuda.empty_cache()
    return rows


# Builds of this tree's fused_matmul_f32.cu with one decision changed, and
# the kernels each is timed for. flush_never: the wgmma chain never flushed
# into the f32 accumulator. For where the time goes (their results are
# wrong): one TF32 product a k8 step instead of three (one_pass), no product
# (no_product), K1f's and K3f's BN prologue skipped (k1f_no_prologue,
# k3f_no_prologue), K1f with neither (k1f_loads_only: its loads, barriers
# and epilogue), K1f without its TMA stores (k1f_no_store). And, each right:
# one register set for the A fragments instead of two (K1f then builds the
# next stage's fragment after the products, not while they run:
# k1f_one_fragment_set; K2f reads it into the same registers:
# k2f_one_fragment_set); K1f's thread 0 refilling a slot one stage later,
# after issuing the next stage's products, so it never waits for the other
# warpgroup (k1f_refill_late); K1f on a ring of two stages
# (k1f_two_stages); K1f staging its epilogue in 32-column boxes through two
# buffers (k1f_box_staging: four ring stages, three with a residual); K1f
# walking M first within a band of N, as the FFMA design did (k1f_m_first).
# K1f's epilogue, and the same block stored as four 32-column boxes through
# two 8 KB buffers a warpgroup that take turns (32 KB of staging instead of
# 64: a fourth ring stage, a third with a residual).
_K1F_EPILOGUE = """    // Epilogue: this warpgroup's 64 x 128 block into its staging tile (four
    // SW128 blocks of 64 rows x 32 columns, 8 KB each) once the previous
    // tile's store has read it, then out by TMA.
    if (storer) bulk_wait_read<0>();
    named_bar_sync(1 + wg, 128);
    const int row = wl * 16 + g;
#pragma unroll
    for (int i = 0; i < kFwdBN / 8; ++i) {  // columns 8 i + 2 tq, + 1
      const uint32_t at = s_wg + (i / 4) * (64 * 128) + (tq & 1) * 8;
      sts64(at + sw128(row, 2 * (i % 4) + tq / 2), acc[4 * i], acc[4 * i + 1]);
      sts64(at + sw128(row + 8, 2 * (i % 4) + tq / 2), acc[4 * i + 2], acc[4 * i + 3]);
    }
    fence_proxy_async();  // the staging tile's stores, visible to the TMA store
    named_bar_sync(1 + wg, 128);
    if (storer) {
      if (m0 + 64 * wg < M)
        for (int b = 0; b < kFwdBN / 32 && n0 + 32 * b < N; ++b)
          tma_store_2d(&tm_out, s_wg + b * (64 * 128), n0 + 32 * b, m0 + 64 * wg);
      bulk_commit();
    }
"""
_K1F_BOX_EPILOGUE = """    const int row = wl * 16 + g;
#pragma unroll
    for (int b = 0; b < kFwdBN / 32; ++b) {
      const uint32_t buf = s_wg + (b % 2) * (64 * 128);
      if (storer) bulk_wait_read<1>();
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int i = 4 * b; i < 4 * b + 4; ++i) {
        const uint32_t at = buf + (tq & 1) * 8;
        sts64(at + sw128(row, 2 * (i % 4) + tq / 2), acc[4 * i], acc[4 * i + 1]);
        sts64(at + sw128(row + 8, 2 * (i % 4) + tq / 2), acc[4 * i + 2], acc[4 * i + 3]);
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (storer) {
        if (m0 + 64 * wg < M && n0 + 32 * b < N)
          tma_store_2d(&tm_out, buf, n0 + 32 * b, m0 + 64 * wg);
        bulk_commit();
      }
    }
"""
_MMA3 = ("  wgmma_tf32<N>(d, hi, b_lo, scale_d);\n  wgmma_tf32<N>(d, lo, b_hi, 1);\n"
         "  wgmma_tf32<N>(d, hi, b_hi, 1);\n")
F32_VARIANTS = {
    "flush_never": (("constexpr bool kFlush = true;", "constexpr bool kFlush = false;"),),
    "one_pass": ((_MMA3, "  wgmma_tf32<N>(d, hi, b_hi, scale_d);\n"),),
    "no_product": ((_MMA3, ""),),
    "k1f_no_prologue": (
        ("    fwd_frags<RES>(hi, lo, s_ring + (q % stages) * kStage, a_row, tq, sc, tc);\n", ""),),
    "k1f_no_store": ((
        "          tma_store_2d(&tm_out, s_wg + b * (64 * 128), n0 + 32 * b, m0 + 64 * wg);\n",
        "          ;\n"),),
    "k1f_one_fragment_set": ((
        "      if (q & 1) {\n        stage_mma<kFwdBN>(chain, hi1, lo1, b_hi, scale_d);\n"
        "        if (more) frags(q + 1, hi0, lo0);\n      } else {\n"
        "        stage_mma<kFwdBN>(chain, hi0, lo0, b_hi, scale_d);\n"
        "        if (more) frags(q + 1, hi1, lo1);\n      }\n      wgmma_wait<0>();\n",
        "      stage_mma<kFwdBN>(chain, hi0, lo0, b_hi, scale_d);\n      wgmma_wait<0>();\n"
        "      if (more) frags(q + 1, hi0, lo0);\n"),),
    "k1f_loads_only": ((_MMA3, ""), (
        "    fwd_frags<RES>(hi, lo, s_ring + (q % stages) * kStage, a_row, tq, sc, tc);\n", "")),
    "k1f_refill_late": ((
        "        stage_mma<kFwdBN>(chain, hi1, lo1, b_hi, scale_d);\n",
        "        stage_mma<kFwdBN>(chain, hi1, lo1, b_hi, scale_d);\n"
        "        if (tid == 0 && q > 0) refill(q - 1);\n"), (
        "        stage_mma<kFwdBN>(chain, hi0, lo0, b_hi, scale_d);\n"
        "        if (more) frags(q + 1, hi1, lo1);\n",
        "        stage_mma<kFwdBN>(chain, hi0, lo0, b_hi, scale_d);\n"
        "        if (tid == 0 && q > 0) refill(q - 1);\n"
        "        if (more) frags(q + 1, hi1, lo1);\n"), (
        "      if (lane == 0) mbar_arrive(&empty[st]);  // stage q's tiles are read\n"
        "      if (tid == 0) refill(q);\n",
        "      if (lane == 0) mbar_arrive(&empty[st]);  // stage q's tiles are read\n")),
    "k1f_box_staging": (
        ("constexpr int kFwdOutBytes = kFwdBM * kFwdBN * 4;  // 64 KB: the staged out tile",
         "constexpr int kFwdOutBytes = kFwdBM * kFwdBN * 2;"),
        (_K1F_EPILOGUE, _K1F_BOX_EPILOGUE)),
    "k1f_m_first": ((  # both places the kernel maps a tile index to its origin
        "const int m0 = (tile / tiles_n) * kFwdBM, n0 = (tile % tiles_n) * kFwdBN;",
        "const int m0 = (tile % ((M + kFwdBM - 1) / kFwdBM)) * kFwdBM,\n"
        "              n0 = (tile / ((M + kFwdBM - 1) / kFwdBM)) * kFwdBN;"),),
    "k1f_two_stages": (("return std::min(4, (kSmemLimit - fwd_smem_bytes(res, 0))",
                        "return std::min(2, (kSmemLimit - fwd_smem_bytes(res, 0))"),),
    "k2f_one_fragment_set": ((
        "      if (kb & 1) {\n        da_frags(hi1, lo1, base, a_row, tq);\n"
        "        stage_mma<BN>(chain, hi1, lo1, base + kDaGBytes, scale_d);\n      } else {\n"
        "        da_frags(hi0, lo0, base, a_row, tq);\n"
        "        stage_mma<BN>(chain, hi0, lo0, base + kDaGBytes, scale_d);\n      }\n",
        "      da_frags(hi0, lo0, base, a_row, tq);\n"
        "      stage_mma<BN>(chain, hi0, lo0, base + kDaGBytes, scale_d);\n"),),
    "k3f_no_prologue": (("    const uint32_t yb = s_ring + (j % stages) * kStage;\n",
                         "    return;\n    const uint32_t yb = s_ring + (j % stages) * kStage;\n"),),
}
_ALL = ("K1f", "K2f", "K3f")
VARIANT_KERNELS = {"flush_never": _ALL, "one_pass": _ALL, "no_product": _ALL,
                   "k1f_no_prologue": ("K1f",), "k1f_no_store": ("K1f",),
                   "k1f_one_fragment_set": ("K1f",), "k2f_one_fragment_set": ("K2f",),
                   "k1f_loads_only": ("K1f",), "k1f_refill_late": ("K1f",),
                   "k1f_two_stages": ("K1f",), "k1f_box_staging": ("K1f",),
                   "k1f_m_first": ("K1f",),
                   "k3f_no_prologue": ("K3f",)}
# The parent's sources built beside fused_matmul_f32.cu in --old: the bf16
# kernels (K1-K3) and K4, held bit for bit against this tree's.
PARENT_BITWISE = ("fused_matmul", "flash_attention")


def build_f32(old: Path) -> dict[str, ctypes.CDLL]:
    """The parent's fused_matmul_f32.cu (and PARENT_BITWISE, with its
    hopper.cuh beside them in ``old``) and F32_VARIANTS of this tree's,
    built with this tree's flags; ptxas's register and spill lines of the
    TF32 kernels printed."""
    import re

    from dss_ml_at_scale_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_matmul_f32.cu").read_text()
    out = old / "f32_variants"  # not beside the old sources: their hopper.cuh
    out.mkdir(exist_ok=True)
    srcs = {"old": old / "fused_matmul_f32.cu",
            **{f"old_{name}": old / f"{name}.cu" for name in PARENT_BITWISE}}
    for name, edits in F32_VARIANTS.items():
        text = src
        for before, after in edits:
            if before not in text:
                chip_smoke.fail(f"variant {name}: {before!r} not in fused_matmul_f32.cu")
            text = text.replace(before, after)
        srcs[name] = out / f"{name}.cu"
        srcs[name].write_text(text)
    jobs = {name: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(path.with_suffix(".so")), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in srcs.items()}
    _build.build_all()
    logs = {"new": _build.build_log("fused_matmul_f32")}
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            chip_smoke.fail(f"nvcc failed on {srcs[name]}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(srcs[name].with_suffix(".so")))
        if name not in (f"old_{n}" for n in PARENT_BITWISE):
            logs[name] = log
    for name, log in logs.items():
        kern = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:  # e.g. fwd_tf32_kernelILb0E: K1f without a residual
                k = re.search(r"((?:fwd|bwd_da|bwd_dw)_tf32_kernelI\w*?E)EvN?\d*CUtensorMap", m.group(1))
                kern = k.group(1) if k else ""
            if "C75" in line or "serialized" in line or kern and (
                    "registers" in line or "spill stores" in line):
                print(f"ptxas {name} {kern}: {line.split(':', 1)[-1].strip()[:120]}", flush=True)
    return libs


def with_lib(module, attr: str, lib, fn, *args, **kwargs):
    """A wrapper of this tree run on another build of its C interface: the
    wrapper's checks, plan and scratch are this tree's."""
    saved = getattr(module, attr)
    setattr(module, attr, lib)
    try:
        return fn(*args, **kwargs)
    finally:
        setattr(module, attr, saved)


def parent_bitwise(torch, libs: dict) -> list[dict]:
    """bf16 K1-K3 at the four stage shapes with and without a residual, and
    K4 at FLASH_SHAPES and FLASH_REDESIGNED, this tree's build against the
    parent's: the outputs bit for bit (both builds take this tree's
    wrappers, plans and scratch)."""
    import importlib

    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    old_fm, old_fa = libs["old_fused_matmul"], libs["old_flash_attention"]
    new_fm, new_fa = fm._kernel(), fa._kernel()
    for lib, new in ((old_fm, new_fm), (old_fa, new_fa)):
        for fname in ("dsst_bn_relu_matmul_fwd", "dsst_bn_relu_matmul_bwd_da",
                      "dsst_bn_relu_matmul_bwd_dw", "dsst_flash_attention_fwd"):
            if hasattr(new, fname):
                getattr(lib, fname).argtypes = getattr(new, fname).argtypes
                getattr(lib, fname).restype = I
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name, m, k, n in chip_smoke.FUSED_SHAPES[:4]:
        y = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        mean = y.float().mean(0)
        inv = torch.rsqrt(y.float().var(0) + 1e-5)
        s_ = (torch.randn(k, generator=gen, device="cuda") * 0.2 + 1) * inv
        t_ = torch.randn(k, generator=gen, device="cuda") * 0.2 - mean * s_
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        g = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        for res in (None, torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)):
            outs = {}
            for what, lib in (("old", old_fm), ("new", new_fm)):
                outs[what] = with_lib(fm, "_lib", lib, lambda: (
                    fm.bn_relu_matmul_fwd(y, s_, t_, w, res),
                    *fm.bn_relu_matmul_bwd_da(g, w, y, s_, t_, mean, inv, res),
                    fm.bn_relu_matmul_bwd_dw(y, s_, t_, g, res)))
            same = dict(zip(("K1", "K2 gt", "K2 sum_g", "K2 sum_gx", "K3"),
                            (torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))))
            rows.append({"shape": f"bf16 {name} M{m} K{k} N{n}" + ("" if res is None else " +res"),
                         "bit_identical": same})
            print(json.dumps(rows[-1]), flush=True)
            chip_smoke.check(all(same.values()), f"{rows[-1]['shape']}: differs from the parent")
            del outs
        del y, g, w
        torch.cuda.empty_cache()
    cases = [(b, h, s_, d, True, "bfloat16") for b, h, s_, d in FLASH_SHAPES] + list(FLASH_REDESIGNED)
    for b, h, s_, d, causal, dt in cases:
        q, k, v = (torch.randn(b, h, s_, d, generator=gen, device="cuda", dtype=getattr(torch, dt))
                   for _ in range(3))
        same = torch.equal(*(with_lib(fa, "_lib", lib, fa._launch, q, k, v, causal)
                             for lib in (old_fa, new_fa)))
        rows.append({"shape": f"K4 {dt} {'' if causal else 'non-'}causal b{b} h{h} s{s_} d{d}",
                     "bit_identical": same})
        print(json.dumps(rows[-1]), flush=True)
        chip_smoke.check(same, f"{rows[-1]['shape']}: differs from the parent")
    return rows


def k1f_errors(out, ref) -> dict:
    """K1f against the plain version at JAX's element-by-element bar: the
    elements past rtol/atol 1e-5 and the worst one's share of its bar."""
    tol = chip_smoke.FUSED_F32_TOL
    diff = (out - ref).abs()
    share = diff / (tol + tol * ref.abs())
    return {"outside_bar": int((share > 1).sum()), "worst_share_of_bar": share.max().item(),
            "max_abs_err": diff.max().item()}


def f32_compare(torch, old: Path, card: str) -> list[dict]:
    """K1f-K3f of this tree against the parent's build of
    ``old/fused_matmul_f32.cu`` and F32_VARIANTS, and the parent's bf16
    kernels and K4 (``parent_bitwise``), as the docstring says."""
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    libs = build_f32(old)
    old_lib = libs.pop("old")
    rows = parent_bitwise(torch, {f"old_{n}": libs.pop(f"old_{n}") for n in PARENT_BITWISE})
    new_lib = fm._kernel_f32()
    for lib in (*libs.values(), old_lib):  # this tree's C interface, but for the old K1f
        for fname in ("dsst_bn_relu_matmul_fwd_f32", "dsst_bn_relu_matmul_bwd_da_f32",
                      "dsst_bn_relu_matmul_bwd_dw_f32"):
            getattr(lib, fname).argtypes = getattr(new_lib, fname).argtypes
            getattr(lib, fname).restype = I
    old_lib.dsst_bn_relu_matmul_fwd_f32.argtypes = [P] * 6 + [I] * 3 + [P]  # the FFMA K1f's
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    tol = chip_smoke.FUSED_F32_TOL

    def on(lib, fn, *args):
        return with_lib(fm, "_lib_f32", lib, fn, *args)

    gen = torch.Generator(device="cuda").manual_seed(4)
    randn = lambda *shape, std=1.0, mean=0.0: (  # noqa: E731
        torch.randn(*shape, generator=gen, device="cuda") * std + mean)
    for name, m, k, n in chip_smoke.FUSED_SHAPES[:4]:
        y = randn(m, k)
        mean = y.mean(0)
        inv = torch.rsqrt(y.square().mean(0) - mean.square() + 1e-5)
        s_ = randn(k, mean=1.0, std=0.2) * inv
        t_ = randn(k, std=0.2) - mean * s_
        w = randn(k, n, std=k ** -0.5)
        g = randn(m, n)
        x_hat = (y - mean) * inv
        tile_k = fm.dw_tile_k(k)
        for with_res in (False, True):
            res = randn(m, k) if with_res else None

            def k1_old():
                out = torch.empty(m, n, device="cuda")
                rc = old_lib.dsst_bn_relu_matmul_fwd_f32(
                    y.data_ptr(), ptr(res), s_.data_ptr(), t_.data_ptr(), w.data_ptr(),
                    out.data_ptr(), m, k, n, stream())
                chip_smoke.check(rc == 0, f"old K1f launch: CUDA error {rc}")
                return out

            k1 = {"old": k1_old, "new": lambda: fm.bn_relu_matmul_fwd(y, s_, t_, w, res)}
            k2 = {"old": lambda gg, ww: on(old_lib, fm.bn_relu_matmul_bwd_da, gg, ww, y, s_, t_,
                                           mean, inv, res),
                  "new": lambda gg, ww: fm.bn_relu_matmul_bwd_da(gg, ww, y, s_, t_, mean, inv, res)}
            k3 = {"old": lambda gg: on(old_lib, fm.bn_relu_matmul_bwd_dw, y, s_, t_, gg, res),
                  "new": lambda gg: fm.bn_relu_matmul_bwd_dw(y, s_, t_, gg, res)}
            for vname, lib in libs.items():
                kernels = VARIANT_KERNELS[vname]
                if "K1f" in kernels:
                    k1[vname] = lambda lib=lib: on(lib, fm.bn_relu_matmul_fwd, y, s_, t_, w, res)
                if "K2f" in kernels:
                    k2[vname] = lambda gg, ww, lib=lib: on(lib, fm.bn_relu_matmul_bwd_da, gg, ww,
                                                           y, s_, t_, mean, inv, res)
                if "K3f" in kernels:
                    k3[vname] = lambda gg, lib=lib: on(lib, fm.bn_relu_matmul_bwd_dw, y, s_, t_,
                                                       gg, res)
            case = f"f32 {name} M{m} K{k} N{n}" + (" +res" if with_res else "")
            # K1f: each build held to JAX's element-by-element bar (the
            # parent's FFMA design and this one fail the script past it).
            ref = fm.bn_relu_matmul_fwd_reference(y, s_, t_, w, res)
            errs = {}
            for what, fn in k1.items():
                e = errs[f"K1f {what}"] = k1f_errors(fn(), ref)
                chip_smoke.check(what not in ("old", "new") or e["outside_bar"] == 0,
                                 f"K1f {what} {case}: {e}")
            del ref
            z = fm._z(y, s_, t_, res)
            mask = z > 0
            a = torch.clamp_min(z, 0.0)
            rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s_, t_, mean, inv, res)
            dw64 = a.double().t() @ g.double()
            p_sg = rsg.double() - rgt.double().sum(0)
            p_sgx = rsgx.double() - (rgt * x_hat).double().sum(0)
            # K2f and K3f: the parent's build is this design; bit for bit.
            same = {"K2f": all(torch.equal(x, y_) for x, y_ in zip(k2["old"](g, w), k2["new"](g, w))),
                    "K3f": torch.equal(k3["old"](g), k3["new"](g))}
            chip_smoke.check(all(same.values()), f"{case}: K2f/K3f differ from the parent {same}")
            for what, fn in k2.items():
                # The mask bit for bit: with g and W positive no sum cancels,
                # so gt is nonzero exactly where the mask is on.
                positive_same = torch.equal(fn(g.abs(), w.abs())[0] != 0, mask)
                gt, sg, sgx = fn(g, w)
                flips = int(gt[~mask].ne(0).sum())
                # A sum that cancels to exactly zero in one order only.
                zero = mask & (gt == 0) & (rgt != 0)
                past = int((zero & (rgt.abs() > tol * rgt.abs().max())).sum())
                e = {"gt": chip_smoke._rel(gt, rgt), "mask_off_nonzero": flips,
                     "positive_operands_mask_same": positive_same,
                     "zero_where_plain_is_not": int(zero.sum()), "of_them_past_tol": past,
                     "sum_g": (sg.double() - gt.double().sum(0)).abs().max().item()
                     / rgt.double().sum(0).abs().max().item(),
                     "sum_gx": (sgx.double() - (gt * x_hat).double().sum(0)).abs().max().item()
                     / (rgt * x_hat).double().sum(0).abs().max().item()}
                plain = {"sum_g": p_sg.abs().max().item() / rgt.double().sum(0).abs().max().item(),
                         "sum_gx": p_sgx.abs().max().item()
                         / (rgt * x_hat).double().sum(0).abs().max().item()}
                errs[f"K2f {what}"] = e
                # The builds are held to chip_smoke.py's bars; the variants are recorded.
                ok = (e["gt"] <= tol and flips == 0 and past == 0 and positive_same
                      and all(e[x] <= tol or e[x] <= 2 * plain[x] for x in plain))
                chip_smoke.check(what not in ("old", "new") or ok,
                                 f"K2f {what} {case}: {e} (plain sums {plain})")
                del gt, sg, sgx, zero
            for what, fn in k3.items():
                e = (fn(g).double() - dw64).abs().max().item() / dw64.abs().max().item()
                errs[f"K3f {what}"] = {"dw": e}
                chip_smoke.check(what not in ("old", "new") or e <= tol,
                                 f"K3f {what} {case}: dW err {e} of max-abs")
            row = {"shape": case, "card": card, "k2f_k3f_bit_identical": same,
                   "k1f_walk_tiles_per_cta": max(map(len, fm.fwd_tile_walk(
                       m, n, torch.cuda.get_device_properties(0).multi_processor_count,
                       torch.float32))),
                   "rel_err": errs,
                   "K1f": turns({what: f for what, f in k1.items()}),
                   "K2f": turns({what: (lambda f=f: f(g, w)) for what, f in k2.items()}),
                   "K3f": turns({what: (lambda f=f: f(g)) for what, f in k3.items()})}
            if name == "stage1" and not with_res:
                # All of M as one run: the chain over 20,776 stages.
                one = {}
                for what, lib in (("new", new_lib), ("flush_never", libs["flush_never"])):
                    part = torch.empty(1, k, n, device="cuda")
                    dw = torch.empty(k, n, device="cuda")
                    rc = lib.dsst_bn_relu_matmul_bwd_dw_f32(
                        y.data_ptr(), None, s_.data_ptr(), t_.data_ptr(), g.data_ptr(),
                        part.data_ptr(), dw.data_ptr(), m, k, n, tile_k, 1,
                        math.ceil(m / 32) * 32, stream())
                    chip_smoke.check(rc == 0, f"K3f one run: CUDA error {rc}")
                    one[what] = (dw.double() - dw64).abs().max().item() / dw64.abs().max().item()
                row["one_run_k3f_rel_err"] = one
            print(json.dumps(row), flush=True)
            rows.append(row)
            del res, z, mask, a, rgt, rsg, rsgx, dw64
            torch.cuda.empty_cache()
        del y, g, w, x_hat
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="directory with the earlier fused_matmul.cu")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out/compare_torch_kernels.json")
    parser.add_argument("--flash", action="store_true",
                        help="compare K4 (flash_attention.cu) instead of K2 and K3")
    parser.add_argument("--fused-f32", action="store_true",
                        help="compare K1f-K3f (fused_matmul_f32.cu) instead of K2 and K3")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.flash or args.fused_f32:
        card = chip_smoke.card_line()
        print(card, flush=True)
        rows = flash_compare(torch, args.old) if args.flash else f32_compare(torch, args.old, card)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
        return 0
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build(args.old)
    old_fm, short_fm = libs["fused_matmul"], libs["fused_matmul_short_ring"]
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, m, k, n in chip_smoke.FUSED_SHAPES[:4]:
        y = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        mean = y.float().mean(0)
        inv = torch.rsqrt(y.float().var(0) + 1e-5)
        s_ = (torch.randn(k, generator=gen, device="cuda") * 0.2 + 1) * inv
        t_ = torch.randn(k, generator=gen, device="cuda") * 0.2 - mean * s_
        w = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
        g = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        res = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        bn, tile_k = fm.da_tile_n(k), fm.dw_tile_k(k)
        plan = fm.dw_plan(m, k, n, sm_count)
        old_plan = old_dw_splits(m, k, n, sm_count)

        def k2_with(lib, gg, ww, rr, new=True):
            rows_p = min(-(-m // 128) * -(-k // bn), sm_count) if new else -(-m // 128)
            gt = torch.empty(m, k, dtype=torch.bfloat16, device="cuda")
            part = torch.empty(rows_p, 2 * k, device="cuda")
            sums = torch.empty(2, k, device="cuda")
            tail = (bn, sm_count) if new else ()
            rc = lib.dsst_bn_relu_matmul_bwd_da(
                gg.data_ptr(), ww.data_ptr(), y.data_ptr(), ptr(rr), s_.data_ptr(),
                t_.data_ptr(), mean.data_ptr(), inv.data_ptr(), gt.data_ptr(), part.data_ptr(),
                sums.data_ptr(), m, k, n, *tail, stream())
            chip_smoke.check(rc == 0, f"K2 build launch: CUDA error {rc}")
            return gt, sums[0], sums[1]

        def k3_with(lib, gg, rr, new=True):
            splits, chunk = plan if new else old_plan
            part = torch.empty(splits, k, n, device="cuda")
            dw = torch.empty(k, n, device="cuda")
            tile = (tile_k,) if new else ()
            rc = lib.dsst_bn_relu_matmul_bwd_dw(
                y.data_ptr(), ptr(rr), s_.data_ptr(), t_.data_ptr(), gg.data_ptr(),
                part.data_ptr(), dw.data_ptr(), m, k, n, *tile, splits, chunk, stream())
            chip_smoke.check(rc == 0, f"K3 build launch: CUDA error {rc}")
            return dw

        # Each build as a function of (g, W, res) for K2 and (g, res) for K3.
        k2_fns = {
            "old": lambda gg, ww, rr: k2_with(old_fm, gg, ww, rr, new=False),
            "new": lambda gg, ww, rr: fm.bn_relu_matmul_bwd_da(gg, ww, y, s_, t_, mean, inv, rr),
            "new_short_ring": lambda gg, ww, rr: k2_with(short_fm, gg, ww, rr),
            "new_4_stages": lambda gg, ww, rr: k2_with(libs["fused_matmul_k2_4_stages"], gg, ww, rr),
            "new_sum_rows_per_column": lambda gg, ww, rr: k2_with(
                libs["fused_matmul_sum_rows_per_column"], gg, ww, rr),
        }
        k3_fns = {
            "old": lambda gg, rr: k3_with(old_fm, gg, rr, new=False),
            "new": lambda gg, rr: fm.bn_relu_matmul_bwd_dw(y, s_, t_, gg, rr),
            "new_short_ring": lambda gg, rr: k3_with(short_fm, gg, rr),
        }
        # The second pass in the form the tree does not use at this row count.
        other = "32x16" if plan[0] < 32 else "per_column"
        k3_fns[f"new_sum_rows_{other}"] = lambda gg, rr: k3_with(
            libs[f"fused_matmul_sum_rows_{other}"], gg, rr)

        rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s_, t_, mean, inv)
        rdw = fm.bn_relu_matmul_bwd_dw_reference(y, s_, t_, g)
        errs = {}
        for what, fn in k2_fns.items():
            gt, sg, sgx = fn(g, w, None)
            errs[f"K2 {what}"] = max(chip_smoke._rel(a, b) for a, b in
                                     ((gt, rgt), (sg, rsg), (sgx, rsgx)))
        for what, fn in k3_fns.items():
            errs[f"K3 {what}"] = chip_smoke._rel(fn(g, None), rdw)
        for what, e in errs.items():
            chip_smoke.check(e <= chip_smoke.FUSED_REL, f"{what} {name}: max-abs err {e}")
        del rgt, rsg, rsgx, rdw
        # A sum that cancels to exactly zero is rare: MASK_DRAWS draws of g.
        gs = [g] + [torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(MASK_DRAWS - 1)]
        masks = {"no_res": mask_check(torch, fm, k2_fns, gs, w, y, s_, t_, mean, inv, None),
                 "res": mask_check(torch, fm, k2_fns, gs, w, y, s_, t_, mean, inv, res)}
        del gs
        # a, bit for bit: with g the identity on its first rows, dW[:, j]
        # is row j of a (one product each, no sum).
        rows_a = min(m, n)
        eye = torch.zeros(m, n, dtype=torch.bfloat16, device="cuda")
        eye[:rows_a, :rows_a] = torch.eye(rows_a, dtype=torch.bfloat16, device="cuda")
        a_same = {}
        for rr, tag in ((None, ""), (res, " +res")):
            a = torch.clamp_min(fm._z(y[:rows_a], s_, t_, None if rr is None else rr[:rows_a]),
                                0.0).to(torch.bfloat16).float()
            for what, fn in k3_fns.items():
                a_same[what + tag] = torch.equal(fn(eye, rr)[:, :rows_a].t(), a)
        del eye
        row = {"shape": f"{name} M{m} K{k} N{n}", "card": card, "k2_tile_n": bn,
               "dw_tile_k": tile_k, "dw_plan": plan, "old_dw_plan": old_plan,
               "relu_masks": masks, "a_bit_identical": a_same, "rel_err": errs,
               "K2": turns({what: (lambda f=f: f(g, w, None)) for what, f in k2_fns.items()}),
               "K3": turns({what: (lambda f=f: f(g, None)) for what, f in k3_fns.items()})}
        print(json.dumps(row), flush=True)
        rows.append(row)
        chip_smoke.check(all(a_same.values()), f"{name}: a differs between builds")
        del y, g, w, res
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
