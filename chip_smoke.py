#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card, and check it.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions; TF32
   off for matmuls and convolutions (the LM head is an f32 product, and
   the plain versions of the kernels must be full f32);
   builds every kernel of ``dss_ml_at_scale_tpu_torch/csrc`` with nvcc,
   one process per source, all at once; prints the build time, each
   kernel's registers, spills and static shared memory from ptxas, and the
   dynamic shared memory of K4 and K1.
2. kernels: the flash attention kernel (K4) against its plain version on the
   card, in bf16, at the serving shapes (b=1, h=8, d=128, causal, seq 128,
   512, 1024) plus a non-causal, an ``sq < sk`` and a d=64 case; atol
   2e-2, and a mean error under one bf16 spacing of the mean output. One
   f32 case holds the kernel's f32 variant, which serving does not take,
   to atol 2e-5. Median times (CUDA events) of the kernel, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never called
   by the port), beside the least time the card could take. At the three
   serving buckets also the kernel with and without its key-split plan
   (``split_ms``, ``nosplit_ms``), both held to the same limits, and the
   split output checked bit for bit from run to run.
3. fused-matmul kernels: K1 (BN-apply + ReLU + 1x1 conv forward), K2 (its
   masked input gradient with the BN channel sums) and K3 (its weight
   gradient) against their plain versions, in bf16, at the four ResNet-50
   stage shapes at batch 212, each with and without a residual, plus a
   ragged case (M, K and N on no tile boundary). K1's out to rtol 0.05 /
   atol 0.15 (the bf16 tolerance of tests/test_fused_matmul.py:203); gt,
   the two sums and dW to a max-abs error of one bf16 spacing (2^-7) of
   the plain result's max-abs: gt is stored in bf16, so it may differ by
   one rounding, while the sums and dW are f32 sums taken in another
   order. Times of each kernel, its plain version and the cuBLAS product of
   the same shapes alone (the matmul part only: no PyTorch call computes
   the fused function), beside the least time the card could take.
4. training: a 848-row train table and a 212-row val table from the port's
   ``datagen images`` (256 px JPEGs, 1000 classes), then the port's
   ``train`` entry at full width: ResNet-50, ``--pallas-fused``, batch
   212, crop 224, 1000 classes, bf16, Adam 1e-5, 4 steps and 1 eval batch.
   Checks finite loss and metrics and the kernels' launch counts (K1 16
   per train step and 16 per eval batch; K2 and K3 16 per train step);
   prints images/s, step ms and data wait over steps 2-4.
5. parity: the pallas-level ResNet-50 (kernels) against the fused-level
   one (no kernel) with identical weights, the last BN scale of every
   block nonzero (at its zero init the gradient reaching K2/K3 is exactly
   zero). The whole model on one batch: logits and loss within 2e-2 of
   max-abs, every conv3 weight and middle-BN gamma/beta gradient nonzero.
   Each of the 16 blocks alone at its full-width shape, with one input
   and one cotangent: its output within 2e-2, its conv3 weight and
   middle-BN gamma/beta gradients within 5e-2 of max-abs (bf16, rtol
   0.05 of tests/test_fused_matmul.py:203). The whole model's bf16
   gradients are not held to 5e-2: any two bf16 implementations of it
   differ by far more (PERF.md), while in f32 the two levels agree.
6. slice: the full-width LM (vocab 8192, dim 1024, 8 heads, 4 layers, bf16,
   flash attention, seeded random weights) behind the HTTP server: 8
   slots, max_len 2048, prefill buckets 128/512/1024. Six concurrent
   greedy ``/generate`` streams over every bucket, then the same six one
   at a time; checks the streams, the kernel launch count, the kernel's
   prefill logits against reference attention, and concurrent == solo
   tokens.
7. a ``kernels`` JSON line, the card line, and the device JSON line last.
"""

from __future__ import annotations

import http.client
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ATOL = 2e-2  # bf16 tolerance of tests/test_flash_attention.py:41
ATOL_F32 = 2e-5  # f32 tolerance of tests/test_flash_attention.py:23
# The mean error, over the mean magnitude of the plain version's output,
# must stay under one bf16 spacing (2^-7): atol alone is loose where
# the output is small, as it is in the long causal rows.
MEAN_REL = 2.0 ** -7
PEAK_FLOPS = {"bfloat16": 989e12,  # H100 SXM dense tensor-core peak
              "float32": 67e12}  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
LM = dict(vocab_size=8192, dim=1024, num_heads=8, num_layers=4, max_seq=2048)
SLOTS, MAX_LEN, BUCKETS = 8, 2048, (128, 512, 1024)
PROMPT_LENS = (17, 128, 300, 512, 700, 1000)  # two per bucket
NEW_TOKENS = 32
# K1-K3: (name, M, K, N) at batch 212 (M = 212 * H * W of the stage), plus
# a ragged case on no tile boundary of any of the three kernels.
FUSED_SHAPES = (
    ("stage1", 212 * 56 * 56, 64, 256),
    ("stage2", 212 * 28 * 28, 128, 512),
    ("stage3", 212 * 14 * 14, 256, 1024),
    ("stage4", 212 * 7 * 7, 512, 2048),
    ("ragged", 4133, 72, 200),
)
FUSED_RTOL, FUSED_ATOL = 0.05, 0.15  # K1 out: tests/test_fused_matmul.py:203
FUSED_REL = 2.0 ** -7  # gt, sums, dW: one bf16 spacing of the plain max-abs
PARITY_LOGITS = 2e-2  # pallas vs fused model: logits and loss, of max-abs
PARITY_GRADS = 5e-2  # conv3 and middle-BN gradients, of max-abs
TRAIN_ROWS, VAL_ROWS, BATCH, STEPS = 848, 212, 212, 4
SM_COUNT = 132  # set from the card in main()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def toolchain(_build) -> dict:
    """What the card's host offers for building kernels."""
    import importlib.metadata
    import importlib.util
    import os

    nvcc = _build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    return {
        "nvcc": nvcc,
        "nvcc_release": version.strip().splitlines()[-1],
        "triton": (importlib.metadata.version("triton")
                   if importlib.util.find_spec("triton") else None),
        "cutlass_headers": os.path.isdir("/usr/local/cutlass/include"),
    }


def device_ms(fn, launches: int = 20, trials: int = 3) -> float:
    """Device time of one call: ``launches`` calls queued back to back
    behind a GPU sleep (so the host's launch overhead is hidden), timed with
    CUDA events; the median over ``trials`` of the mean per call. Inputs
    stay in the 50 MB L2, as they are when the model calls the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms of GPU time to queue behind
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / launches)
    return statistics.median(means)


def kernel_phase(torch, F) -> list[dict]:
    import importlib

    from dss_ml_at_scale_tpu_torch.ops.flash_attention import (
        attention_reference, flash_attention,
    )

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("causal b1 h8 s128 d128", 128, 128, 128, True, bf16),
        ("causal b1 h8 s512 d128", 512, 512, 128, True, bf16),
        ("causal b1 h8 s1024 d128", 1024, 1024, 128, True, bf16),
        ("non-causal b1 h8 s512 d128", 512, 512, 128, False, bf16),
        ("causal b1 h8 sq256 sk1024 d128", 256, 1024, 128, True, bf16),
        ("causal b1 h8 s512 d64", 512, 512, 64, True, bf16),
        # The f32 kernel: off the serving path, held to the f32 contract.
        ("f32 causal b1 h8 s512 d128", 512, 512, 128, True, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, sq, sk, d, causal, dtype in cases:
        def mk(s):
            return torch.randn(1, 8, s, d, generator=gen, device="cuda",
                               dtype=dtype)

        q, k, v = mk(sq), mk(sk), mk(sk)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = attention_reference(q, k, v, causal=causal)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        mean_rel = diff.mean().item() / ref.float().abs().mean().item()
        atol = ATOL if dtype == bf16 else ATOL_F32
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(err <= atol, f"{name}: max abs err {err} > {atol}")
        check(mean_rel <= MEAN_REL,
              f"{name}: mean abs err {mean_rel} of the mean |output| > {MEAN_REL}")
        # SDPA's is_causal is top-left aligned: a mask gives the bottom-right
        # alignment when sq < sk.
        mask, is_causal = None, causal and sq == sk
        if causal and sq < sk:
            mask = (torch.arange(sq, device="cuda")[:, None] + (sk - sq)
                    >= torch.arange(sk, device="cuda")[None, :])
        pairs = sq * (sk - sq + 1) + sq * (sq - 1) // 2 if causal else sq * sk
        flops = 4 * 8 * d * pairs  # Q·Kᵀ and P·V over the visible pairs
        nbytes = 8 * d * (2 * sq + 2 * sk) * q.element_size()  # q, k, v read; o written
        t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")]
        t_bytes = nbytes / PEAK_BYTES
        row = {
            "shape": name,
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err,
            "atol": atol,
            "mean_rel_err": mean_rel,
        }
        if dtype == bf16 and causal and sq == sk:
            # A serving bucket: the split plan's launch against one CTA per
            # query tile, both held to the same limits; the split output
            # must be the same from run to run.
            whole = fa._launch(q, k, v, causal, split=False)
            again = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"{name}: split output differs between runs")
            werr = (whole.float() - ref.float()).abs()
            check(werr.max().item() <= atol, f"{name}: unsplit max abs err {werr.max().item()}")
            check(werr.mean().item() / ref.float().abs().mean().item() <= MEAN_REL,
                  f"{name}: unsplit mean abs err over the limit")
            plan = fa.split_plan(8, sq, sk, causal, SM_COUNT)
            row["split_items"] = None if plan is None else len(plan[0])
            row["split_ms"] = device_ms(lambda: fa._launch(q, k, v, causal, split=True))
            row["nosplit_ms"] = device_ms(lambda: fa._launch(q, k, v, causal, split=False))
        row.update({
            "ms": device_ms(lambda: flash_attention(q, k, v, causal=causal)),
            "plain_ms": device_ms(
                lambda: attention_reference(q, k, v, causal=causal)),
            "library_ms": device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=is_causal)),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        })
        print("kernel-case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def fused_kernel_phase(torch) -> dict[str, list[dict]]:
    """K1-K3 against their plain versions at the path's shapes."""
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"K1": [], "K2": [], "K3": []}

    def randn(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * std + mean).to(dtype)

    for name, m, k, n in FUSED_SHAPES:
        y = randn(m, k)
        y32 = y.float()
        mean = y32.mean(0)
        var = y32.square().mean(0) - mean.square()
        inv = torch.rsqrt(var + 1e-5)
        gamma = randn(k, mean=1.0, std=0.2, dtype=torch.float32)
        beta = randn(k, std=0.2, dtype=torch.float32)
        s = gamma * inv
        t = beta - mean * s
        w = randn(k, n, std=k ** -0.5)
        g = randn(m, n)
        for with_res in (False, True):
            res = randn(m, k) if with_res else None
            case = f"{name} M{m} K{k} N{n}" + (" +res" if with_res else "")
            rb = m * k * 2 if with_res else 0  # residual bytes
            # K1
            out = fm.bn_relu_matmul_fwd(y, s, t, w, res)
            torch.cuda.synchronize()
            ref = fm.bn_relu_matmul_fwd_reference(y, s, t, w, res)
            diff = (out.float() - ref.float()).abs()
            check(bool(torch.isfinite(out).all()), f"K1 {case}: non-finite output")
            bad = int((diff > FUSED_ATOL + FUSED_RTOL * ref.float().abs()).sum())
            check(bad == 0, f"K1 {case}: {bad} elements outside rtol {FUSED_RTOL} / atol {FUSED_ATOL}")
            a = torch.clamp_min(fm._z(y, s, t, res), 0.0).to(torch.bfloat16)
            bound, by = _bound(2 * m * k + rb + 2 * k * n + 2 * m * n + 8 * k, 2 * m * k * n)
            rows["K1"].append({
                "shape": case, "max_abs_err": diff.max().item(), "rel_err": _rel(out, ref),
                "ms": device_ms(lambda: fm.bn_relu_matmul_fwd(y, s, t, w, res)),
                "plain_ms": device_ms(lambda: fm.bn_relu_matmul_fwd_reference(y, s, t, w, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(a, w)),
                "bound_ms": bound, "bound_by": by,
            })
            # K2
            gt, sg, sgx = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
            torch.cuda.synchronize()
            rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res)
            errs = {"gt": _rel(gt, rgt), "sum_g": _rel(sg, rsg), "sum_gx": _rel(sgx, rsgx)}
            for what, e in errs.items():
                check(math.isfinite(e) and e <= FUSED_REL,
                      f"K2 {case}: {what} max-abs err {e} of max-abs > {FUSED_REL}")
            bound, by = _bound(2 * m * n + 2 * k * n + 2 * m * k + rb + 16 * k + 2 * m * k + 8 * k,
                               2 * m * k * n)
            rows["K2"].append({
                "shape": case, "rel_err": max(errs.values()), **{f"rel_err_{x}": e for x, e in errs.items()},
                "max_abs_err": (gt.float() - rgt.float()).abs().max().item(),
                "ms": device_ms(lambda: fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)),
                "plain_ms": device_ms(
                    lambda: fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(g, w.t())),
                "bound_ms": bound, "bound_by": by,
            })
            # K3
            dw = fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)
            torch.cuda.synchronize()
            rdw = fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res)
            e = _rel(dw, rdw)
            check(math.isfinite(e) and e <= FUSED_REL,
                  f"K3 {case}: dW max-abs err {e} of max-abs > {FUSED_REL}")
            bound, by = _bound(2 * m * k + rb + 8 * k + 2 * m * n + 4 * k * n, 2 * m * k * n)
            rows["K3"].append({
                "shape": case, "rel_err": e, "max_abs_err": (dw - rdw).abs().max().item(),
                "ms": device_ms(lambda: fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)),
                "plain_ms": device_ms(lambda: fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(a.t(), g)),
                "bound_ms": bound, "bound_by": by,
            })
            for kname in rows:
                print(f"kernel-case {kname} " + json.dumps(rows[kname][-1]), flush=True)
        del y, y32, g, w
        torch.cuda.empty_cache()
    return rows


def train_phase(torch) -> dict:
    """The port's datagen and train entries at full width, 4 steps + 1 eval."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    train, val = str(work / "train"), str(work / "val")
    t0 = time.perf_counter()
    for out, n, seed in ((train, TRAIN_ROWS, 0), (val, VAL_ROWS, 1)):
        rc = cli.main(["datagen", "images", "--out", out, "--n", str(n), "--classes", "1000",
                       "--size", "256", "--seed", str(seed)])
        check(rc == 0, f"datagen images exited {rc}")
    datagen_s = time.perf_counter() - t0
    args = cli.build_parser().parse_args([
        "train", "--data", train, "--val-data", val, "--model", "resnet50", "--pallas-fused",
        "--batch-size", str(BATCH), "--crop", "224", "--num-classes", "1000", "--epochs", "1",
        "--limit-val-batches", "1", "--decode-backend", "pil",
    ])
    # The main path: counts set to 0 just before, read just after.
    fm.bn_relu_matmul_fwd.launches = 0
    fm.bn_relu_matmul_bwd_da.launches = 0
    fm.bn_relu_matmul_bwd_dw.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = cli.run_train(args)
    wall = time.perf_counter() - t0
    launches = {"K1": fm.bn_relu_matmul_fwd.launches, "K2": fm.bn_relu_matmul_bwd_da.launches,
                "K3": fm.bn_relu_matmul_bwd_dw.launches}
    epoch = summary["history"][0]
    check(summary["steps"] == STEPS, f"train ran {summary['steps']} steps, want {STEPS}")
    for key in ("train_loss", "train_acc", "grad_norm", "val_loss", "val_acc"):
        check(key in epoch and math.isfinite(epoch[key]), f"train metric {key}: {epoch.get(key)}")
    check(epoch["grad_norm"] > 0, "zero gradient norm")
    want = {"K1": 16 * STEPS + 16, "K2": 16 * STEPS, "K3": 16 * STEPS}
    check(launches == want, f"kernel launches {launches}, want {want}")
    return {
        "launches": launches,
        "datagen_s": datagen_s,
        "wall_s": wall,
        "train_loss": epoch["train_loss"],
        "train_acc": epoch["train_acc"],
        "grad_norm": epoch["grad_norm"],
        "val_loss": epoch["val_loss"],
        "val_acc": epoch["val_acc"],
        "images_per_sec_steps_2_4": epoch["steady_images_per_sec"],
        "step_ms_steps_2_4": epoch["steady_step_time_s"] * 1e3,
        "data_wait_ms_steps_2_4": epoch["steady_data_wait_s"] * 1e3,
        "epoch_images_per_sec": epoch["images_per_sec"],
        "decode_backend": summary["decode_backend"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }


def parity_phase(torch) -> dict:
    """The pallas-level ResNet-50 against the fused-level one: the whole
    model on one batch (logits, loss; every conv3 and middle-BN gradient
    nonzero), then each of the 16 blocks alone at its full-width shape with
    one input and one cotangent (its conv3 and middle-BN gradients)."""
    import torch.nn.functional as F

    from dss_ml_at_scale_tpu_torch.models import seeded_resnet
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    config = dict(stage_sizes=[3, 4, 6, 3], num_classes=1000, dtype=torch.bfloat16)
    kernel = seeded_resnet(0, device="cuda", fused_bn="pallas", **config)
    plain = seeded_resnet(0, device="cuda", fused_bn=True, **config)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in kernel.named_parameters():
            if name.endswith("bn3.weight"):  # zero-init would hide the backward
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + 0.1)
    plain.load_state_dict(kernel.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(BATCH, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    before = fm.bn_relu_matmul_bwd_dw.launches
    out = {}
    for tag, model in (("kernel", kernel), ("plain", plain)):
        logits = model(x)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        out[tag] = (logits.detach(), loss.detach())
    torch.cuda.synchronize()
    check(fm.bn_relu_matmul_bwd_dw.launches == before + 16, "parity step missed the kernels")
    logits_err = _rel(out["kernel"][0], out["plain"][0])
    loss_err = abs(out["kernel"][1].item() - out["plain"][1].item()) / abs(out["plain"][1].item())
    check(bool(torch.isfinite(out["kernel"][0]).all()), "non-finite logits")
    check(logits_err <= PARITY_LOGITS, f"logits differ by {logits_err} of max-abs")
    check(loss_err <= PARITY_LOGITS, f"loss differs by {loss_err}")
    names = [n for n, _ in kernel.named_parameters()
             if n.endswith(("conv3.weight", "bn2.weight", "bn2.bias"))]
    check(len(names) == 48, f"{len(names)} conv3/bn2 parameters, want 48")
    grads = dict(plain.named_parameters())
    model_errs = []
    for name, p in kernel.named_parameters():
        if name in names:
            a, b = p.grad, grads[name].grad
            check(a is not None and a.abs().max().item() > 0, f"{name}: zero gradient")
            model_errs.append(_rel(a, b))
    # Block by block: the model-level bf16 gradients of two implementations
    # differ far beyond 5e-2 (any two, the JAX package's own BN levels
    # included), so the gradient check holds each block to one input.
    block_errs, out_errs = [], []
    for li, count in enumerate(config["stage_sizes"], start=1):
        for j in range(count):
            kb, pb = getattr(kernel, f"layer{li}")[j], getattr(plain, f"layer{li}")[j]
            hw = 56 >> (li - 1) if j else 56 >> max(li - 2, 0)  # the block's input
            xb = torch.randn(BATCH, hw, hw, kb.conv1.weight.shape[1], generator=gen,
                             device="cuda", dtype=torch.bfloat16)
            yb = {}
            for tag, blk in (("kernel", kb), ("plain", pb)):
                blk.zero_grad()
                yb[tag] = blk(xb)
            cot = torch.randn(yb["plain"].shape, generator=gen, device="cuda",
                              dtype=torch.bfloat16)
            for tag, blk in (("kernel", kb), ("plain", pb)):
                yb[tag].backward(cot)
            out_errs.append(_rel(yb["kernel"].detach(), yb["plain"].detach()))
            for attr in ("conv3.weight", "bn2.weight", "bn2.bias"):
                a = kb.get_parameter(attr).grad
                b = pb.get_parameter(attr).grad
                check(a.abs().max().item() > 0, f"layer{li}.{j}.{attr}: zero gradient")
                e = _rel(a, b)
                check(e <= PARITY_GRADS, f"layer{li}.{j}.{attr}: gradient differs by {e} of max-abs")
                block_errs.append(e)
    check(max(out_errs) <= PARITY_LOGITS, f"a block's output differs by {max(out_errs)} of max-abs")
    result = {"logits_rel_err": logits_err, "loss_rel_err": loss_err,
              "loss": out["kernel"][1].item(),
              "model_grad_rel_err_max": max(model_errs),
              "model_grad_rel_err_median": statistics.median(model_errs),
              "block_out_rel_err_max": max(out_errs),
              "block_grad_rel_err_max": max(block_errs),
              "block_grads_checked": len(block_errs)}
    del kernel, plain, out, grads
    torch.cuda.empty_cache()
    return result

def stream(port: int, prompt: list[int]) -> dict:
    """One greedy /generate: tokens, terminal line, client-side TTFT."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/generate", json.dumps(
        {"tokens": prompt, "max_new_tokens": NEW_TOKENS}).encode(),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        fail(f"/generate answered {resp.status}: {resp.read()!r}")
    tokens, ttft, done = [], None, None
    for raw in iter(resp.readline, b""):
        line = json.loads(raw)
        if "done" in line:
            done = line
            break
        if ttft is None:
            ttft = time.perf_counter() - t0
        tokens.append(line["token"])
    resp.read()
    conn.close()
    return {"tokens": tokens, "done": done, "ttft_s": ttft}


def slice_phase(torch) -> dict:
    import numpy as np

    from dss_ml_at_scale_tpu_torch import telemetry
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.serving.lm import (
        LMConfig, LMEngine, TransformerDecoder,
    )
    from dss_ml_at_scale_tpu_torch.workloads.serving import serve_lm_in_thread

    t0 = time.perf_counter()
    model = seeded_lm(0, device="cuda", dtype=torch.bfloat16,
                      attention="flash", **LM)
    engine = LMEngine(
        TransformerDecoder(model, slots=SLOTS, max_len=MAX_LEN, buckets=BUCKETS),
        LMConfig(slots=SLOTS, max_len=MAX_LEN, prefill_buckets=BUCKETS,
                 queue_depth=32),
    ).start()
    handle = serve_lm_in_thread(engine)
    print(f"slice: model + engine warm in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM["vocab_size"], n)]
               for n in PROMPT_LENS]
    try:
        # The main path: counts set to 0 just before, read just after.
        flash_attention.launches = 0
        results = [None] * len(prompts)

        def run(i):
            results[i] = stream(handle.port, prompts[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        launches = flash_attention.launches
        check(all(r is not None for r in results), "a concurrent stream did not finish")
        for n, r in zip(PROMPT_LENS, results):
            check(r["done"] is not None and r["done"]["done"] == "max_tokens",
                  f"prompt {n}: stream ended {r['done']}")
            check(len(r["tokens"]) == NEW_TOKENS == r["done"]["tokens"],
                  f"prompt {n}: {len(r['tokens'])} tokens streamed")
            check(all(0 <= t < LM["vocab_size"] for t in r["tokens"]),
                  f"prompt {n}: token out of range")
        want = len(prompts) * LM["num_layers"]
        check(launches == want,
              f"flash kernel launched {launches} times, want {want} "
              "(prefills x layers)")

        solo = [stream(handle.port, p) for p in prompts]
        for n, r, s in zip(PROMPT_LENS, results, solo):
            check(r["tokens"] == s["tokens"],
                  f"prompt {n}: concurrent tokens differ from solo")

        snap = {m["name"]: m for m in telemetry.snapshot()["metrics"]
                if m["type"] == "histogram" and not m["labels"]}
    finally:
        handle.close()

    with torch.inference_mode():
        tokens = torch.tensor([prompts[3]], device="cuda")  # 512: one bucket
        got = model(tokens)
        ref = model(tokens, attention="reference")
    scale = ref.abs().max().item()
    rel = (got - ref).abs().max().item() / scale
    check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    check(rel <= ATOL, f"flash prefill logits differ from reference by {rel} of max-abs")

    ttfts = [r["ttft_s"] for r in results]
    n_tokens = sum(len(r["tokens"]) for r in results)

    def mean_ms(name):
        m = snap[name]
        return m["sum"] / m["count"] * 1e3 if m["count"] else None

    return {
        "launches": launches,
        "prefill_logits_rel_err": rel,
        "concurrent_streams": len(prompts),
        "tokens": n_tokens,
        "distinct_tokens": len({t for r in results for t in r["tokens"]}),
        "wall_s": wall,
        "tokens_per_s": n_tokens / wall,
        "ttft_ms_median": statistics.median(ttfts) * 1e3,
        "ttft_ms_max": max(ttfts) * 1e3,
        "prefill_ms_mean": mean_ms("lm_prefill_seconds"),
        "decode_step_ms_mean": mean_ms("lm_decode_step_seconds"),
    }


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    try:
        from dss_ml_at_scale_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"card: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmuls and convolutions", flush=True)

    print("toolchain: " + json.dumps(toolchain(_build)), flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} kernel source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in built:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)
    global SM_COUNT
    SM_COUNT = torch.cuda.get_device_properties(0).multi_processor_count
    import importlib

    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    k4, k1 = fa._kernel(), fm._kernel()
    print(f"dynamic shared memory per CTA: K4 d128 {k4.dsst_flash_attention_smem_bytes(128)} B, "
          f"K1 K512 {k1.dsst_bn_relu_matmul_fwd_smem_bytes(512, 0)} B "
          f"(+res {k1.dsst_bn_relu_matmul_fwd_smem_bytes(512, 1)} B); {SM_COUNT} SMs", flush=True)

    cases = kernel_phase(torch, F)
    fused = fused_kernel_phase(torch)
    training = train_phase(torch)
    print(f"training ({kind}; {card}): " + json.dumps(training), flush=True)
    torch.cuda.empty_cache()
    parity = parity_phase(torch)
    print(f"parity ({kind}; {card}): " + json.dumps(parity), flush=True)
    serving = slice_phase(torch)
    print(f"serving ({kind}; {card}): " + json.dumps(serving), flush=True)

    head = cases[2]  # causal s1024: the largest prefill bucket of the path
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "dss_ml_at_scale_tpu_torch/csrc/flash_attention.cu",
        "replaces": "dss_ml_at_scale_tpu/ops/flash_attention.py:70",
        "launches": serving["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "cases": cases,
    }]
    sources = (("K1", "bn_relu_matmul_fwd", ":113"), ("K2", "bn_relu_matmul_bwd_da", ":128"),
               ("K3", "bn_relu_matmul_bwd_dw", ":159"))
    for key, name, line in sources:
        head = fused[key][0]  # stage 1: the site that moves the most bytes
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dss_ml_at_scale_tpu_torch/csrc/fused_matmul.cu",
            "replaces": "dss_ml_at_scale_tpu/ops/fused_matmul.py" + line,
            "launches": training["launches"][key],
            "max_abs_err": max(c["max_abs_err"] for c in fused[key]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "cuBLAS product of the same shapes (matmul part only)",
            "shape": head["shape"],
            "cases": fused[key],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
