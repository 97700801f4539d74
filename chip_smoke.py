#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card, and check it.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions; TF32
   off for matmuls and convolutions (the LM head is an f32 product);
   builds every kernel of ``dss_ml_at_scale_tpu_torch/csrc`` with nvcc.
2. kernels: the flash attention kernel against its plain version on the
   card, in bf16, at the serving shapes (b=1, h=8, d=128, causal, seq 128,
   512, 1024) plus a non-causal, an ``sq < sk`` and a d=64 case; atol
   2e-2, and a mean error under one bf16 spacing of the mean output. One
   f32 case holds the kernel's f32 variant, which serving does not take,
   to atol 2e-5. Median times (CUDA events) of the kernel, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never called
   by the port), beside the least time the card could take.
3. slice: the full-width LM (vocab 8192, dim 1024, 8 heads, 4 layers, bf16,
   flash attention, seeded random weights) behind the HTTP server: 8
   slots, max_len 2048, prefill buckets 128/512/1024. Six concurrent
   greedy ``/generate`` streams over every bucket, then the same six one
   at a time; checks the streams, the kernel launch count, the kernel's
   prefill logits against reference attention, and concurrent == solo
   tokens.
4. a ``kernels`` JSON line, the card line, and the device JSON line last.
"""

from __future__ import annotations

import http.client
import json
import statistics
import subprocess
import sys
import threading
import time

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
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import (
        attention_reference, flash_attention,
    )

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
            "ms": device_ms(lambda: flash_attention(q, k, v, causal=causal)),
            "plain_ms": device_ms(
                lambda: attention_reference(q, k, v, causal=causal)),
            "library_ms": device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=is_causal)),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        print("kernel-case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


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
            if "registers" in line:
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)

    cases = kernel_phase(torch, F)
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
