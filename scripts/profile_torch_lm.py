#!/usr/bin/env python3
"""Where the time of the port's LM serving goes, on one NVIDIA card.

Run from the root of a checkout, on the machine with the card:

    python3 scripts/profile_torch_lm.py [--out DIR]

Builds the full-width LM of ``chip_smoke.py`` (vocab 8192, dim 1024, 8
heads, 4 layers, bf16, flash attention, seeded weights) and its serving
decoder (8 slots, max_len 2048), prefills one prompt per bucket (128, 512,
1024) into slots 0..2, then runs 20 decode steps over all 8 slots, each
phase under ``torch.profiler``. Prints one JSON line per phase: host wall
time, device busy time (the union of kernel intervals on the timeline), the
device's idle share, and the kernels that took the most device time. The
Chrome traces go to ``--out`` (default ``build/profile_torch_lm``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def busy_ms(events) -> float:
    """Union of device kernel intervals, in ms (overlaps counted once)."""
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("cat") == "kernel" and "dur" in e
    )
    total, end = 0.0, None
    start = None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total / 1e3  # trace timestamps are µs


def profile(torch, name: str, fn, out_dir: Path, top: int = 8,
            record_shapes: bool = False) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    trace = out_dir / f"{name}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"] / 1e3
    busy = busy_ms(events)
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {
        "phase": name,
        "wall_ms": wall,
        "device_busy_ms": busy if by_kernel else "not measured",
        "device_idle_share": (1.0 - busy / wall) if by_kernel else "not measured",
        "kernels": len(by_kernel),
        "top_kernels_ms": [[k[:90], v] for k, v in ranked],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/profile_torch_lm",
                        help="directory for the Chrome traces")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_lm: needs a CUDA card", file=sys.stderr)
        return 1
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.serving.lm import TransformerDecoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    model = seeded_lm(0, device="cuda", dtype=torch.bfloat16, attention="flash",
                      vocab_size=8192, dim=1024, num_heads=8, num_layers=4,
                      max_seq=2048)
    dec = TransformerDecoder(model, slots=8, max_len=2048, buckets=(128, 512, 1024))
    dec.warmup()
    rng = np.random.default_rng(0)
    prompts = {b: rng.integers(1, 8192, (1, b)).astype(np.int32)
               for b in (128, 512, 1024)}
    for bucket, slot in zip(prompts, range(3)):
        print(json.dumps(profile(
            torch, f"prefill_{bucket}",
            lambda: dec.prefill(prompts[bucket], bucket, slot), out_dir)), flush=True)

    tokens = np.ones(8, np.int32)
    pos = np.array([128, 512, 1024, 0, 0, 0, 0, 0], np.int32)

    def steps():
        for i in range(20):
            dec.step(tokens, pos + i)

    row = profile(torch, "decode_20_steps", steps, out_dir)
    row["step_ms"] = row["wall_ms"] / 20
    print(json.dumps(row), flush=True)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
