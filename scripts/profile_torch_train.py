#!/usr/bin/env python3
"""Where the time of the port's ResNet-50 train step goes, on one NVIDIA card.

Run from the root of a checkout, on the machine with the card:

    python3 scripts/profile_torch_train.py [--out DIR] [--reader-sweep]

Builds the full-width ResNet-50 of ``chip_smoke.py``'s training phase
(1000 classes, bf16, seeded weights) at the fused BN level and at the
pallas level (kernels K1-K3), and feeds ``ClassifierTask.train_step`` one
synthetic batch of 212 normalized 224 px images already on the card, so
the input pipeline is out of the picture. Step times: 2 warm-up steps,
then 5 steps between synchronizes, the two levels in turns (fused, pallas,
pallas, fused). Then 2 pallas-level steps under ``torch.profiler``: host
wall, device busy time, the device's idle share, the device time per step
by kind of kernel (K1-K3, convolutions and matrix products of the
libraries, reductions, copies and casts, other elementwise), and the
kernels that took the most device time. One JSON line per
measurement; Chrome traces go to ``--out`` (default
``build/profile_torch_train``).

``--reader-sweep`` runs the port's ``train`` entry on real data instead:
``chip_smoke.py``'s 848-row table (``datagen images``, 256 px, 1000
classes), ResNet-50 at the pallas level, 4 steps, under several reader
settings (decode workers, results-queue bound, image dtype), and prints the
step time, images/s and data wait over steps 2-4 of each.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from profile_torch_lm import profile  # noqa: E402

BATCH, CROP = 212, 224
# csrc/fused_matmul.cu: K1, K2, K3 and their second pass.
KERNELS = tuple(f"(anonymous namespace)::{k}" for k in (
    "fwd_kernel", "bwd_da_kernel", "bwd_dw_kernel", "sum_rows_kernel"))
LIBRARY = ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "sm90", "cutlass", "gemm",
           "nvjet")


def kind(name: str) -> str:
    """The kind of a device kernel, by its name."""
    if any(k in name for k in KERNELS):
        return "K1-K3"
    if "elementwise" not in name and any(k in name.lower() for k in LIBRARY):
        return "convolutions and products (cuDNN, cuBLAS)"
    if "reduce_kernel" in name:
        return "reductions"
    if "copy" in name:
        return "copies and casts"
    if "elementwise" in name:
        return "other elementwise"
    return "other"


def by_kind(trace: Path, steps: int) -> tuple[dict[str, float], float]:
    """Device ms per step by kind of kernel, and kernel launches per step,
    from a Chrome trace."""
    totals: dict[str, float] = {}
    launches = 0
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("cat") == "kernel" and "dur" in e:
            k = kind(e["name"])
            totals[k] = totals.get(k, 0.0) + e["dur"] / 1e3 / steps
            launches += 1
    return dict(sorted(totals.items(), key=lambda kv: -kv[1])), launches / steps


def reader_sweep(torch) -> None:
    import tempfile

    from dss_ml_at_scale_tpu_torch.config import cli

    work = Path(tempfile.mkdtemp(prefix="reader_sweep_"))
    assert cli.main(["datagen", "images", "--out", str(work / "t"), "--n", "848",
                     "--classes", "1000", "--size", "256"]) == 0
    for workers, queue, dtype in ((4, 20, "float32"), (2, 20, "float32"), (4, 2, "float32"),
                                  (1, 2, "float32"), (4, 20, "uint8")):
        args = cli.build_parser().parse_args([
            "train", "--data", str(work / "t"), "--model", "resnet50", "--pallas-fused",
            "--epochs", "1", "--decode-backend", "pil", "--workers", str(workers),
            "--queue-size", str(queue), "--image-dtype", dtype])
        epoch = cli.run_train(args)["history"][0]
        print(json.dumps({"workers": workers, "queue_size": queue, "image_dtype": dtype,
                          "step_ms_steps_2_4": epoch["steady_step_time_s"] * 1e3,
                          "images_per_sec_steps_2_4": epoch["steady_images_per_sec"],
                          "data_wait_ms_steps_2_4": epoch["steady_data_wait_s"] * 1e3}),
              flush=True)
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/profile_torch_train",
                        help="directory for the Chrome traces")
    parser.add_argument("--reader-sweep", action="store_true",
                        help="time the train entry on real data under several reader settings")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.reader_sweep:
        reader_sweep(torch)
        print(f"card: {card}", flush=True)
        return 0
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn(BATCH, CROP, CROP, 3, generator=gen, device="cuda"),
             "label": torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")}

    def task_for(level):
        model = build_classifier_model("resnet50", num_classes=1000, torch_padding=False,
                                       fused_bn=level, device="cuda")
        return ClassifierTask(model=model)

    for level in (True, "pallas", "pallas", True):
        task = task_for(level)
        for _ in range(2):
            task.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            task.train_step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(json.dumps({"fused_bn": level, "step_ms": step_ms,
                          "images_per_sec": BATCH / step_ms * 1e3,
                          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
              flush=True)
        del task
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    task = task_for("pallas")
    task.train_step(batch)

    def steps():
        for _ in range(2):
            task.train_step(batch)

    row = profile(torch, "train_2_steps", steps, out_dir, top=12)
    row["step_ms"] = row["wall_ms"] / 2
    row["device_ms_per_step_by_kind"], row["launches_per_step"] = by_kind(
        out_dir / "train_2_steps.json", 2)
    print(json.dumps(row), flush=True)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
