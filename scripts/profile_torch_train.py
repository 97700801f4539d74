#!/usr/bin/env python3
"""Where the time of the port's ResNet-50 or LM train step goes, on one NVIDIA card.

Run from the root of a checkout, on the machine with the card:

    python3 scripts/profile_torch_train.py [--out DIR] [--reader-sweep | --lm [--ffn moe]]

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

``--lm`` profiles the LM training step instead: the full-width LM of
``chip_smoke.py``'s LM-training phase (vocab 8192, dim 1024, 8 heads of
128, 4 layers, seq 2048, batch 8, bf16 compute, flash attention, Adam
3e-4, seeded weights) on one seeded token batch already on the card. Step
times: 2 warm-up steps, then 5 between synchronizes; then 2 steps under
``torch.profiler`` (with shapes): host wall, device busy time, idle share,
launches per step, and device ms per step by kind: K4 (the flash forward
kernel), the attention backward (every kernel launched inside
``attention_backward``, the chunked f32 recompute), bf16 products, f32
products (the ``lm_head``: the model's only f32 matrix products outside
the attention backward), and elementwise and other work.

``--lm --ffn moe`` does the same for the MoE LM of ``chip_smoke.py``'s
moe-lm phase (8 experts, capacity factor 1.25, ``LMTask`` with aux weight
0.01). The forward's MoE work is told apart by annotation (the router,
the experts' products, the index dispatch and combine around them); the
backward's kernels fall into the kinds above. Then each part of one
block alone, forward and backward at the step's shapes, timed on the
device (``chip_smoke.device_ms``): the router over 16,384 tokens, the
dispatch and combine, the experts' FFN over their 8 x 2,560 slots, and
the flash attention forward and backward; times 4 blocks a step.

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


MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


REGIONS = {"attention_backward": "attention backward (chunked f32 recompute)",
           "moe_router": "MoE router (forward)", "moe_experts": "MoE expert products (forward)",
           "moe_dispatch": "MoE dispatch and combine (forward)"}


def lm_kinds(trace: Path, steps: int) -> tuple[dict[str, float], float]:
    """Device ms per step by kind for the LM step, and launches per step.

    A kernel's launch is found by its correlation id; a kernel launched
    inside an annotation of :data:`REGIONS` takes the innermost one's kind;
    otherwise the innermost matrix-product op around its launch (inputs
    recorded with the profile's shapes) says bf16 or f32 product."""
    events = json.loads(trace.read_text())["traceEvents"]
    launch_at: dict = {}
    regions, products = [], []
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if str(cat).startswith("cuda_") and "correlation" in args:  # the launch API calls
            launch_at[args["correlation"]] = (e.get("tid"), e["ts"])
        elif cat == "user_annotation" and e.get("name") in REGIONS:
            regions.append((e["ts"], e["ts"] + e["dur"], REGIONS[e["name"]]))
        elif cat == "cpu_op" and e.get("name") in MATMULS:
            products.append((e.get("tid"), e["ts"], e["ts"] + e["dur"],
                             " ".join(str(t) for t in args.get("Input type", []))))
    totals: dict[str, float] = {}
    launches = 0
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        launches += 1
        tid, ts = launch_at.get(e.get("args", {}).get("correlation"), (None, None))
        inside = [r for r in regions if ts is not None and r[0] <= ts <= r[1]]
        if "flash_fwd" in e["name"] or "flash_combine" in e["name"]:
            k = "K4"
        elif inside:
            k = min(inside, key=lambda r: r[1] - r[0])[2]
        else:
            around = [p for p in products if p[0] == tid and ts is not None and p[1] <= ts <= p[2]]
            if not around:
                k = "elementwise and other"
            else:
                types = min(around, key=lambda p: p[2] - p[1])[3]
                k = "bf16 products" if "BFloat16" in types else "f32 products (lm_head)"
        totals[k] = totals.get(k, 0.0) + e["dur"] / 1e3 / steps
    return dict(sorted(totals.items(), key=lambda kv: -kv[1])), launches / steps


def _annotate(torch, owner, attr: str, region: str) -> None:
    """Wrap ``owner.attr`` so its kernels fall inside ``region`` in the trace."""
    inner = getattr(owner, attr)

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(region):
            return inner(*args, **kwargs)

    setattr(owner, attr, annotated)


def moe_parts(torch) -> dict:
    """Device ms of each part of one MoE block alone, forward and backward,
    at the full-width step's shapes."""
    import chip_smoke
    from dss_ml_at_scale_tpu_torch.models import MoEMLP
    from dss_ml_at_scale_tpu_torch.models.moe import expert_ffn, route
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    layer = MoEMLP(1024, 8, device="cuda")
    with torch.no_grad():
        for p in (layer.router.weight, layer.w_up, layer.w_down):
            p.normal_(0.0, 0.02, generator=gen)
    tokens = torch.randn(16384, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        r = route(tokens, layer.router.weight, 8, 1.25)
    slots_in = torch.randn(8, r.capacity, 1024, generator=gen, device="cuda").to(torch.bfloat16)

    def router():
        x = tokens.detach().requires_grad_()
        q = route(x, layer.router.weight, 8, 1.25)
        (q.gate.sum() + q.aux_loss).backward()

    def dispatch_combine():  # the index moves around an identity expert
        x = tokens.detach().requires_grad_()
        layer._experts = lambda t, a, b: t
        try:
            layer._index_dispatch(x, r, None, False).float().sum().backward()
        finally:
            del layer._experts

    def experts():
        x = slots_in.detach().requires_grad_()
        expert_ffn(x, layer.w_up, layer.b_up, layer.w_down, layer.b_down,
                   torch.bfloat16).float().sum().backward()

    q, k, v = (torch.randn(8, 8, 2048, 128, generator=gen, device="cuda").to(torch.bfloat16)
               .requires_grad_() for _ in range(3))

    def attention():
        flash_attention(q, k, v, causal=True).float().sum().backward()

    parts = {name: chip_smoke.device_ms(fn, launches=5) for name, fn in (
        ("router", router), ("dispatch_and_combine", dispatch_combine), ("experts", experts),
        ("attention", attention))}
    return {"block_fwd_bwd_ms": parts, "step_ms_4_blocks": {k: 4 * v for k, v in parts.items()},
            "capacity": r.capacity, "dropped_tokens": int((~r.kept).sum())}


def lm_profile(torch, out_dir: Path, ffn: str = "dense") -> None:
    import importlib

    from dss_ml_at_scale_tpu_torch.models import moe, seeded_lm
    from dss_ml_at_scale_tpu_torch.parallel import LMTask

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    _annotate(torch, fa, "attention_backward", "attention_backward")
    extra, aux = {}, 0.0
    if ffn == "moe":
        _annotate(torch, moe, "route", "moe_router")
        _annotate(torch, moe.MoEMLP, "_experts", "moe_experts")
        _annotate(torch, moe.MoEMLP, "_index_dispatch", "moe_dispatch")
        extra, aux = {"ffn": "moe", "num_experts": 8}, 0.01
    model = seeded_lm(0, device="cuda", attention="flash", vocab_size=8192, dim=1024,
                      num_heads=8, num_layers=4, max_seq=2048, **extra)
    task = LMTask(model=model, learning_rate=3e-4, aux_loss_weight=aux)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, 8192, (8, 2048), generator=gen, device="cuda")}
    for _ in range(2):
        task.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        task.train_step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(json.dumps({"lm_step_ms": step_ms, "tokens_per_sec": 8 * 2048 / step_ms * 1e3,
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
          flush=True)

    def steps():
        for _ in range(2):
            task.train_step(batch)

    name = f"lm_{ffn}_train_2_steps"
    row = profile(torch, name, steps, out_dir, top=12, record_shapes=True)
    row["step_ms"] = row["wall_ms"] / 2
    row["device_ms_per_step_by_kind"], row["launches_per_step"] = lm_kinds(
        out_dir / f"{name}.json", 2)
    print(json.dumps(row), flush=True)
    if ffn == "moe":
        del task, model
        torch.cuda.empty_cache()
        print(json.dumps({"moe_parts": moe_parts(torch)}), flush=True)


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
    parser.add_argument("--lm", action="store_true",
                        help="profile the full-width LM train step instead of ResNet-50")
    parser.add_argument("--ffn", choices=["dense", "moe"], default="dense",
                        help="with --lm: the dense LM or the MoE LM (8 experts)")
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
    if args.lm:
        lm_profile(torch, out_dir, args.ffn)
        print(f"card: {card}", flush=True)
        return 0
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
