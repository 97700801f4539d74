"""Where two same-seed ``train`` runs of the port part on the card, and what
the deterministic kernels cost.

Three probes, each a section of one JSON document on stdout:

- ``steps``: the chaos soak's training shape (``--model tiny``, 4 classes,
  crop 32, batch 16, lr 0.01; 48 rows, one reader worker, no shuffle, no
  augmentation) fed the same host batches twice per setting, from the same
  seed-0 weights; the digest of every parameter and buffer after each step.
  Reports the first step whose digests differ and the largest difference
  there. Settings: ``default`` (cuDNN free to pick any algorithm),
  ``cudnn`` (``cudnn.deterministic``, no autotuning), ``strict``
  (``torch.use_deterministic_algorithms``).
- ``cli``: the soak's own ``train`` argv run twice as processes for 2
  epochs; the digest of each run's final checkpoint (the soak's
  ``params_bitwise_equal`` probe).
- ``resnet50``: the full-width ResNet-50 ``--pallas-fused`` step (batch
  212, crop 224) from seed-0 weights, 3 steps on one seeded batch, twice
  per setting (``default``, ``cudnn``): the first step whose digests differ.
- ``photos``: ``pipelines/real_photos_train.json``'s train argv (``tiny``,
  2 classes, crop 64, batch 16, lr 0.003, 8 epochs, one reader worker,
  shuffled row groups; no val table) twice on one ingested table: the
  final checkpoints' digests and the per-epoch train losses.
- ``cost``: the full-width ResNet-50 ``--pallas-fused`` step (batch 212,
  crop 224) and the full-width LM step (vocab 8192, dim 1024, 8 heads, 4
  layers, seq 2048, batch 8), data on the card, timed with cuDNN's
  deterministic mode off and on in turns (off, on, on, off, ...).

Run on a card:  python scripts/replay_probe.py [--skip-cost] [--skip-cli]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def set_mode(mode: str) -> None:
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = mode in ("cudnn", "strict")
    torch.use_deterministic_algorithms(mode == "strict")


def digest(tensors: dict) -> str:
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def host_batches(data: Path, epochs: int) -> list[dict]:
    from dss_ml_at_scale_tpu_torch.data import batch_loader
    from dss_ml_at_scale_tpu_torch.data.transform import imagenet_transform_spec

    spec = imagenet_transform_spec(crop=32, backend="auto")
    out = []
    with batch_loader(str(data), batch_size=16, num_epochs=None, workers_count=1,
                      transform_spec=spec, shuffle_row_groups=False) as reader:
        it = iter(reader)
        for _ in range(3 * epochs):
            out.append({k: np.array(v) for k, v in next(it).items()})
    return out


def run_steps(batches: list[dict], mode: str) -> list[tuple[str, dict]]:
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

    set_mode(mode)
    model = build_classifier_model("tiny", num_classes=4, torch_padding=False, fused_bn=True,
                                   device="cuda", crop=32)
    task = ClassifierTask(model=model, learning_rate=0.01)
    out = []
    for b in batches:
        task.train_step({k: torch.from_numpy(v).cuda() for k, v in b.items()})
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out.append((digest(state), state))
    set_mode("default")
    return out


def steps_probe(data: Path) -> dict:
    batches = host_batches(data, epochs=2)
    report = {}
    for mode in ("default", "cudnn", "strict"):
        try:
            a, b = run_steps(batches, mode), run_steps(batches, mode)
        except RuntimeError as e:  # an op without a deterministic kernel
            report[mode] = {"error": str(e)[:300]}
            set_mode("default")
            continue
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x[0] != y[0]), None)
        entry = {"steps": len(a), "first_diverging_step": None if first is None else first + 1}
        if first is not None:
            sa, sb = a[first][1], b[first][1]
            diffs = {k: float((sa[k].float() - sb[k].float()).abs().max())
                     for k in sa if not torch.equal(sa[k], sb[k])}
            worst = max(diffs, key=diffs.get)
            entry.update(tensors_differing=len(diffs), worst_tensor=worst,
                         worst_max_abs=diffs[worst],
                         worst_shape=list(sa[worst].shape), worst_dtype=str(sa[worst].dtype))
        report[mode] = entry
    return report


def _cli(work: Path, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli",
                           *argv], cwd=work, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{argv[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc


def _train_twice(work: Path, tag: str, argv: list[str]) -> dict:
    from dss_ml_at_scale_tpu_torch.resilience.chaos import _tree_digest

    out = {}
    for run in ("a", "b"):
        ckpt = work / f"ckpt_{tag}_{run}"
        t0 = time.perf_counter()
        proc = _cli(work, "train", *argv, "--checkpoint-dir", str(ckpt),
                    "--tracking-root", str(work / "runs"), "--experiment", f"{tag}_{run}",
                    "--device", "cuda")
        step, dig = _tree_digest(ckpt)
        losses = [json.loads(line)["value"]
                  for f in sorted((work / "runs" / f"{tag}_{run}").glob("*/metrics.jsonl"))
                  for line in f.read_text().splitlines()
                  if json.loads(line)["name"] == "train_loss"]
        out[run] = {"step": step, "digest": dig, "wall_s": time.perf_counter() - t0,
                    "train_loss_per_log": losses, "summary": proc.stdout.strip()[-400:]}
    out["equal"] = out["a"]["digest"] == out["b"]["digest"]
    return out


def cli_probe(data: Path, work: Path) -> dict:
    return _train_twice(work, "chaos", [
        "--data", str(data), "--model", "tiny", "--num-classes", "4", "--crop", "32",
        "--batch-size", "16", "--epochs", "2", "--learning-rate", "0.01", "--workers", "1",
        "--no-shuffle"])


def photos_probe(work: Path) -> dict:
    _cli(work, "datagen", "photos", "--out", str(work / "raw"), "--n", "256", "--size", "96")
    _cli(work, "ingest", "--data-root", str(work / "raw"), "--out", str(work / "table"),
         "--rows-per-fragment", "64")
    return _train_twice(work, "photos", [
        "--data", str(work / "table"), "--model", "tiny", "--num-classes", "2", "--crop", "64",
        "--batch-size", "16", "--epochs", "8", "--learning-rate", "0.003", "--workers", "1"])


def resnet_probe() -> dict:
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn(212, 224, 224, 3, device="cuda", generator=gen),
             "label": torch.randint(0, 1000, (212,), device="cuda", generator=gen)}
    report = {}
    for mode in ("default", "cudnn"):
        runs = []
        for _ in range(2):
            set_mode(mode)
            model = build_classifier_model("resnet50", num_classes=1000, torch_padding=False,
                                           fused_bn="pallas", device="cuda")
            task = ClassifierTask(model=model, learning_rate=1e-5)
            digests = []
            for _ in range(3):
                task.train_step(batch)
                digests.append(digest(model.state_dict()))
            runs.append(digests)
            del task, model
            torch.cuda.empty_cache()
        first = next((i for i, (x, y) in enumerate(zip(*runs)) if x != y), None)
        report[mode] = {"steps": 3, "first_diverging_step": None if first is None else first + 1}
    set_mode("default")
    return report


def _timed(step, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _turns(step, trials: int = 3, n: int = 5) -> dict:
    times = {"off": [], "on": []}
    for mode in ("off", "on"):
        torch.backends.cudnn.deterministic = mode == "on"
        step()  # warm
    for mode in (["off", "on", "on", "off"] * trials)[:2 * trials]:
        torch.backends.cudnn.deterministic = mode == "on"
        times[mode].append(_timed(step, n))
    torch.backends.cudnn.deterministic = False
    return {"off_ms": times["off"], "on_ms": times["on"],
            "off_ms_median": statistics.median(times["off"]),
            "on_ms_median": statistics.median(times["on"]), "steps_per_trial": n}


def cost_probe() -> dict:
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, LMTask

    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_classifier_model("resnet50", num_classes=1000, torch_padding=False,
                                   fused_bn="pallas", device="cuda")
    task = ClassifierTask(model=model, learning_rate=1e-5)
    batch = {"image": torch.randn(212, 224, 224, 3, device="cuda", generator=gen),
             "label": torch.randint(0, 1000, (212,), device="cuda", generator=gen)}
    out = {"resnet50_pallas_fused": _turns(lambda: task.train_step(batch))}
    del task, model, batch
    torch.cuda.empty_cache()
    lm = LMTask(model=seeded_lm(0, device="cuda", vocab_size=8192, dim=1024, num_heads=8,
                                num_layers=4, max_seq=2048, attention="flash"),
                learning_rate=3e-4)
    tokens = {"tokens": torch.randint(0, 8192, (8, 2048), device="cuda", generator=gen)}
    out["lm"] = _turns(lambda: lm.train_step(tokens))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--skip-cli", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("replay_probe: no CUDA device", file=sys.stderr)
        return 2
    from dss_ml_at_scale_tpu_torch.datagen.images import write_image_delta

    # The strict setting's cuBLAS calls need a fixed workspace.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    work = Path(tempfile.mkdtemp(prefix="replay_probe_"))
    data = work / "data"
    write_image_delta(data, 48, classes=4, size=32, seed=0, mode="overwrite")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    report = {"card": smi.stdout.strip(), "torch": torch.__version__,
              "steps": steps_probe(data)}
    if not args.skip_cli:
        report["cli"] = cli_probe(data, work)
        report["photos"] = photos_probe(work)
    report["resnet50"] = resnet_probe()
    if not args.skip_cost:
        report["cost"] = cost_probe()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
