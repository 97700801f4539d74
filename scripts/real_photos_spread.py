#!/usr/bin/env python3
"""How much ``pipelines/real_photos_train.json``'s accuracy varies from run
to run: the spec, unchanged, N times side by side through the port's
``pipeline`` (each run in its own temporary workdir and run store).

Run from the root of a checkout (``--device cuda`` needs the card):

    python3 scripts/real_photos_spread.py [--runs 4] [--device cuda]

Prints for each run: the card line, ``train``'s summary (val_acc of the
last epoch, the best checkpoint), ``predict``'s ``accuracy_vs_label_index``
and the checkpoint step it scored, the val_acc and train_loss of every
epoch from the run store, and the pipeline's last line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("val_acc", "train_loss", "best_checkpoint", "accuracy_vs_label_index", "checkpoint_step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    procs = []
    for i in range(args.runs):
        work = Path(tempfile.mkdtemp(prefix=f"real_photos_{i}_"))
        env = dict(os.environ, PYTHONPATH=str(ROOT), DSST_TRACKING_ROOT=str(work / "runs"))
        procs.append((work, subprocess.Popen(
            [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "pipeline", "--spec",
             str(ROOT / "pipelines" / "real_photos_train.json"), "--workdir", str(work),
             "--task-device", args.device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=work)))
    rc = 0
    for work, proc in procs:
        out, _ = proc.communicate(timeout=1800)
        rc |= proc.returncode
        for line in out.splitlines():
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if "val_acc" in row or "accuracy_vs_label_index" in row:
                print(work.name, json.dumps({k: row[k] for k in KEYS if k in row}), flush=True)
        for path in glob.glob(str(work / "runs" / "*" / "*" / "metrics.jsonl")):
            rows = [json.loads(line) for line in open(path)]
            acc = [round(r["value"], 3) for r in rows if r["name"] == "val_acc"]
            if acc:
                loss = [round(r["value"], 3) for r in rows if r["name"] == "train_loss"]
                print(work.name, "val_acc by epoch", acc, "train_loss", loss, flush=True)
        print(work.name, "rc", proc.returncode, out.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
