#!/usr/bin/env python3
"""Train the port's LM through the ``lm`` entry and print its validation
curve: one JSON line per epoch (epoch, steps so far, train and val loss,
steady step ms), then the run's summary, with the card's name and power
limit.

Run from the root of a checkout on the machine with the card, e.g. the
full-width LM for 1,000 steps (10 epochs of 100, 2 val batches each):

    python3 scripts/lm_curve_torch.py --steps-per-epoch 100 --epochs 10 \\
        --out build/lm_curve.json

The model and data flags are ``chip_smoke.py``'s full-width LM (vocab 8192,
dim 1024, 8 heads, 4 layers, seq 2048, batch 8, Adam 3e-4, concentration
0.05); ``--steps-per-epoch``, ``--epochs`` and ``--lr-schedule`` pass
through to ``lm``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    from dss_ml_at_scale_tpu_torch.config import cli

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr-schedule", choices=["constant", "cosine"], default="constant")
    p.add_argument("--out", default=None, help="JSON file for the curve and the summary")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("lm_curve_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    flags = list(chip_smoke.LM_TRAIN)
    flags[flags.index("--steps-per-epoch") + 1] = str(args.steps_per_epoch)
    lm = cli.build_parser().parse_args(
        ["lm", *flags, "--epochs", str(args.epochs), "--lr-schedule", args.lr_schedule])
    summary = cli.run_lm(lm)
    curve = [{"epoch": h["epoch"], "steps": (h["epoch"] + 1) * args.steps_per_epoch,
              "train_loss": h["train_loss"], "val_loss": h["val_loss"],
              "steady_step_ms": h.get("steady_step_time_s", math.nan) * 1e3}
             for h in summary.pop("history")]
    for row in curve:
        print(json.dumps(row), flush=True)
    crossed = next((r["steps"] for r in curve if r["val_loss"] < math.log(8192)), None)
    result = {"card": card, "ln_vocab": math.log(8192), "first_epoch_end_below_ln_vocab": crossed,
              "curve": curve, "summary": summary}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "curve"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
