#!/usr/bin/env python3
"""The bf16 training phase of two checkouts' ``chip_smoke.py``, in turns.

Run on a card from the root of a checkout, with another checkout (say the
parent commit, unpacked by ``git archive`` into a directory that
``.gitignore`` lists) beside it:

    python3 scripts/compare_train_phase.py build/parent .

Runs ``chip_smoke.train_phase`` (``datagen images``, then ``train
--pallas-fused`` at ResNet-50's full width, 4 steps and 1 eval batch) of
the first, second, second and first checkout, each in a fresh process
that builds its own kernels, and prints one JSON line per run: the
steady step ms and images/s of steps 2-4, the data wait, K1-K3's launches
and the wall time; then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUNNER = r'''
import json, os, sys, tempfile
tree = sys.argv[1]
os.chdir(tree)
sys.path.insert(0, tree)
os.environ["DSST_TRACKING_ROOT"] = tempfile.mkdtemp()
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from dss_ml_at_scale_tpu_torch.ops import _build
_build.build_all()
run = chip_smoke.train_phase(torch)
keys = ("step_ms_steps_2_4", "images_per_sec_steps_2_4", "data_wait_ms_steps_2_4",
        "launches", "wall_s")
print("RESULT " + json.dumps({"tree": tree, **{k: run[k] for k in keys}}), flush=True)
'''


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    first, second = (os.path.abspath(p) for p in sys.argv[1:])
    rc = 0
    for tree in (first, second, second, first):
        out = subprocess.run([sys.executable, "-c", RUNNER, tree], capture_output=True,
                             text=True, timeout=1200)
        lines = [line for line in out.stdout.splitlines() if line.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(json.dumps({"tree": tree, "failed": out.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        print(lines[0].removeprefix("RESULT "), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
