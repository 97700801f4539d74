"""Run a piece of the port on several gloo processes on the CPU.

:func:`run_ranks` writes a script made of ``body`` after a prelude that
joins the process group (``file://<work>/rdzv``, so parallel test workers
never contend for a port), starts ``world`` fresh Python processes (torch
and the port only, no JAX), and returns what each rank saved: ``body``
fills the dict ``out``, which the epilogue writes with ``torch.save``.
Inputs go in as ``inputs.npz`` (``inputs`` in the script); ``args`` as
JSON (``args``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

_PRELUDE = r'''
import json, os, sys
import numpy as np
import torch
from dss_ml_at_scale_tpu_torch import runtime

work, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
args = json.loads(sys.argv[4])
runtime.initialize_distributed(f"file://{work}/rdzv", world, rank, backend="gloo", device="cpu")
inputs = dict(np.load(f"{work}/inputs.npz")) if os.path.exists(f"{work}/inputs.npz") else {}
out = {}
'''

_EPILOGUE = r'''
torch.save(out, f"{work}/out{rank}.pt")
runtime.shutdown_distributed()
'''


def run_ranks(work: Path, body: str, world: int, inputs: dict | None = None,
              args: dict | None = None, timeout: float = 240) -> list[dict]:
    """``body`` on ``world`` gloo ranks in ``work``; each rank's ``out``."""
    work.mkdir(parents=True, exist_ok=True)
    if inputs is not None:
        np.savez(work / "inputs.npz", **inputs)
    script = work / "rank.py"
    script.write_text(_PRELUDE + body + _EPILOGUE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"  # several ranks beside the other test workers
    env.pop("COORDINATOR_ADDRESS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(work), str(r), str(world), json.dumps(args or {})],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=timeout)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{errs[r][-4000:]}"
    return [torch.load(work / f"out{r}.pt", weights_only=False) for r in range(world)]
