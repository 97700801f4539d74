"""Run the port's three analysis tiers on the card alone, and re-pin the
audit's card programs.

    python3 scripts/analysis_tiers_probe.py            # on the machine with the card

Builds the kernels, runs ``lint --json``, ``sanitize --device cuda --json``
and ``audit --device cuda --json`` one after another through the port's CLI
(``chip_smoke.analysis_chain``), and prints each tier's rc, seconds, counts,
findings and the audit's programs (hash, pin, FLOPs, bytes, kernel
launches). Then it copies the committed audit baseline to
``chiprun_out/audit.json``, runs ``audit --device cuda --update-baseline``
on that copy (the ``cuda`` pins beside the committed ``cpu`` ones) and
audits against it once more: a second process must find every program
pinned. Copy ``chiprun_out/audit.json`` over
``dss_ml_at_scale_tpu_torch/analysis/baselines/audit.json`` to commit the
new pins. The card's name and power limit come first.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from dss_ml_at_scale_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card", file=sys.stderr)
        return 1
    print(cs.card_line(), f"torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    out = cs.analysis_chain(Path(tempfile.mkdtemp(prefix="analysis_tiers_")))
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "analysis_chain.json").write_text(json.dumps(out, indent=1))
    for name, tier in out.items():
        report = tier["report"]
        print(f"{name}: rc {tier['rc']}, {tier['seconds']} s, counts "
              f"{json.dumps(report.get('counts'))} {tier['stderr'][-1500:]}", flush=True)
        for f in report.get("findings", []):
            print(f"  finding {f.get('path')} [{f.get('rule')}] {f.get('message')}", flush=True)
        for f in report.get("suppressed", []):
            print(f"  suppressed {f.get('path')} [{f.get('rule')}]", flush=True)
        for prog, p in report.get("programs", {}).items():
            print(f"  {prog}: {json.dumps(p)}", flush=True)
    pins = dest / "audit.json"
    shutil.copy(ROOT / "dss_ml_at_scale_tpu_torch/analysis/baselines/audit.json", pins)
    cli = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "audit",
           "--device", "cuda", "--baseline", str(pins)]
    rc = 0
    for argv in (["--update-baseline"], []):
        t0 = time.perf_counter()
        proc = subprocess.run(cli + argv, capture_output=True, text=True)
        print(f"audit {' '.join(argv) or '(against the new pins)'}: rc {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s\n{proc.stdout[-3000:]}", flush=True)
        rc = rc or proc.returncode
    return rc or max(t["rc"] for t in out.values())


if __name__ == "__main__":
    sys.exit(main())
