"""Run ``chip_smoke.py``'s bench phase on the card alone, and optionally the
slow ``group_fit_10k`` scenario or a new bench baseline.

    python3 scripts/bench_phase_probe.py                 # on the machine with the card
    python3 scripts/bench_phase_probe.py --10k           # + bench --scenarios group_fit_10k
    python3 scripts/bench_phase_probe.py --baseline      # + record chiprun_out/bench.json

Runs ``chip_smoke.bench_chain`` (``bench --list-scenarios``, ``bench
--scenarios <the nine tier1 ones>,feeder_e2e --json`` with each scenario in
a child on the card, ``bench profile feeder_e2e``) and checks it with
``chip_smoke.bench_phase``, which prints the summary line (seconds,
fingerprint, gated medians, verdicts, the MFU block, the merged profile's
counts, the kernels' launches). The run's JSON report goes to
``chiprun_out/bench_run.json``. ``--10k`` then runs ``group_fit_10k``
(``chiprun_out/bench_10k.json``). ``--baseline`` copies the committed bench
baseline to ``chiprun_out/bench.json`` and runs the same ten scenarios again
with ``--update-baseline`` on that copy; copy it over
``dss_ml_at_scale_tpu_torch/analysis/baselines/bench.json`` to commit the
card's entries. The card's name and power limit come first.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    side = {"bench": {"t0": t0, "thread": threading.Thread(target=lambda: None)}}
    side["bench"]["thread"].start()
    side["bench"]["result"] = cs.bench_chain(Path(tempfile.mkdtemp(prefix="bench_probe_")))
    (dest / "bench_run.json").write_text(side["bench"]["result"]["run"]["stdout"])
    cs.bench_phase(card, side)
    print(f"bench phase alone: {time.perf_counter() - t0:.1f} s", flush=True)
    if "--10k" in sys.argv:
        t1 = time.perf_counter()
        proc = subprocess.run(cs.CLI + ["bench", "--scenarios", "group_fit_10k", "--json"],
                              env=cs._port_env(), capture_output=True, text=True)
        (dest / "bench_10k.json").write_text(proc.stdout)
        print(f"group_fit_10k rc {proc.returncode}, {time.perf_counter() - t1:.1f} s",
              flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], flush=True)
            return 1
    if "--baseline" in sys.argv:
        committed = ROOT / "dss_ml_at_scale_tpu_torch/analysis/baselines/bench.json"
        if committed.exists():
            shutil.copy(committed, dest / "bench.json")
        proc = subprocess.run(
            cs.CLI + ["bench", "--scenarios", ",".join(cs.BENCH_SCENARIOS),
                      "--update-baseline", "--baseline", str(dest / "bench.json"),
                      "--reason", f"bench --scenarios <the nine tier1 ones>,feeder_e2e run "
                      f"alone on one {card}, each scenario in its own child"],
            env=cs._port_env(), capture_output=True, text=True)
        print(proc.stdout, proc.stderr[-3000:], flush=True)
        return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
