"""Isolated scenario child: ``python -m dss_ml_at_scale_tpu_torch.bench``.

One scenario per process: a hung card, an OOM, or a watchdog kill takes
down this child, never the harness. Protocol (JAX's): exactly one JSON line
on stdout (``{"scenario", "samples", "extra", "completed", "launches"}`` on
success, ``{"scenario", "failed": true, "error"}`` on failure),
per-repetition durable partials at ``--partial`` for parent-side salvage,
exit 0 either way: the parent judges the JSON, not the return code.
``--device`` (default ``cuda``) is where the scenario runs; the parent
passes its own.

The environment fingerprint is deliberately NOT computed here: the parent
fingerprints once, and child-side samples are keyed by the parent's view
of the host they both run on.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from .core import get_scenario, measure_scenario


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dss_ml_at_scale_tpu_torch.bench")
    ap.add_argument("--scenario", required=True)
    ap.add_argument("--partial", default=None)
    ap.add_argument("--repetitions", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        sc = get_scenario(args.scenario)
        record = measure_scenario(
            sc, repetitions=args.repetitions, partial_path=args.partial,
            env={}, device=args.device,
        )
    except BaseException:  # noqa: BLE001 - the JSON line IS the report
        record = {
            "scenario": args.scenario,
            "failed": True,
            "error": traceback.format_exc(limit=8),
        }
    # dsst: ignore[no-print] the one-JSON-line child protocol: stdout is the parent's only channel
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
