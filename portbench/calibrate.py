"""The readings the correctness check's limits are set from, in one process
per cell (the benchmark's own runs never run this).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds a,b,c] [--fault-seeds d,e,f] [--witness-seeds g,h,i] \
        [--leaves] [--out FILE]

For each seed of ``--seeds``: the port's three checked steps at the cell's
own size, through the same build, warm-up, reset and feed as a run (no
window between), against the float32 reference (the lower reading of each
number is the largest over them).
For each of ``--control-seeds``: the control, the reference at float8
(:mod:`portbench.reference._plain`), in the port's place. For each of
``--fault-seeds``: the port with each fault of :mod:`portbench.faults`
planted. For each of ``--witness-seeds``, the two witnesses of where a gap
comes from: the reference rounded to bfloat16 where the port rounds, and
the port itself computed in float32 (TF32 off). One JSON line per reading,
to standard output and ``--out``; ``--leaves`` adds each leaf's norms.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import check, faults, spec
from .run import build_program, program_readings, reference_readings, warm_up


def _free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def readings(cell: spec.Cell, seed: int, device, *, control: bool, fault_list=(),
             witness: bool = False, leaves: bool = False) -> list[dict]:
    import torch

    from .reference._plain import exact_float32
    from .traffic import make_pool

    pool = make_pool(cell.traffic, int(cell.config["num_classes"]), seed, device)
    ref = reference_readings(cell, seed, pool, device)
    _free(device)
    out = []

    def add(kind: str, got: check.Readings) -> None:
        found = check.numbers(got, ref)
        ok, _ = check.judge(found, cell.settings["check"])
        out.append({"workload": cell.name, "seed": seed, "kind": kind, "within_limits": ok,
                    **{k: v[0] for k, v in found.items()},
                    "at": {k: v[1] for k, v in found.items()}})
        if leaves:
            out[-1]["losses"] = [got.losses, ref.losses]
            out[-1]["leaves"] = {n: [ref.grad[n], got.grad[n], ref.change[n], got.change[n]]
                                 for n in ref.grad}
            out[-1]["stats_leaves"] = {n: [ref.stats[n], got.stats[n]] for n in ref.stats}

    for fault in (None, *fault_list):
        task = build_program(cell, seed, device)
        if fault is not None:
            faults.plant(task, fault)
        warm_up(task, pool)
        add(fault or "port", program_readings(task, cell, seed, pool, device))
        del task
        _free(device)
    if control:
        add("control_float8", reference_readings(cell, seed, pool, device, precision="float8"))
        _free(device)
    if witness:
        add("witness_reference_bf16",
            reference_readings(cell, seed, pool, device, precision="bfloat16"))
        _free(device)
        with exact_float32():
            task = build_program(cell, seed, device, dtype=torch.float32)
            warm_up(task, pool)
            add("witness_port_float32", program_readings(task, cell, seed, pool, device))
        del task
        _free(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True, action="append")
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--leaves", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    sink = open(args.out, "a", encoding="utf-8") if args.out else None
    try:
        for name in args.workload:
            cell = spec.load_cell(name)
            for seed in sorted(set(seeds) | control | fault_seeds | witness):
                t = time.perf_counter()
                rows = readings(cell, seed, args.device, control=seed in control,
                                fault_list=faults.FAULTS if seed in fault_seeds else (),
                                witness=seed in witness, leaves=args.leaves)
                if seed not in seeds:
                    rows = [r for r in rows if r["kind"] != "port"]
                for row in rows:
                    row["seconds"] = time.perf_counter() - t
                    line = json.dumps(row)
                    print(line, flush=True)
                    if sink:
                        sink.write(line + "\n")
                        sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
