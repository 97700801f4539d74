"""Job-DAG pipeline runner (the reference's RUNME deployment).

Port of ``dss_ml_at_scale_tpu/config/pipeline.py``. The reference deploys
a Workflows job from a JSON spec: a task DAG with ``task_key`` /
``depends_on``, per-job ``timeout_seconds`` and ``max_concurrent_runs:
1``, and treats that job running green as its integration test. Here the
same spec (``pipelines/*.json``) is run task by task, in dependency order,
each task one fresh ``python -m dss_ml_at_scale_tpu_torch.config.cli``
process of its argv under its own timeout.

Spec format::

    {
      "name": "demand-forecasting",
      "timeout_seconds": 600,            # default per-task ceiling
      "tasks": [
        {"task_key": "gen",
         "argv": ["datagen", "demand", "--out", "{workdir}/demand"]},
        {"task_key": "forecast",
         "argv": ["forecast", "--data", "{workdir}/demand",
                  "--out", "{workdir}/forecast"],
         "depends_on": ["gen"],
         "timeout_seconds": 1200,
         "max_retries": 1}
      ]
    }

``{workdir}`` in any argv element is replaced by ``--workdir``. Tasks run
one at a time in topological order (spec order breaks ties); a failed or
timed-out task (after its ``max_retries`` extra attempts) skips its
dependents and fails the run. ``--task-device`` (the port's counterpart of
the JAX runner's ``--task-platform``) appends ``--device <d>`` to every
task whose command takes one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

_CLI = "dss_ml_at_scale_tpu_torch.config.cli"


def register_pipeline(sub) -> None:
    pl = sub.add_parser("pipeline", help="run a task-DAG of this CLI's subcommands")
    pl.add_argument("--spec", required=True, help="pipeline JSON file")
    pl.add_argument("--workdir", default=".", help="substituted for {workdir}")
    pl.add_argument("--dry-run", action="store_true", help="print the execution plan only")
    pl.add_argument(
        "--task-device", default=None, metavar="DEVICE",
        help="append --device DEVICE to every task whose command takes one (e.g. cpu "
        "where there is no card)")
    pl.set_defaults(fn=run_pipeline)


def _topo_order(tasks: list[dict]) -> list[dict]:
    by_key = {t["task_key"]: t for t in tasks}
    if len(by_key) != len(tasks):
        raise ValueError("duplicate task_key in pipeline spec")
    for t in tasks:
        for dep in t.get("depends_on", []):
            if dep not in by_key:
                raise ValueError(f"task {t['task_key']!r} depends on unknown task {dep!r}")
    order: list[dict] = []
    done: set[str] = set()
    remaining = list(tasks)  # spec order is the tiebreak (stable)
    while remaining:
        ready = [t for t in remaining if all(d in done for d in t.get("depends_on", []))]
        if not ready:
            cycle = ", ".join(t["task_key"] for t in remaining)
            raise ValueError(f"dependency cycle among tasks: {cycle}")
        for t in ready:
            order.append(t)
            done.add(t["task_key"])
        remaining = [t for t in remaining if t["task_key"] not in done]
    return order


def takes_device(argv: list[str]) -> bool:
    """Whether the CLI command of ``argv`` has a ``--device`` flag."""
    from .cli import build_parser

    parser = build_parser()
    for word in argv:
        subs = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
        if not subs or word not in subs[0].choices:
            break
        parser = subs[0].choices[word]
    return "--device" in parser._option_string_actions


def run_pipeline(args: argparse.Namespace) -> int:
    spec = json.loads(Path(args.spec).read_text())
    default_timeout = spec.get("timeout_seconds", 28800)
    order = _topo_order(spec.get("tasks", []))
    workdir = str(Path(args.workdir).absolute())

    def render(argv: list[str]) -> list[str]:
        out = [a.replace("{workdir}", workdir) for a in argv]
        if args.task_device and takes_device(out):
            out += ["--device", args.task_device]
        return out

    if args.dry_run:
        for t in order:
            deps = ",".join(t.get("depends_on", [])) or "-"
            print(f"{t['task_key']:<20} after [{deps}]  {' '.join(render(t['argv']))}")
        return 0

    from .cli import child_env

    env = child_env()
    print(f"pipeline {spec.get('name', Path(args.spec).stem)}: {len(order)} tasks", flush=True)
    failed: set[str] = set()
    skipped: set[str] = set()
    for t in order:
        key = t["task_key"]
        blocked = [d for d in t.get("depends_on", []) if d in failed or d in skipped]
        if blocked:
            print(f"[{key}] SKIPPED (failed dependency {', '.join(blocked)})", flush=True)
            skipped.add(key)
            continue
        argv = render(t["argv"])
        timeout = t.get("timeout_seconds", default_timeout)
        attempts = 1 + int(t.get("max_retries", 0))
        print(f"[{key}] {' '.join(argv)}", flush=True)
        for attempt in range(attempts):
            t0 = time.perf_counter()
            try:
                code = subprocess.run([sys.executable, "-m", _CLI, *argv],
                                      timeout=timeout, env=env).returncode
            except subprocess.TimeoutExpired:
                print(f"[{key}] TIMEOUT after {timeout}s (attempt {attempt + 1}/{attempts})",
                      flush=True)
                code = None
            dt = time.perf_counter() - t0
            if code == 0:
                print(f"[{key}] ok ({dt:.1f}s)", flush=True)
                break
            if code is not None:
                print(f"[{key}] FAILED (exit {code}, {dt:.1f}s, attempt "
                      f"{attempt + 1}/{attempts})", flush=True)
        else:
            failed.add(key)
    if failed:
        skipped_note = f" (skipped: {', '.join(sorted(skipped))})" if skipped else ""
        print(f"pipeline failed: {', '.join(sorted(failed))}{skipped_note}", flush=True)
        return 1
    print("pipeline ok", flush=True)
    return 0
