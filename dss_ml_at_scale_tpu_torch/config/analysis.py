"""The analysis commands of the port's CLI: ``lint``, ``sanitize``,
``audit`` and ``bench``.

Ports of the JAX commands (``config/commands.py``: ``register_lint``,
``register_audit``, ``register_sanitize``, ``register_bench``) with their
flags (``lint --changed`` and ``bench profile`` included), exit codes
(0 clean, 1 findings, regressions or stale baseline entries, 2 usage
error) and JSON schema (its ``version`` field), pointed at the port's
sources, threads, programs and scenarios (:mod:`..analysis`,
:mod:`..bench`). The defaults of ``--baseline`` are the port's own
baselines under ``analysis/baselines/``. ``sanitize``, ``audit`` and
``bench`` also take ``--device`` (default ``cuda``; a missing card is an
error, as in every other command): the feeder workload places its batches
there, the audit runs its entrypoints there, and the bench's scenario
children inherit it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def register_all(sub: argparse._SubParsersAction) -> None:
    _register_lint(sub)
    _register_audit(sub)
    _register_sanitize(sub)
    _register_bench(sub)


def _split(csv: str | None) -> list[str] | None:
    return [x.strip() for x in csv.split(",") if x.strip()] if csv else None


def _add_baseline_args(parser, default: str) -> None:
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable output (schema documented in README 'Static "
        "and runtime analysis (port)'; stable via its 'version' field)")
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help=f"baseline of accepted findings (default: the port's {default})")
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current findings: existing entries "
        "keep their authored reason, new ones take --reason, stale ones are "
        "dropped")
    parser.add_argument(
        "--reason", default=None, metavar="TEXT",
        help="justification recorded for entries newly added by "
        "--update-baseline (mandatory when any exist)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")


# -- lint ---------------------------------------------------------------------


def _register_lint(sub) -> None:
    ln = sub.add_parser(
        "lint",
        help="static analysis of the port's sources: 12 rules (torch "
        "host syncs in hot paths, autograd Functions, kernel/graph caches, "
        "lock discipline, durable writes, the registries)")
    ln.add_argument("--rules", default=None, metavar="R1,R2",
                    help="comma-separated subset of rules (default: all)")
    _add_baseline_args(ln, "analysis/baselines/lint.json")
    ln.add_argument(
        "--changed", nargs="?", const="HEAD", default=None, metavar="REF",
        help="lint only the files changed vs the git ref (default HEAD: staged, "
        "unstaged and untracked), the fast pre-commit mode. The whole-package "
        "registry rules (telemetry-registry, fault-sites, ...) are skipped: "
        "they reconcile call sites against a registry across ALL files and "
        "would misfire on a subset")
    ln.set_defaults(fn=_cmd_lint)


def _cmd_lint(args: argparse.Namespace) -> int:
    from ..analysis import (
        DEFAULT_BASELINE,
        LintUsageError,
        checker_catalog,
        load_baseline,
        run_lint,
        write_baseline,
    )

    try:
        if args.list_rules:
            for name, desc in checker_catalog():
                print(f"{name:20s} {desc}")
            return 0
        baseline = Path(args.baseline) if args.baseline else DEFAULT_BASELINE
        paths = None
        if args.changed is not None:
            if args.update_baseline:
                raise LintUsageError("--changed cannot --update-baseline: a partial scan "
                                     "must never rewrite the whole-package baseline")
            paths = _changed_python_files(args.changed)
            if not paths and not args.json:
                # --json keeps its one parseable document even then: an
                # empty-scope run below.
                print(f"lint --changed {args.changed}: no changed Python files in scope; "
                      "nothing to lint")
                return 0
        res = run_lint(_split(args.rules), baseline_path=baseline, paths=paths)
        if args.update_baseline:
            # Entries of rules OUTSIDE this run's selection are kept: a
            # --rules subset update must not wipe what it never re-checked.
            old = load_baseline(baseline)
            selected = set(res.rules) | {"suppression"}
            preserved = {k: e for k, e in old.items()
                         if e.get("rule") not in selected}
            added = write_baseline(baseline, res.findings + res.baselined, old,
                                   args.reason, preserved=preserved)
            print(f"baseline {baseline}: {len(res.findings)} added ({added} "
                  f"with new reason), {len(res.baselined)} kept, "
                  f"{len(preserved)} preserved (other rules), "
                  f"{len(res.stale_baseline)} stale dropped")
            return 0
        print(res.render_json() if args.json else res.render_text())
        return res.exit_code
    except LintUsageError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2


def _changed_python_files(ref: str) -> list[Path]:
    """The ``.py`` files changed vs ``ref`` (``git diff``) and the untracked
    ones, within the lint's scan roots: the ``lint --changed`` scope.
    Deleted files drop out (there is nothing left to lint)."""
    import subprocess

    from ..analysis import LintUsageError
    from ..analysis.core import REPO_ROOT, default_roots

    def git(*argv: str) -> list[str]:
        out = subprocess.run(["git", *argv], cwd=REPO_ROOT, capture_output=True, text=True)
        if out.returncode != 0:
            raise LintUsageError(f"git {' '.join(argv)} failed: {out.stderr.strip()}")
        return [line for line in out.stdout.splitlines() if line.strip()]

    names = set(git("diff", "--name-only", ref))
    names.update(git("ls-files", "--others", "--exclude-standard"))
    # Scoped to the scan roots, derived rather than listed, so that
    # --changed and the full scan agree on what is lintable.
    prefixes = []
    for _, root in default_roots():
        try:
            prefixes.append(Path(root).resolve().relative_to(REPO_ROOT).as_posix() + "/")
        except ValueError:
            continue
    return [REPO_ROOT / name for name in sorted(names)
            if name.endswith(".py") and name.startswith(tuple(prefixes))
            and (REPO_ROOT / name).exists()]


# -- audit --------------------------------------------------------------------


def _register_audit(sub) -> None:
    au = sub.add_parser(
        "audit",
        help="entrypoint audit: run the registry of the port's real programs "
        "once each under a dispatch recorder on a fake 8-rank process group "
        "and check donation (in-place state), dtypes, collectives, host "
        "syncs and the per-device program baseline")
    au.add_argument("--entrypoints", default=None, metavar="E1,E2",
                    help="comma-separated subset of entrypoints (default: all)")
    au.add_argument("--rules", default=None, metavar="R1,R2",
                    help="comma-separated subset of audit rules (default: all)")
    _add_baseline_args(au, "analysis/baselines/audit.json")
    au.add_argument("--list-entrypoints", action="store_true",
                    help="print the entrypoint registry and exit")
    au.add_argument("--device", default="cuda",
                    help="where the entrypoints run (cuda, cuda:N, or cpu)")
    au.set_defaults(fn=_cmd_audit)


def _cmd_audit(args: argparse.Namespace) -> int:
    from ..analysis.audit import (
        DEFAULT_AUDIT_BASELINE,
        AuditUsageError,
        entrypoint_names,
        load_audit_baseline,
        rule_catalog,
        run_audit,
        write_audit_baseline,
    )
    from .cli import _no_card

    try:
        if args.list_rules:
            for name, desc in rule_catalog():
                print(f"{name:22s} {desc}")
            return 0
        if args.list_entrypoints:
            for name in entrypoint_names():
                print(name)
            return 0
        entrypoints, rules = _split(args.entrypoints), _split(args.rules)
        if args.update_baseline and (entrypoints or rules):
            # The program pins of this device are rebuilt from this run
            # alone: a subset would drop every pin it did not re-check.
            raise AuditUsageError(
                "--update-baseline needs the full audit: an --entrypoints/"
                "--rules subset must never rewrite the whole-registry baseline")
        if _no_card(args.device):
            return 2
        baseline = Path(args.baseline) if args.baseline else DEFAULT_AUDIT_BASELINE
        res = run_audit(entrypoints, rules=rules, baseline_path=baseline,
                        device=args.device)
        if args.update_baseline:
            old = load_audit_baseline(baseline)
            added = write_audit_baseline(baseline, res, old, args.reason)
            print(f"audit baseline {baseline}: {len(res.programs)} program(s) "
                  f"pinned on {res.device}, {added} finding(s) newly accepted, "
                  f"{len(res.stale_baseline)} stale dropped")
            return 0
        print(res.render_json() if args.json else res.render_text())
        return res.exit_code
    except AuditUsageError as e:
        print(f"audit: {e}", file=sys.stderr)
        return 2


# -- sanitize -----------------------------------------------------------------


def _register_sanitize(sub) -> None:
    sz = sub.add_parser(
        "sanitize",
        help="runtime thread sanitizer: run named workloads of the port with "
        "lock/thread instrumentation armed and report lock-order cycles, "
        "guarded-by violations, unjoined threads and leaked locks")
    sz.add_argument(
        "--workloads", default=None, metavar="W1,W2",
        help="comma-separated subset of workloads (default: all). Subset runs "
        "skip stale-baseline enforcement")
    _add_baseline_args(sz, "analysis/baselines/sanitize.json")
    sz.add_argument("--list-workloads", action="store_true",
                    help="print the workload catalog and exit")
    sz.add_argument("--device", default="cuda",
                    help="where the feeder workload places its batches "
                    "(cuda, cuda:N, or cpu)")
    sz.set_defaults(fn=_cmd_sanitize)


def _cmd_sanitize(args: argparse.Namespace) -> int:
    from ..analysis.sanitize import (
        DEFAULT_SANITIZE_BASELINE,
        RULES,
        SanitizeUsageError,
        build_result,
        run_workloads,
        sanitize_scope,
        workload_catalog,
        workload_names,
    )
    from ..analysis.sanitize.report import update_baseline
    from .cli import _no_card

    try:
        if args.list_workloads:
            for name, desc in workload_catalog():
                print(f"{name:12s} {desc}")
            return 0
        if args.list_rules:
            for name, desc in sorted(RULES.items()):
                print(f"{name:16s} {desc}")
            return 0
        names = _split(args.workloads) or workload_names()
        unknown = sorted(set(names) - set(workload_names()))
        if unknown:
            raise SanitizeUsageError(
                f"unknown workload(s) {', '.join(unknown)}; known: "
                f"{', '.join(workload_names())}")
        full_run = set(names) == set(workload_names())
        if args.update_baseline and not full_run:
            raise SanitizeUsageError(
                "--update-baseline needs the full workload set: a subset run "
                "must never rewrite the whole baseline")
        if _no_card(args.device):
            return 2
        baseline = Path(args.baseline) if args.baseline else DEFAULT_SANITIZE_BASELINE
        with sanitize_scope() as scope:
            run_workloads(names, device=args.device)
        res = build_result(scope, names, baseline_path=baseline, full_run=full_run)
        if args.update_baseline:
            added = update_baseline(baseline, res, args.reason)
            print(f"sanitize baseline {baseline}: {len(res.findings)} added "
                  f"({added} with new reason), {len(res.baselined)} kept, "
                  f"{len(res.stale_baseline)} stale dropped")
            return 0
        print(res.render_json() if args.json else res.render_text())
        return res.exit_code
    except SanitizeUsageError as e:
        print(f"sanitize: {e}", file=sys.stderr)
        return 2


# -- bench --------------------------------------------------------------------


def _register_bench(sub) -> None:
    bn = sub.add_parser(
        "bench",
        help="performance regression harness (fourth analysis tier): run "
        "registered scenarios in isolated children on --device with "
        "noise-aware repetitions and judge them against the "
        "environment-fingerprinted analysis/baselines/bench.json; `bench "
        "profile <scenario>` merges flight-recorder spans with a "
        "torch.profiler trace into one Perfetto timeline")
    bn.add_argument(
        "--scenarios", default=None, metavar="S1,S2",
        help="comma-separated subset of scenarios (default: every non-cuda "
        "scenario; see --list-scenarios)")
    bn.add_argument(
        "--tier", default=None, metavar="TIER",
        help="run one tier (tier1 | slow | cuda) instead of naming "
        "scenarios; tier1 is the CI smoke subset")
    bn.add_argument("--repetitions", type=int, default=None, metavar="N",
                    help="override every selected scenario's repetition count")
    bn.add_argument(
        "--in-process", action="store_true",
        help="measure inline instead of per-scenario child processes "
        "(debugging; loses crash isolation)")
    bn.add_argument(
        "--json", action="store_true",
        help="machine-readable output (schema documented in README "
        "'Benchmarking (port)') instead of text")
    bn.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="baseline file (default: the port's analysis/baselines/bench.json)")
    bn.add_argument(
        "--update-baseline", action="store_true",
        help="record this run's summaries for the current environment "
        "fingerprint: existing entries keep their authored reason, new ones "
        "take --reason, stale ones are dropped; other fingerprints' entries "
        "are preserved verbatim")
    bn.add_argument(
        "--require-baseline", action="store_true",
        help="strict gating: a gated metric with NO committed entry under "
        "this host's fingerprint is a failing finding instead of a silent "
        "'no-baseline' pass")
    bn.add_argument(
        "--reason", default=None, metavar="TEXT",
        help="justification recorded for entries newly added by "
        "--update-baseline (mandatory when any exist)")
    bn.add_argument("--list-scenarios", action="store_true",
                    help="print the scenario registry and exit")
    bn.add_argument("--device", default="cuda",
                    help="where the scenarios run (cuda, cuda:N, or cpu); the "
                    "children inherit it")
    bsub = bn.add_subparsers(dest="bench_cmd")
    pf = bsub.add_parser(
        "profile",
        help="run one scenario under the flight recorder AND torch.profiler "
        "(CPU and CUDA activities); merge both into ONE Perfetto file (host "
        "handoffs and kernels on the same timeline, flow arrows intact)")
    pf.add_argument("scenario", help="scenario to profile")
    pf.add_argument("--out", required=True, metavar="FILE",
                    help="merged Perfetto trace output path")
    # Own dest: a subparser option sharing dest="repetitions" would apply
    # ITS default over a value already parsed by the parent.
    pf.add_argument("--repetitions", type=int, default=None,
                    dest="profile_repetitions",
                    help="repetitions to trace (default: 1, or the parent "
                    "--repetitions when given before 'profile')")
    pf.add_argument(
        "--min-profiler-dur-us", type=float, default=5.0,
        help="drop torch.profiler complete events shorter than this (the "
        "dropped count is reported). 0 keeps everything")
    bn.set_defaults(fn=_cmd_bench)


def _cmd_bench(args: argparse.Namespace) -> int:
    from ..bench import (
        DEFAULT_BENCH_BASELINE,
        BenchUsageError,
        load_bench_baseline,
        resolve_selection,
        run_bench,
        scenario_catalog,
        write_bench_baseline,
    )
    from .cli import _no_card

    try:
        if args.list_scenarios and getattr(args, "bench_cmd", None) != "profile":
            for name, tier, desc in scenario_catalog():
                print(f"{name:20s} [{tier:5s}] {desc}")
            return 0
        scenarios = _split(args.scenarios)
        if getattr(args, "bench_cmd", None) != "profile":
            if scenarios and args.tier:
                raise BenchUsageError("--scenarios and --tier are exclusive selections")
            resolve_selection(scenarios, args.tier)  # a bad selection is exit 2 first
        if _no_card(args.device):
            return 2
        if getattr(args, "bench_cmd", None) == "profile":
            from ..bench.profile import profile_scenario

            reps = args.profile_repetitions
            if reps is None:
                reps = args.repetitions if args.repetitions else 1
            report = profile_scenario(
                args.scenario, args.out, repetitions=reps,
                min_profiler_dur_us=args.min_profiler_dur_us, device=args.device)
            print(f"merged perfetto trace: {report['spans']} span(s), "
                  f"{report['flows']} flow event(s), "
                  f"{report['profiler_events']} profiler event(s) "
                  f"({report['kernel_events']} CUDA kernel event(s); "
                  f"+{report['profiler_events_dropped']} dropped under "
                  f"{args.min_profiler_dur_us:g}us) -> {report['out']}")
            if report.get("mfu"):
                b = report["mfu"]
                util = b.get("utilization")
                print(f"achieved FLOPs/s ({b['entrypoint']}): "
                      f"{b['achieved_flops_per_sec']:.4g}"
                      + (f" ({util:.2%} of the {b['arithmetic']} peak)"
                         if util is not None else ""))
            print(json.dumps(report))
            return 0
        baseline = Path(args.baseline) if args.baseline else DEFAULT_BENCH_BASELINE
        res = run_bench(
            scenarios, tier=args.tier, repetitions=args.repetitions,
            baseline_path=baseline, isolation=not args.in_process,
            require_baseline=args.require_baseline, device=args.device)
        if args.update_baseline:
            old = load_bench_baseline(baseline)
            added = write_bench_baseline(baseline, res, old, args.reason)
            print(f"bench baseline {baseline}: {len(res.results)} "
                  f"scenario(s) recorded under {res.fingerprint_key} "
                  f"({added} with new reason)")
            return 0
        print(res.render_json() if args.json else res.render_text())
        return res.exit_code
    except BenchUsageError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
