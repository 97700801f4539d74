"""The analysis commands of the port's CLI: ``lint``, ``sanitize``, ``audit``.

Ports of the JAX commands (``config/commands.py``: ``register_lint``,
``register_audit``, ``register_sanitize``) with their flags (``lint
--changed`` included), exit codes
(0 clean, 1 findings or stale baseline entries, 2 usage error) and JSON
schema (its ``version`` field), pointed at the port's sources, threads and
programs (:mod:`..analysis`). The defaults of ``--baseline`` are the port's
own baselines under ``analysis/baselines/``. ``sanitize`` and ``audit``
also take ``--device`` (default ``cuda``; a missing card is an error, as in
every other command): the feeder workload places its batches there, and
the audit runs its entrypoints there.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def register_all(sub: argparse._SubParsersAction) -> None:
    _register_lint(sub)
    _register_audit(sub)
    _register_sanitize(sub)


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
