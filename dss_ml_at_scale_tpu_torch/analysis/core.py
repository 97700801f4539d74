"""Checker framework: one parse per file, suppressions, baseline, renderers.

Port of ``dss_ml_at_scale_tpu/analysis/core.py``, pointed at the port's
own sources. The hazards a PyTorch/CUDA program can hide from its tests
are the JAX ones in another form: a host sync (``.item()``, ``.cpu()``)
on the feeder or step hot path, Python branching on tensor values inside
an autograd ``Function`` (a sync per call, and a branch a CUDA-graph
capture would bake), an unbounded cache of built kernels or compiled
graphs, and unlocked shared state across the runtime's thread families.
This module is the shared infrastructure the rules run on:

- **One AST parse per file** (:class:`FileContext`): every checker sees
  the same tree, source lines, suppression table, and hotpath marks.
- **Suppressions**: ``# dsst: ignore[rule] reason`` on the flagged line
  (or a comment-only line directly above it). The reason text is
  MANDATORY — a reasonless suppression is itself a finding (rule
  ``suppression``), so every silenced diagnostic carries its audit
  trail in the source.
- **Hotpath marks**: ``# dsst: hotpath`` on (or directly above) a
  ``def``/``for``/``while`` line marks its body as latency-critical for
  the host-sync checker.
- **Baseline** (:data:`DEFAULT_BASELINE`, committed in the port at
  ``analysis/baselines/lint.json``): pre-existing findings recorded as
  content-addressed keys, each with a mandatory one-line reason. A
  baselined finding doesn't fail the run; a baseline entry whose finding
  disappeared is *stale* and DOES fail the run (expire semantics), and
  keys hash the source line text, so editing a flagged line re-opens the
  finding instead of silently inheriting its exemption.
- **Renderers + exit codes**: text and JSON (schema ``version`` 1, as
  the JAX package's); exit 0 clean, 1 findings/stale entries, 2 usage
  error.

The scan root is the port package only: the shared ``scripts/`` folder
holds both packages' scripts, and its JAX half is not the port's to
judge. Checkers subclass :class:`Checker` and register with
:func:`register_checker`; the plugins live in :mod:`.checkers`.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Callable, Iterable, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
PACKAGE_DIR = Path(__file__).resolve().parents[1]
BASELINE_DIR = PACKAGE_DIR / "analysis" / "baselines"
DEFAULT_BASELINE = BASELINE_DIR / "lint.json"

JSON_SCHEMA_VERSION = 1

# ``# dsst: ignore[rule-a,rule-b] reason text``
_IGNORE_RE = re.compile(
    r"#\s*dsst:\s*ignore\[([A-Za-z0-9_,\- ]+)\]\s*(.*?)\s*$"
)
_HOTPATH_RE = re.compile(r"#\s*dsst:\s*hotpath\b")


class LintUsageError(Exception):
    """Bad invocation (unknown rule, missing --reason, ...): exit 2."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``key`` is the stable baseline identity."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str
    key: str = ""

    def text(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "key": self.key,
        }


@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: tuple[str, ...]
    reason: str
    line: int  # the comment's own line


class FileContext:
    """Everything checkers need about one file, parsed exactly once."""

    def __init__(self, path: Path, rel: str, root: str, source: str):
        self.path = path
        self.rel = rel          # repo-relative posix path
        self.root = root        # the scan root's label ("package")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        # line -> Suppression covering that line
        self.suppressions: dict[int, Suppression] = {}
        self.reasonless: list[int] = []  # ignore-comments missing a reason
        self.hotpath_marks: set[int] = set()
        self._nodes: list | None = None
        self._parents: dict | None = None
        self._enclosing: dict | None = None
        self._scan_comments()

    @property
    def nodes(self) -> list:
        """Every node of the tree in ``ast.walk`` order, listed once per
        file however many checkers walk it."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    @property
    def parents(self) -> dict:
        """Child→parent map over the tree, built once per file no matter
        how many checkers ask (the 'one shared parse' promise extends to
        the derived maps)."""
        if self._parents is None:
            from .astutil import parent_map

            self._parents = parent_map(self.tree)
        return self._parents

    @property
    def enclosing_fns(self) -> dict:
        """node → innermost enclosing function name, cached like
        :attr:`parents`."""
        if self._enclosing is None:
            from .astutil import enclosing_function_names

            self._enclosing = enclosing_function_names(self.tree)
        return self._enclosing

    def _scan_comments(self) -> None:
        # Real COMMENT tokens only — a docstring line that *documents*
        # the directive syntax must not mint a phantom suppression or
        # hotpath mark (regexing raw source lines did exactly that).
        # The file already ast.parse()d, so tokenize cannot fail; the
        # narrow guard covers exotic encodings defensively.
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(self.source).readline)
            )
        except (tokenize.TokenError, SyntaxError, IndentationError):
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            i, col = tok.start
            text = tok.string
            if _HOTPATH_RE.search(text):
                self.hotpath_marks.add(i)
            m = _IGNORE_RE.search(text)
            if m is None:
                continue
            rules = tuple(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            reason = m.group(2).strip()
            if not reason:
                self.reasonless.append(i)
                continue
            self._add_suppression(i, rules, reason)
            # A comment-only line suppresses the statement it annotates:
            # the next non-blank, non-comment line (so stacked directive
            # comments all reach the code line below them). A trailing
            # comment covers its own line only.
            if not self.lines[i - 1][:col].strip():
                target = self._next_code_line(i)
                if target is not None:
                    self._add_suppression(target, rules, reason)

    def _next_code_line(self, after: int) -> int | None:
        for j in range(after + 1, len(self.lines) + 1):
            stripped = self.lines[j - 1].strip()
            if stripped and not stripped.startswith("#"):
                return j
        return None

    def _add_suppression(self, line: int, rules: tuple[str, ...],
                         reason: str) -> None:
        # Merge with any suppression already covering the line — stacked
        # comment-only directives must accumulate, not clobber.
        prev = self.suppressions.get(line)
        if prev is not None:
            rules = tuple(dict.fromkeys(prev.rules + rules))
            reason = f"{prev.reason}; {reason}" if (
                reason not in prev.reason
            ) else prev.reason
        self.suppressions[line] = Suppression(rules, reason, line)

    def suppressed(self, rule: str, line: int) -> bool:
        sup = self.suppressions.get(line)
        return sup is not None and rule in sup.rules

    def is_hotpath_marked(self, node: ast.AST) -> bool:
        """True when ``node``'s line (or the line above) carries the mark."""
        lineno = getattr(node, "lineno", None)
        if lineno is None:
            return False
        return (
            lineno in self.hotpath_marks
            or (lineno - 1) in self.hotpath_marks
        )


class Checker:
    """Base checker: per-file pass + optional cross-file finalize.

    Subclasses set ``name``/``description``, optionally narrow
    ``roots`` (which scan roots they see), and implement
    :meth:`check_file`; checkers that need whole-package state (registry
    reconciliation) accumulate in ``check_file`` and emit from
    :meth:`finalize`.
    """

    name: str = ""
    description: str = ""
    roots: tuple[str, ...] = ("package",)

    def wants(self, ctx: FileContext) -> bool:
        return ctx.root in self.roots

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finalize(self) -> Iterable[Finding]:
        return ()

    def finding(self, ctx: FileContext | None, line: int,
                message: str) -> Finding:
        return Finding(
            rule=self.name,
            path=ctx.rel if ctx is not None else "<registry>",
            line=line,
            message=message,
        )


_CHECKERS: dict[str, type[Checker]] = {}


def register_checker(cls: type[Checker]) -> type[Checker]:
    if not cls.name:
        raise ValueError(f"checker {cls.__name__} has no name")
    if cls.name in _CHECKERS:
        raise ValueError(f"duplicate checker name {cls.name!r}")
    _CHECKERS[cls.name] = cls
    return cls


def checker_names() -> list[str]:
    _load_plugins()
    return sorted(_CHECKERS)


def checker_catalog() -> list[tuple[str, str]]:
    """(name, description) pairs for --list-rules and the README."""
    _load_plugins()
    return [(n, _CHECKERS[n].description) for n in sorted(_CHECKERS)]


def _load_plugins() -> None:
    # Import for side effect: plugin modules register their classes.
    from . import checkers  # noqa: F401


# -- keys and baseline --------------------------------------------------------


def _finding_keys(findings: list[Finding],
                  line_text: Callable[[str, int], str]) -> list[Finding]:
    """Assign content-addressed keys: hash of (rule, path, stripped
    source line text, occurrence index among identical triples). Line
    numbers deliberately stay OUT of the key so unrelated edits above a
    finding don't churn the baseline — but editing the flagged line
    itself re-opens the finding."""
    seen: dict[tuple[str, str, str], int] = {}
    out = []
    for f in findings:
        # Registry-level findings (no source line) fall back to the
        # message — they have no line text to address.
        text = line_text(f.path, f.line) or f.message
        ident = (f.rule, f.path, text)
        n = seen.get(ident, 0)
        seen[ident] = n + 1
        digest = hashlib.blake2s(
            f"{f.rule}\0{f.path}\0{text}\0{n}".encode(), digest_size=8
        ).hexdigest()
        out.append(dataclasses.replace(f, key=f"{f.rule}:{digest}"))
    return out


def load_baseline(path: Path) -> dict[str, dict]:
    if not path.exists():
        return {}
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        # A merge-conflicted or hand-mangled baseline is a usage error
        # (exit 2, message), not a traceback.
        raise LintUsageError(f"baseline {path} is not valid JSON: {e}")
    if not isinstance(data, dict):
        raise LintUsageError(f"baseline {path}: top level must be an object")
    entries = data.get("entries", {})
    if not isinstance(entries, dict):
        raise LintUsageError(f"baseline {path}: 'entries' must be an object")
    return entries


def write_baseline(path: Path, findings: list[Finding],
                   old_entries: dict[str, dict],
                   new_reason: str | None,
                   preserved: dict[str, dict] | None = None) -> int:
    """Rewrite the baseline to exactly the current findings.

    Keys already baselined keep their authored reason; new keys take
    ``new_reason`` (required when any exist — a baseline entry without a
    justification defeats the point of having one). ``preserved``
    entries are carried over verbatim — the caller passes the entries
    belonging to rules OUTSIDE the current run's selection, so a
    ``--rules subset --update-baseline`` cannot wipe what it never
    re-checked."""
    entries: dict[str, dict] = dict(preserved or {})
    added = 0
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        old = old_entries.get(f.key)
        if old is not None and str(old.get("reason", "")).strip():
            reason = old["reason"]
        else:
            if not (new_reason and new_reason.strip()):
                raise LintUsageError(
                    f"new finding {f.key} ({f.path}:{f.line}) needs "
                    "--reason TEXT to enter the baseline"
                )
            reason = new_reason.strip()
            added += 1
        entries[f.key] = {
            "reason": reason,
            "rule": f.rule,
            "path": f.path,
            "line": f.line,
            "message": f.message,
        }
    payload = {
        "_comment": (
            "analysis baseline of the port: pre-existing findings, each with a "
            "mandatory one-line reason. Regenerate with "
            "`lint|sanitize --update-baseline --reason '...'`; entries whose "
            "finding disappeared go stale and FAIL the lint until removed "
            "(rerun --update-baseline). Keys hash the flagged source "
            "line, so editing that line re-opens its finding."
        ),
        "version": JSON_SCHEMA_VERSION,
        "entries": entries,
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")
    return added


# -- the runner ---------------------------------------------------------------


@dataclasses.dataclass
class LintResult:
    rules: list[str]
    findings: list[Finding]          # active (unbaselined, unsuppressed)
    baselined: list[Finding]
    suppressed: list[Finding]
    stale_baseline: list[dict]       # entries with no matching finding

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_baseline

    @property
    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def render_text(self) -> str:
        lines = [f.text() for f in self.findings]
        for entry in self.stale_baseline:
            lines.append(
                f"{entry.get('path', '?')}: [baseline] stale entry "
                f"{entry['key']} ({entry.get('rule', '?')}) — the finding "
                "is gone; remove it (lint --update-baseline)"
            )
        lines.append(
            f"{len(self.findings)} finding(s), "
            f"{len(self.baselined)} baselined, "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.stale_baseline)} stale baseline entr(y/ies) "
            f"[rules: {', '.join(self.rules)}]"
        )
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "version": JSON_SCHEMA_VERSION,
            "rules": self.rules,
            "counts": {
                "active": len(self.findings),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "stale_baseline": len(self.stale_baseline),
            },
            "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "baselined": [f.to_json() for f in self.baselined],
            "stale_baseline": self.stale_baseline,
        }, indent=2)


def iter_contexts(
    roots: Sequence[tuple[str, Path]],
) -> Iterable[FileContext]:
    for label, root in roots:
        for path in sorted(root.rglob("*.py")):
            try:
                rel = path.relative_to(REPO_ROOT).as_posix()
            except ValueError:
                # Out-of-repo trees (fixtures, shim callers passing a
                # foreign package): ROOT-relative, so path-based rule
                # exemptions (no-print's config/) still resolve and
                # same-named files in different dirs stay distinct.
                rel = path.relative_to(root).as_posix()
            yield FileContext(
                path, rel, label, path.read_text(encoding="utf-8")
            )


def default_roots() -> list[tuple[str, Path]]:
    return [("package", PACKAGE_DIR)]


def run_lint(
    rules: Sequence[str] | None = None,
    *,
    roots: Sequence[tuple[str, Path]] | None = None,
    baseline_path: Path | None = None,
    checkers: Sequence[Checker] | None = None,
) -> LintResult:
    """Run the suite; the single entry point the CLI and the tests share.

    ``rules`` selects a subset (default: all registered). ``checkers``
    overrides instantiation entirely (tests inject checkers with fake
    registries). Baseline staleness is judged only against the selected
    rules —
    ``--rules no-print`` must not declare every other rule's entries
    stale.
    """
    _load_plugins()
    if checkers is None:
        names = list(rules) if rules else sorted(_CHECKERS)
        unknown = [n for n in names if n not in _CHECKERS]
        if unknown:
            raise LintUsageError(
                f"unknown rule(s) {', '.join(sorted(unknown))}; "
                f"known: {', '.join(sorted(_CHECKERS))}"
            )
        checkers = [_CHECKERS[n]() for n in names]
    selected = [c.name for c in checkers]

    scan_roots = list(roots) if roots is not None else default_roots()
    # Repo-relative prefixes of the scanned roots: a baseline entry
    # whose path lies under one of these but matched no scanned file
    # belongs to a DELETED file — its finding is gone, so the entry is
    # stale (otherwise dead entries linger, and a re-added file with the
    # same flagged line would silently inherit the exemption).
    root_prefixes: list[str] = []
    for _, root in scan_roots:
        try:
            root_prefixes.append(
                Path(root).resolve().relative_to(REPO_ROOT).as_posix() + "/"
            )
        except ValueError:
            pass  # foreign tree (fixtures): can't attribute entries
    contexts: dict[str, FileContext] = {}
    raw: list[Finding] = []
    suppressed: list[Finding] = []
    for ctx in iter_contexts(scan_roots):
        contexts[ctx.rel] = ctx
        # Reasonless suppression comments are findings of the framework
        # itself — rule "suppression", not suppressible (a suppression
        # cannot vouch for another broken suppression on its own line).
        for line in ctx.reasonless:
            raw.append(Finding(
                "suppression", ctx.rel, line,
                "# dsst: ignore[...] without a reason — append one "
                "(why is this diagnostic wrong or acceptable here?)",
            ))
        for checker in checkers:
            if not checker.wants(ctx):
                continue
            for f in checker.check_file(ctx):
                if ctx.suppressed(f.rule, f.line):
                    suppressed.append(f)
                else:
                    raw.append(f)
    for checker in checkers:
        raw.extend(checker.finalize())

    def line_text(path: str, line: int) -> str:
        ctx = contexts.get(path)
        if ctx is None or not (1 <= line <= len(ctx.lines)):
            return ""
        return ctx.lines[line - 1].strip()

    keyed = _finding_keys(raw, line_text)

    bl_path = DEFAULT_BASELINE if baseline_path is None else baseline_path
    entries = load_baseline(bl_path)
    active: list[Finding] = []
    baselined: list[Finding] = []
    matched: set[str] = set()
    rule_set = set(selected) | {"suppression"}
    for f in keyed:
        entry = entries.get(f.key)
        if entry is not None and str(entry.get("reason", "")).strip():
            baselined.append(f)
            matched.add(f.key)
        else:
            active.append(f)
    def _stale_eligible(entry: dict) -> bool:
        # Only paths this run scanned (or WOULD have scanned, had the
        # file still existed — the root-prefix check) can prove an
        # entry stale; registry-level findings (path "<registry>")
        # belong to the finalize pass, which DID run for every
        # selected rule.
        p = str(entry.get("path", ""))
        return (
            p in contexts
            or p == "<registry>"
            or any(p.startswith(prefix) for prefix in root_prefixes)
        )

    stale = [
        {"key": k, **entry}
        for k, entry in sorted(entries.items())
        if k not in matched and entry.get("rule") in rule_set
        and _stale_eligible(entry)
    ]
    active.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(
        rules=selected,
        findings=active,
        baselined=baselined,
        suppressed=suppressed,
        stale_baseline=stale,
    )


def lint_text(
    checker: Checker,
    source: str,
    *,
    filename: str = "fixture.py",
    root: str = "package",
) -> list[Finding]:
    """Run ONE checker over one source string — the fixture-test entry
    point. Suppressions apply; no baseline."""
    ctx = FileContext(Path(filename), filename, root, source)
    out: list[Finding] = []
    for f in checker.check_file(ctx):
        if not ctx.suppressed(f.rule, f.line):
            out.append(f)
    out.extend(checker.finalize())
    return out
