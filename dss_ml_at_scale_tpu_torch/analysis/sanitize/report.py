"""Sanitizer findings: cycle detection, suppressions, baseline, render.

Port of ``dss_ml_at_scale_tpu/analysis/sanitize/report.py``.

The runtime layer (:mod:`.runtime`) accumulates raw evidence — an
acquisition-order edge graph, guarded-by violations with stacks,
unjoined threads and leaked locks at scope exit. This module turns that
into the same finding/suppression/baseline shape the static tiers
speak:

- **Rules**: ``lock-order`` (a cycle in the acquisition-order graph —
  a potential deadlock, reported with the acquisition stacks of every
  edge even when no deadlock fired), ``guarded-by`` (a declared-guarded
  attribute touched off its lock while another live thread is/was
  inside that lock), ``unjoined-thread`` and ``leaked-lock`` (scope
  hygiene).
- **Suppressions**: the normal ``# dsst: ignore[rule] reason`` comment
  on the offending source line (or a comment-only line directly above
  it), resolved from the finding's anchor frame at report time — one
  comment idiom serves lint and sanitizer, and the reason stays
  MANDATORY (a reasonless comment does not suppress).
- **Baseline** (the port's ``analysis/baselines/sanitize.json``):
  content-addressed keys
  hashing the rule + anchor path + stripped source line text (never
  line numbers), with the lint baseline's expire semantics — enforced
  only for full-workload runs, because a subset run cannot prove a
  finding gone.
- **Renderers**: text with indented stacks; JSON schema v1, the JAX
  package's (documented in the README's "Static and runtime analysis
  (port)" section).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import linecache
import re
from pathlib import Path

from ..core import (
    JSON_SCHEMA_VERSION,
    BASELINE_DIR,
    REPO_ROOT,
    _IGNORE_RE,
    LintUsageError,
    load_baseline,
    write_baseline,
)

DEFAULT_SANITIZE_BASELINE = BASELINE_DIR / "sanitize.json"

RULES: dict[str, str] = {
    "lock-order": (
        "cycle in the runtime lock-acquisition-order graph — a "
        "potential deadlock, reported with both acquisition stacks "
        "even when no deadlock fired"
    ),
    "guarded-by": (
        "a _guarded_by_lock attribute read/written off the declaring "
        "lock while another live thread is (or has been) inside it"
    ),
    "unjoined-thread": (
        "a thread created inside the sanitize scope still alive at "
        "scope exit — join it (or close its owner) on every path"
    ),
    "leaked-lock": (
        "an instrumented lock still held at scope exit — a with-block "
        "was bypassed or an acquire has no matching release"
    ),
}


class SanitizeUsageError(LintUsageError):
    """Bad invocation (unknown workload/rule, missing --reason): exit 2."""


@dataclasses.dataclass(frozen=True)
class SanitizeFinding:
    """One runtime diagnostic. Shape-compatible with the lint
    ``Finding`` (rule/path/line/message/key) so the shared baseline
    reader/writer work unchanged; ``stacks`` carries the runtime
    evidence — a list of (label, [frame strings]) pairs."""

    rule: str
    path: str   # repo-relative posix path of the anchor site
    line: int
    message: str
    stacks: tuple = ()
    key: str = ""
    # Raw (filename, lineno) pairs of the frames a `# dsst: ignore`
    # comment may sit on — structured, so suppression lookup never
    # re-parses the human-rendered stack strings. Not serialized.
    anchors: tuple = ()

    def text(self) -> str:
        out = [f"{self.path}:{self.line}: [{self.rule}] {self.message}"]
        for label, frames in self.stacks:
            out.append(f"    {label}:")
            out.extend(f"        {f}" for f in frames)
        return "\n".join(out)

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "key": self.key,
            "stacks": [
                {"label": label, "frames": list(frames)}
                for label, frames in self.stacks
            ],
        }


# -- frame / source helpers ---------------------------------------------------


def _rel(filename: str) -> str:
    try:
        return Path(filename).resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return Path(filename).name


def _line_text(filename: str, lineno: int) -> str:
    return linecache.getline(filename, lineno).strip()


def _fmt_frame(frame) -> str:
    src = _line_text(frame.filename, frame.lineno)
    loc = f"{_rel(frame.filename)}:{frame.lineno} in {frame.funcname}"
    return f"{loc} — {src}" if src else loc


def _fmt_stack(frames, limit: int = 8) -> list[str]:
    return [_fmt_frame(f) for f in frames[:limit]]


_COMMENT_ONLY = re.compile(r"^\s*#")


def _suppression_reason(filename: str, lineno: int,
                        rule: str) -> str | None:
    """The mandatory reason of a ``# dsst: ignore[rule]`` comment on
    the given source line, or on comment-only lines directly above it
    (mirroring the lint FileContext semantics). None when unsuppressed
    or reasonless (a reasonless comment must not silence anything)."""
    candidates = [linecache.getline(filename, lineno)]
    j = lineno - 1
    while j > 0:
        text = linecache.getline(filename, j)
        if not _COMMENT_ONLY.match(text or ""):
            break
        candidates.append(text)
        j -= 1
    for text in candidates:
        m = _IGNORE_RE.search(text or "")
        if m is None:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = m.group(2).strip()
        if rule in rules and reason:
            return reason
    return None


def _finding_key(rule: str, *parts: str) -> str:
    digest = hashlib.blake2s(
        "\0".join((rule,) + parts).encode(), digest_size=8
    ).hexdigest()
    return f"{rule}:{digest}"


def _site_identity(site) -> str:
    """Content address of one site: relpath + stripped line text, so
    unrelated edits don't churn the baseline but editing the flagged
    line re-opens its finding (the lint key discipline)."""
    return f"{_rel(site.filename)}|{_line_text(site.filename, site.lineno)}"


# -- cycle detection ----------------------------------------------------------


def _find_cycles(edges: dict[tuple, dict]) -> list[list]:
    """Elementary cycles of the site graph, shortest first, each
    reported once (canonicalized by rotation). Sites are the runtime
    Frame keys the edge dict uses."""
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    cycles: list[list] = []
    seen: set[tuple] = set()

    def canon(path: list) -> tuple:
        i = min(range(len(path)), key=lambda k: path[k])
        return tuple(path[i:] + path[:i])

    def dfs(start, node, path: list, visited: set) -> None:
        for nxt in sorted(graph.get(node, ()), key=str):
            if nxt == start and len(path) >= 2:
                c = canon(path)
                if c not in seen:
                    seen.add(c)
                    cycles.append(list(path))
            elif nxt not in visited and len(path) < 6:
                visited.add(nxt)
                dfs(start, nxt, path + [nxt], visited)
                visited.discard(nxt)

    for start in sorted(graph, key=str):
        dfs(start, start, [start], {start})
    cycles.sort(key=len)
    return cycles


# -- building findings --------------------------------------------------------


def findings_from_scope(scope) -> tuple[list[SanitizeFinding],
                                        list[SanitizeFinding]]:
    """(active, suppressed) findings from one finished scope."""
    raw: list[SanitizeFinding] = []

    edges = scope.edges()
    seq_mark = getattr(scope, "edge_seq_mark", 0)
    for cycle in _find_cycles(edges):
        n = len(cycle)
        stacks = []
        anchor_sites = []
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % n]
            edge = edges.get((a, b))
            if edge is None:
                continue
            anchor_sites.append((a, b, edge))
        # A scope owns a cycle only if at least one of its edges was
        # first observed on this scope's watch — the whole graph still
        # decides what IS a cycle (half an inversion seen earlier
        # completes here), but a nested scope must not re-report
        # history that predates it.
        if not any(e.get("seq", 0) > seq_mark for _, _, e in anchor_sites):
            continue
        anchors: tuple = ()
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % n]
            edge = edges.get((a, b))
            if edge is None:
                continue
            label = (
                f"thread {edge['thread']!r} acquired "
                f"{_site_identity(a).split('|')[0]} then "
                f"{_site_identity(b).split('|')[0]} "
                f"(x{edge['count']})"
            )
            stacks.append((label + " — outer lock held at",
                           tuple(_fmt_stack(edge["held_stack"]))))
            stacks.append((label + " — inner lock acquired at",
                           tuple(_fmt_stack(edge["acquire_stack"]))))
            anchors += _anchor_frames(
                edge["held_stack"], edge["acquire_stack"]
            )
        if not anchor_sites:
            continue
        sites = sorted({s for pair in ((a, b) for a, b, _ in anchor_sites)
                        for s in pair}, key=_site_identity)
        first = sites[0]
        names = " <-> ".join(
            f"{_rel(s.filename)}:{s.lineno}" for s in sites
        )
        key = _finding_key(
            "lock-order", *sorted(_site_identity(s) for s in sites)
        )
        raw.append(SanitizeFinding(
            rule="lock-order",
            path=_rel(first.filename),
            line=first.lineno,
            message=(
                f"lock-order cycle across {len(sites)} lock creation "
                f"site(s): {names} — threads acquire these locks in "
                "conflicting orders (potential deadlock); pick one "
                "global order"
            ),
            stacks=tuple(stacks),
            key=key,
            anchors=anchors,
        ))

    for rec in scope.guarded_findings():
        site = rec["site"]
        key = _finding_key(
            "guarded-by", rec["cls"], rec["attr"], _site_identity(site)
        )
        stacks = [(
            f"offending {rec['mode']} on thread {rec['thread']!r}",
            tuple(_fmt_stack(rec["stack"])),
        )]
        if rec.get("holder_stack"):
            stacks.append((
                f"lock last acquired by thread {rec['holder']!r} at",
                tuple(_fmt_stack(rec["holder_stack"])),
            ))
        raw.append(SanitizeFinding(
            rule="guarded-by",
            path=_rel(site.filename),
            line=site.lineno,
            message=(
                f"{rec['cls']}.{rec['attr']} is declared "
                f"_guarded_by_lock but {rec['mode']} off the lock "
                f"(declared at {_rel(rec['lock_site'].filename)}:"
                f"{rec['lock_site'].lineno}) while thread "
                f"{rec['holder']!r} shares it — hold the lock"
            ),
            stacks=tuple(stacks),
            key=key,
            anchors=_anchor_frames(
                rec["stack"], rec.get("holder_stack")
            ),
        ))

    for rec in scope.unjoined:
        site = rec["site"]
        raw.append(SanitizeFinding(
            rule="unjoined-thread",
            path=_rel(site.filename),
            line=site.lineno,
            message=(
                f"thread {rec['name']!r} created here is still alive at "
                "sanitize-scope exit — join it (or close its owner) on "
                "every path"
            ),
            stacks=((
                "created at", tuple(_fmt_stack(rec["stack"]))
            ),),
            key=_finding_key(
                "unjoined-thread", _site_identity(site)
            ),
            anchors=_anchor_frames(rec["stack"]),
        ))

    for rec in scope.leaked:
        site = rec["site"]
        raw.append(SanitizeFinding(
            rule="leaked-lock",
            path=_rel(site.filename),
            line=site.lineno,
            message=(
                f"{rec['kind']} created here is still held by thread "
                f"{rec['holder']!r} at sanitize-scope exit — an acquire "
                "has no matching release"
            ),
            stacks=((
                "held since", tuple(_fmt_stack(rec["stack"]))
            ),),
            key=_finding_key("leaked-lock", _site_identity(site)),
            anchors=_anchor_frames(
                rec["stack"], rec.get("create_stack")
            ),
        ))

    active: list[SanitizeFinding] = []
    suppressed: list[SanitizeFinding] = []
    for f in raw:
        if _is_suppressed(f):
            suppressed.append(f)
        else:
            active.append(f)
    active.sort(key=lambda f: (f.rule, f.path, f.line))
    return active, suppressed


def _anchor_frames(*stacks, per_stack: int = 2) -> tuple:
    """The leading raw frames of each evidence stack — where a
    suppression comment may legitimately sit."""
    out = []
    for frames in stacks:
        for fr in (frames or ())[:per_stack]:
            out.append((fr.filename, fr.lineno))
    return tuple(out)


def _is_suppressed(f: SanitizeFinding) -> bool:
    """A finding is suppressed when ANY of its anchor frames' source
    lines carries a reasoned ``# dsst: ignore[<rule>]``: the offending
    access line for guarded-by, the acquisition (``with``) lines for
    lock-order, the creation line for thread/lock leaks."""
    candidates = [(str(REPO_ROOT / f.path), f.line), *f.anchors]
    for filename, lineno in candidates:
        if _suppression_reason(filename, lineno, f.rule) is not None:
            return True
    return False


# -- result / renderers -------------------------------------------------------


@dataclasses.dataclass
class SanitizeResult:
    workloads: list[str]
    findings: list[SanitizeFinding]
    baselined: list[SanitizeFinding]
    suppressed: list[SanitizeFinding]
    stale_baseline: list[dict]
    stats: dict

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
                "did not reproduce; remove it "
                "(sanitize --update-baseline)"
            )
        lines.append(
            f"{len(self.findings)} finding(s), "
            f"{len(self.baselined)} baselined, "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.stale_baseline)} stale baseline entr(y/ies) "
            f"[workloads: {', '.join(self.workloads)}; "
            f"{self.stats.get('locks', 0)} lock(s) instrumented, "
            f"{self.stats.get('edges', 0)} order edge(s) observed]"
        )
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "version": JSON_SCHEMA_VERSION,
            "workloads": self.workloads,
            "counts": {
                "active": len(self.findings),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "stale_baseline": len(self.stale_baseline),
            },
            "stats": self.stats,
            "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "baselined": [f.to_json() for f in self.baselined],
            "stale_baseline": self.stale_baseline,
        }, indent=2)


def build_result(
    scope,
    workloads: list[str],
    *,
    baseline_path: Path | None = None,
    full_run: bool = True,
) -> SanitizeResult:
    """Judge a finished scope against the baseline.

    ``full_run=False`` (a workload subset) skips stale-entry
    enforcement: a run that never exercised a finding's workload cannot
    prove the finding gone — the lint ``--changed`` discipline.
    """
    active, suppressed = findings_from_scope(scope)
    bl_path = (
        DEFAULT_SANITIZE_BASELINE if baseline_path is None else baseline_path
    )
    entries = load_baseline(bl_path)
    findings: list[SanitizeFinding] = []
    baselined: list[SanitizeFinding] = []
    matched: set[str] = set()
    for f in active:
        entry = entries.get(f.key)
        if entry is not None and str(entry.get("reason", "")).strip():
            baselined.append(f)
            matched.add(f.key)
        else:
            findings.append(f)
    stale = [
        {"key": k, **entry}
        for k, entry in sorted(entries.items())
        if k not in matched
    ] if full_run else []
    edges = scope.edges()
    return SanitizeResult(
        workloads=list(workloads),
        findings=findings,
        baselined=baselined,
        suppressed=suppressed,
        stale_baseline=stale,
        stats={
            "locks": scope.lock_count(),
            "edges": len(edges),
            "acquires_on_observed_edges": sum(
                e["count"] for e in edges.values()
            ),
        },
    )


def update_baseline(path: Path, result: SanitizeResult,
                    reason: str | None) -> int:
    """Rewrite the baseline to the current findings (active +
    already-baselined); the shared lint writer enforces the mandatory
    reason for new keys."""
    old = load_baseline(path)
    return write_baseline(
        path, result.findings + result.baselined, old, reason
    )
