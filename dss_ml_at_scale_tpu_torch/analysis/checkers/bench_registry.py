"""bench-registry: scenario/metric declarations ⊆ catalog, none dead.

The bench baseline keys regression verdicts by ``(scenario, metric)``
name. A typo'd metric key in a ``Scenario(...)`` declaration doesn't
error — it mints a fresh baseline series with no history, so the
renamed metric silently dodges its regression gate while the committed
entry goes stale. ``telemetry.catalog.KNOWN_BENCH_METRICS`` declares
every scenario and the exact metric keys its schema may emit; this
rule reconciles the ``Scenario(...)``/``Metric(...)`` call sites
against it in both directions (the telemetry-registry /
span-discipline idiom, third instance):

- every ``Scenario(name=...)`` in the package must be declared, with
  its ``metrics=(Metric("..."), ...)`` keys matching the catalog's set
  exactly (both missing and extra keys are findings);
- scenario and metric names must be literal — a computed name is
  invisible to this rule and to the baseline;
- every catalog entry must still have a ``Scenario`` declaration.
"""

from __future__ import annotations

import ast

from ..astutil import call_name
from ..core import Checker, FileContext, Finding, register_checker

# The definition layer: the framework's dataclasses and the catalog
# itself declare no scenarios of their own.
_SKIP_FILES = {
    "dss_ml_at_scale_tpu_torch/telemetry/catalog.py",
}


def _literal_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@register_checker
class BenchRegistryChecker(Checker):
    name = "bench-registry"
    full_scan_only = True
    description = (
        "Scenario()/Metric() declarations reconcile both ways against "
        "telemetry.catalog.KNOWN_BENCH_METRICS (names literal, metric "
        "key sets exact, no dead catalog entries)"
    )
    roots = ("package",)

    def __init__(self, known: dict | None = None):
        if known is None:
            from ...telemetry.catalog import KNOWN_BENCH_METRICS as known
        self.known = {k: tuple(v) for k, v in known.items()}
        self.declared: set[str] = set()

    def check_file(self, ctx: FileContext) -> list[Finding]:
        if ctx.rel in _SKIP_FILES:
            return []
        out: list[Finding] = []
        for node in ctx.nodes:
            if not (isinstance(node, ast.Call)
                    and call_name(node) == "Scenario"):
                continue
            kwargs = {k.arg: k.value for k in node.keywords if k.arg}
            name = _literal_str(kwargs.get("name"))
            if name is None:
                out.append(self.finding(
                    ctx, node.lineno,
                    "Scenario() with a non-literal name — literal names "
                    "are what key the baseline and the catalog; inline it",
                ))
                continue
            self.declared.add(name)
            metrics, bad_line = self._metric_names(kwargs.get("metrics"))
            if bad_line is not None:
                out.append(self.finding(
                    ctx, bad_line or node.lineno,
                    f"scenario {name!r}: metrics must be a literal tuple "
                    "of Metric(\"...\") calls — computed metric keys are "
                    "invisible to the baseline gate",
                ))
                continue
            declared = self.known.get(name)
            if declared is None:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"scenario {name!r} is not declared in telemetry."
                    "catalog.KNOWN_BENCH_METRICS — an undeclared "
                    "scenario's metrics dodge the registry gate; declare "
                    "it (or fix the name)",
                ))
                continue
            missing = sorted(set(declared) - set(metrics))
            extra = sorted(set(metrics) - set(declared))
            for m in extra:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"scenario {name!r} emits metric {m!r} not declared "
                    "in KNOWN_BENCH_METRICS — a typo'd key silently "
                    "forks a baseline series; declare it (or fix it)",
                ))
            for m in missing:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"scenario {name!r} no longer emits declared metric "
                    f"{m!r} — remove the KNOWN_BENCH_METRICS entry or "
                    "restore the metric",
                ))
        return out

    @staticmethod
    def _metric_names(node) -> tuple[list[str], int | None]:
        """(metric names, first-bad-line) — bad-line non-None when any
        element is not a literal ``Metric("...")`` call."""
        if not isinstance(node, (ast.Tuple, ast.List)):
            return [], getattr(node, "lineno", 0) if node is not None else 0
        names: list[str] = []
        for el in node.elts:
            if not (isinstance(el, ast.Call) and call_name(el) == "Metric"):
                return names, getattr(el, "lineno", 0)
            # Positional or keyword form — Metric("x", ...) and
            # Metric(name="x", ...) are both literal declarations.
            name_node = el.args[0] if el.args else next(
                (k.value for k in el.keywords if k.arg == "name"), None
            )
            name = _literal_str(name_node)
            if name is None:
                return names, el.lineno
            names.append(name)
        return names, None

    def finalize(self) -> list[Finding]:
        out = []
        for name in self.known:
            if name not in self.declared:
                out.append(Finding(
                    self.name, "<registry>", 0,
                    f"KNOWN_BENCH_METRICS[{name!r}] has no Scenario() "
                    "declaration left in the package — remove the entry "
                    "or restore the scenario",
                ))
        return out
