"""slo-registry: objective names declared ⊆ cataloged, and none dead.

An SLO is a *name with a promise attached*: ``slo check`` gates CI
on it, the burn-rate engine journals transitions under it, and the
doctor surfaces it for dead runs. A typo'd objective name doesn't error
— it silently declares a NEW budget nobody alerts on (and orphans the
one dashboards watch), exactly the series-forking failure mode the
metric/span catalogs already guard against.
``telemetry.catalog.KNOWN_SLOS`` declares every objective; this rule
reconciles the code against it in both directions (mirroring
``telemetry-registry``):

- every ``Objective(name=...)`` declaration in the package must use a
  literal name that appears in KNOWN_SLOS (a non-literal name needs a
  reasoned suppression — a computed objective name can't be audited);
- every literal objective name at a ``set_target(...)`` call site must
  be declared (arming a typo'd objective raises only at runtime, and
  only if that code path runs);
- every KNOWN_SLOS entry must still have an ``Objective`` declaration —
  a dead catalog entry is a promise nobody measures.
"""

from __future__ import annotations

import ast

from ..astutil import call_name
from ..core import Checker, FileContext, Finding, register_checker

# The catalog declares, it does not construct; scanning it would be
# self-referential noise.
_SKIP_FILES = {
    "dss_ml_at_scale_tpu_torch/telemetry/catalog.py",
}


def _name_arg(node: ast.Call) -> ast.expr | None:
    """The ``name`` argument of an Objective(...) call, positional or
    keyword."""
    for kw in node.keywords:
        if kw.arg == "name":
            return kw.value
    if node.args:
        return node.args[0]
    return None


@register_checker
class SloRegistryChecker(Checker):
    name = "slo-registry"
    description = (
        "Objective(name=...) declarations and set_target() call sites "
        "⊆ telemetry.catalog.KNOWN_SLOS, and no declared objective is "
        "dead"
    )
    roots = ("package",)

    def __init__(self, known: dict | None = None):
        if known is None:
            from ...telemetry.catalog import KNOWN_SLOS as known
        self.known = known
        self.declared: set[str] = set()

    def check_file(self, ctx: FileContext) -> list[Finding]:
        if ctx.rel in _SKIP_FILES:
            return []
        out = []
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = call_name(node)
            if fn == "Objective":
                arg = _name_arg(node)
                if arg is None:
                    continue
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    out.append(self.finding(
                        ctx, node.lineno,
                        "Objective() with a non-literal name — literal "
                        "names are what keep the SLO catalog (and "
                        "`slo check`) auditable; declare the name "
                        "in telemetry.catalog.KNOWN_SLOS",
                    ))
                    continue
                self.declared.add(arg.value)
                if arg.value not in self.known:
                    out.append(self.finding(
                        ctx, node.lineno,
                        f"objective {arg.value!r} is not declared in "
                        "telemetry.catalog.KNOWN_SLOS — a typo'd "
                        "objective silently declares a budget nobody "
                        "alerts on; declare it (or fix the name)",
                    ))
            elif fn == "set_target" and node.args:
                arg = node.args[0]
                if (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)
                        and arg.value not in self.known):
                    out.append(self.finding(
                        ctx, node.lineno,
                        f"set_target() arms objective {arg.value!r} "
                        "which is not declared in telemetry.catalog."
                        "KNOWN_SLOS — arming a typo raises only at "
                        "runtime, and only if this path runs",
                    ))
        return out

    def finalize(self) -> list[Finding]:
        out = []
        for name in self.known:
            if name not in self.declared:
                out.append(Finding(
                    self.name, "<registry>", 0,
                    f"KNOWN_SLOS[{name!r}] has no Objective declaration "
                    "left in the package — remove the entry or restore "
                    "the objective",
                ))
        return out
