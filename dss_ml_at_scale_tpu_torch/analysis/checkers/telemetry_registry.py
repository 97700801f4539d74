"""telemetry-registry: metric names used ⊆ declared, and none dead.

The metrics registry is get-or-create so call sites never coordinate —
which also means a typo silently forks a series
(``feeder_stall_seconds_total`` vs ``feeder_stall_second_total`` both
"work") and a renamed metric silently orphans every dashboard scraping
the old name. ``telemetry.catalog.KNOWN_METRICS`` declares every metric
the package may emit; this rule reconciles call sites against it in
both directions, exactly as ``fault-sites`` does for the chaos surface:

- every literal first argument of ``counter()``/``gauge()``/
  ``histogram()`` in the package must be declared with the matching
  kind;
- a non-literal name is allowed only inside the forwarding layer —
  functions NAMED like the facade (``counter``/``gauge``/``histogram``)
  or the registry internals (``_get``/``_new_child``); anything else
  forwarding a variable name needs an explicit suppression with its
  reason;
- every declared name must still have a call site.
"""

from __future__ import annotations

import ast

from ..astutil import call_name
from ..core import Checker, FileContext, Finding, register_checker

_KINDS = {"counter", "gauge", "histogram", "window"}
# Functions allowed to forward a variable metric name: the telemetry
# facade itself plus registry internals.
_FORWARDERS = {"counter", "gauge", "histogram", "window", "_get",
               "_new_child"}
# The definition layer: the registry and facade declare no metrics of
# their own; scanning them would flag their own forwarding signatures.
_SKIP_FILES = {
    "dss_ml_at_scale_tpu_torch/telemetry/__init__.py",
    "dss_ml_at_scale_tpu_torch/telemetry/registry.py",
    "dss_ml_at_scale_tpu_torch/telemetry/catalog.py",
}


@register_checker
class TelemetryRegistryChecker(Checker):
    name = "telemetry-registry"
    description = (
        "metric names at counter()/gauge()/histogram() call sites ⊆ "
        "telemetry.catalog.KNOWN_METRICS (kinds match), and no "
        "declared metric is dead"
    )
    roots = ("package",)

    def __init__(self, known: dict | None = None):
        if known is None:
            from ...telemetry.catalog import KNOWN_METRICS as known
        self.known = known
        self.used: set[str] = set()

    def check_file(self, ctx: FileContext) -> list[Finding]:
        if ctx.rel in _SKIP_FILES:
            return []
        out = []
        enclosing = ctx.enclosing_fns
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            kind = call_name(node)
            if kind not in _KINDS or not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                if enclosing.get(node) in _FORWARDERS:
                    continue
                out.append(self.finding(
                    ctx, node.lineno,
                    f"{kind}() with a non-literal metric name — literal "
                    "names are what keep the catalog (and dashboards) "
                    "honest; declare the name in telemetry.catalog",
                ))
                continue
            name = arg.value
            self.used.add(name)
            declared = self.known.get(name)
            if declared is None:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"metric {name!r} is not declared in "
                    "telemetry.catalog.KNOWN_METRICS — a typo forks a "
                    "series silently; declare it (or fix the name)",
                ))
            elif declared != kind:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"metric {name!r} used as {kind} but declared as "
                    f"{declared} in telemetry.catalog.KNOWN_METRICS",
                ))
        return out

    def finalize(self) -> list[Finding]:
        out = []
        for name, kind in self.known.items():
            if kind not in _KINDS:
                out.append(Finding(
                    self.name, "<registry>", 0,
                    f"KNOWN_METRICS[{name!r}] has invalid kind {kind!r} "
                    f"(must be one of {sorted(_KINDS)})",
                ))
            if name not in self.used:
                out.append(Finding(
                    self.name, "<registry>", 0,
                    f"KNOWN_METRICS[{name!r}] has no call site left in "
                    "the package — remove the entry or restore the "
                    "metric",
                ))
        return out
