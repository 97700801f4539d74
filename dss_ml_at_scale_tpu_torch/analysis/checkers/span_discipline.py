"""span-discipline: span names used ⊆ declared, none dead, no raw records.

The trace tooling groups and attributes by span *name*: ``trace
attribution`` buckets ``reader.next`` as data wait and ``train_step``
as compute, the chaos soak's flight-recorder invariant looks for open
fit-family spans, and Perfetto lanes are read by name. A typo'd span
name doesn't error — it silently falls out of every breakdown, exactly
the failure mode the metric catalog already guards against for series
names. ``telemetry.catalog.KNOWN_SPANS`` declares every span the
package may open; this rule reconciles call sites against it in both
directions (mirroring ``telemetry-registry``):

- every literal first argument of a ``span()`` call in the package must
  be declared in KNOWN_SPANS;
- a non-literal name is allowed only in the forwarding layer (functions
  named ``span`` — the facade and ``SpanLog.span``); anywhere else it
  needs a reasoned suppression;
- every declared name must still have a call site (``span()`` or
  ``record()``);
- raw ``record()`` calls outside ``telemetry/`` bypass the begin-event
  flight-recorder discipline (a span recorded only at exit is invisible
  if the process dies inside it) — each needs a reasoned
  ``# dsst: ignore[span-discipline]`` explaining why a with-span can't
  express it.
"""

from __future__ import annotations

import ast

from ..astutil import call_name
from ..core import Checker, FileContext, Finding, register_checker

# Functions allowed to forward a variable span name: the telemetry
# facade and the span log itself.
_FORWARDERS = {"span"}
# The definition layer: the facade and SpanLog declare no spans of
# their own, and their record() internals ARE the implementation.
_SKIP_FILES = {
    "dss_ml_at_scale_tpu_torch/telemetry/__init__.py",
    "dss_ml_at_scale_tpu_torch/telemetry/spans.py",
    "dss_ml_at_scale_tpu_torch/telemetry/catalog.py",
}
_TELEMETRY_PREFIX = "dss_ml_at_scale_tpu_torch/telemetry/"


@register_checker
class SpanDisciplineChecker(Checker):
    name = "span-discipline"
    full_scan_only = True
    description = (
        "span names at span() call sites ⊆ telemetry.catalog."
        "KNOWN_SPANS, no declared span is dead, and raw record() calls "
        "outside telemetry/ carry a reasoned suppression"
    )
    roots = ("package",)

    def __init__(self, known: dict | set | None = None):
        if known is None:
            from ...telemetry.catalog import KNOWN_SPANS as known
        self.known = (
            known if isinstance(known, dict) else {k: "" for k in known}
        )
        self.used: set[str] = set()

    def check_file(self, ctx: FileContext) -> list[Finding]:
        if ctx.rel in _SKIP_FILES:
            return []
        out = []
        enclosing = ctx.enclosing_fns
        in_telemetry = ctx.rel.startswith(_TELEMETRY_PREFIX)
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            fn = call_name(node)
            if fn == "span" and node.args:
                arg = node.args[0]
                if not (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)):
                    if enclosing.get(node) in _FORWARDERS:
                        continue
                    out.append(self.finding(
                        ctx, node.lineno,
                        "span() with a non-literal name — literal names "
                        "are what keep the span catalog (and trace "
                        "attribution) honest; declare the name in "
                        "telemetry.catalog.KNOWN_SPANS",
                    ))
                    continue
                name = arg.value
                self.used.add(name)
                if name not in self.known:
                    out.append(self.finding(
                        ctx, node.lineno,
                        f"span {name!r} is not declared in telemetry."
                        "catalog.KNOWN_SPANS — a typo'd span silently "
                        "falls out of every trace breakdown; declare it "
                        "(or fix the name)",
                    ))
            elif fn == "record" and not in_telemetry:
                # Count a literal name as a live call site even though
                # the raw record itself needs justifying.
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    self.used.add(node.args[0].value)
                out.append(self.finding(
                    ctx, node.lineno,
                    "raw record() outside telemetry/ — complete-at-exit "
                    "records are invisible to the flight recorder if "
                    "the process dies inside them; use a span() (or "
                    "suppress with the reason a with-span can't express "
                    "this site)",
                ))
        return out

    def finalize(self) -> list[Finding]:
        out = []
        for name in self.known:
            if name not in self.used:
                out.append(Finding(
                    self.name, "<registry>", 0,
                    f"KNOWN_SPANS[{name!r}] has no call site left in "
                    "the package — remove the entry or restore the "
                    "span",
                ))
        return out
