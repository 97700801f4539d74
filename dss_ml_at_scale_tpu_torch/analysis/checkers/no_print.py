"""no-print: library code must not ``print``.

Every user-facing line flows through an accountable channel — telemetry
(metered), tracking (archived), or ``logging`` (filterable). A bare
``print`` in library code bypasses all three and corrupts
machine-parseable CLI stdout. The CLI surface (``config/``: cli,
commands, pipeline — whose *job* is stdout) is the one exemption.
"""

from __future__ import annotations

import ast

from ..core import Checker, FileContext, Finding, register_checker

# The CLI surface: stdout is its contract.
ALLOWED_FIRST_PARTS = {"config"}
_PACKAGE_PREFIX = "dss_ml_at_scale_tpu_torch/"


@register_checker
class NoPrintChecker(Checker):
    name = "no-print"
    description = (
        "no bare print() in library code — route through "
        "telemetry/tracking/logging; config/ (the CLI) is exempt"
    )
    roots = ("package",)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        rel = ctx.rel
        if rel.startswith(_PACKAGE_PREFIX):
            rel = rel[len(_PACKAGE_PREFIX):]
        if rel.split("/", 1)[0] in ALLOWED_FIRST_PARTS:
            return []
        out = []
        for node in ctx.nodes:
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                out.append(self.finding(
                    ctx, node.lineno,
                    "bare print() — route through telemetry/tracking/"
                    "logging",
                ))
        return out
