"""fault-sites: injection sites cannot drift from their registry.

Every ``maybe_fail("...")`` / ``fault_fires("...")`` call site in the
library is part of the chaos-testing surface operators arm with
``--fault-plan`` — so every site name used in the package must be
declared (with a description) in ``resilience.faults.KNOWN_SITES``, and
every declared site must still have a call site. Otherwise injection
sites silently drift from the docs and the CLI help (generated from the
same dict), and a chaos plan arms nothing.

Rules:

- a site argument must be a string literal, or an f-string whose
  *leading literal prefix* (``f"rpc.send.{method}"`` → ``rpc.send``)
  matches a registered site — dynamic suffixes are how per-method RPC
  sites work;
- a bare variable argument is allowed only inside a function that is
  itself a registered marker (forwarding wrappers like
  ``runtime.rpc._maybe_fail``);
- every ``KNOWN_SITES`` key must be used by at least one call site and
  carry a non-empty description.
"""

from __future__ import annotations

import ast

from ..astutil import call_name
from ..core import Checker, FileContext, Finding, register_checker

# Call names that mark an injection site. Wrapper functions carrying one
# of these names may forward a variable site argument.
MARKERS = {"maybe_fail", "fault_fires", "_maybe_fail", "check", "fires"}
_CALLS = ("maybe_fail", "fault_fires", "_maybe_fail")


def _site_literal(arg: ast.expr) -> tuple[str | None, bool]:
    """``(site, is_prefix)`` from the argument node, or ``(None, False)``
    when it is not a (partially) literal string."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        prefix = ""
        for part in arg.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                prefix += part.value
            else:
                break
        return (prefix.rstrip(".") or None), True
    return None, False


def _registered(site: str, is_prefix: bool, known: dict) -> bool:
    for key in known:
        if site == key or site.startswith(key + "."):
            return True
        if is_prefix and key.startswith(site + "."):
            return True
    return False


@register_checker
class FaultSitesChecker(Checker):
    name = "fault-sites"
    full_scan_only = True
    description = (
        "fault-injection sites used in the package ⊆ documented "
        "resilience.faults.KNOWN_SITES, and no registered site is dead"
    )
    roots = ("package",)

    def __init__(self, known: dict | None = None):
        # Default to the LIVE registry — the lint must test what ships,
        # not a copy that could itself drift. Tests inject a fake.
        if known is None:
            from ...resilience.faults import KNOWN_SITES as known
        self.known = known
        self.used: list[tuple[str, bool]] = []

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        enclosing = ctx.enclosing_fns
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name not in _CALLS or not node.args:
                continue
            site, is_prefix = _site_literal(node.args[0])
            if site is None:
                if (
                    isinstance(node.args[0], ast.Name)
                    and enclosing.get(node) in MARKERS
                ):
                    continue  # a wrapper forwarding its site parameter
                out.append(self.finding(
                    ctx, node.lineno,
                    f"{name}() with a non-literal site — use a string "
                    "literal (or f-string with a registered prefix) so "
                    "the site registry can see it",
                ))
                continue
            self.used.append((site, is_prefix))
            if not _registered(site, is_prefix, self.known):
                out.append(self.finding(
                    ctx, node.lineno,
                    f"site {site!r} is not registered in "
                    "resilience.faults.KNOWN_SITES — declare and "
                    "document it there",
                ))
        return out

    def finalize(self) -> list[Finding]:
        out = []
        for key, doc in self.known.items():
            if not (isinstance(doc, str) and doc.strip()):
                out.append(Finding(
                    self.name, "<registry>", 0,
                    f"KNOWN_SITES[{key!r}] has no description — document "
                    "what arming it simulates",
                ))
            if not any(
                site == key or site.startswith(key + ".")
                or (is_prefix and key.startswith(site + "."))
                for site, is_prefix in self.used
            ):
                out.append(Finding(
                    self.name, "<registry>", 0,
                    f"KNOWN_SITES[{key!r}] has no call site left in the "
                    "package — remove the entry or restore the site",
                ))
        return out
