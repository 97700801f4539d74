"""durable-write: atomic-rename publishes must go through the
durability layer.

A bare ``os.replace``/``Path.replace`` publish is atomic against
*readers* but not against *power*: without the fsync-file →
rename → fsync-dir sequence (``resilience.durability``), a hard crash
can surface a published name whose bytes never hit the disk, or lose
the rename entirely — exactly the torn states the crash-only runtime
promises cannot exist. Every rename-publish in the package must route
through ``durable_write_*``/``durable_replace`` (which also carry the
``fs.*`` fault sites the chaos soak arms); genuinely non-durable
renames say why with ``# dsst: ignore[durable-write] reason``.

What is flagged:

- any ``os.replace(src, dst)`` / ``os.rename(src, dst)`` call,
  including through ``from os import replace/rename`` aliases — both
  spellings of the same rename-publish syscall;
- any single-positional-argument ``x.replace(y)``/``x.rename(y)``
  attribute call — the ``pathlib.Path`` shape. ``str.replace(old,
  new)`` takes two arguments and ``dataclasses.replace(obj, **kw)``/
  flax ``.replace`` pass keywords, so neither matches.

``resilience/durability.py`` itself is exempt — it IS the primitive.
"""

from __future__ import annotations

import ast

from ..astutil import dotted_name
from ..core import Checker, FileContext, Finding, register_checker

EXEMPT_FILES = ("dss_ml_at_scale_tpu_torch/resilience/durability.py",)


@register_checker
class DurableWriteChecker(Checker):
    name = "durable-write"
    description = (
        "os.replace/Path.replace publishes must route through "
        "resilience.durability (fsync → rename → fsync dir), or carry a "
        "reasoned ignore"
    )
    roots = ("package",)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        if ctx.rel in EXEMPT_FILES:
            return []
        # Bare names bound to the os-level rename syscall via
        # `from os import replace [as x]` — same publish, different
        # spelling, must not dodge the rule.
        os_aliases: set[str] = set()
        for node in ctx.nodes:
            if (isinstance(node, ast.ImportFrom) and node.module == "os"
                    and node.level == 0):
                for alias in node.names:
                    if alias.name in ("replace", "rename"):
                        os_aliases.add(alias.asname or alias.name)
        out: list[Finding] = []
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name) and func.id in os_aliases:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"os-level {func.id}() publish outside "
                    "resilience.durability — use durable_write_*/"
                    "durable_replace (fsync → rename → fsync dir) so "
                    "the publish survives a power cut",
                ))
                continue
            if not (isinstance(func, ast.Attribute)
                    and func.attr in ("replace", "rename")):
                continue
            owner = dotted_name(func.value)
            if owner == "os":
                out.append(self.finding(
                    ctx, node.lineno,
                    f"os.{func.attr}() publish outside "
                    "resilience.durability — use durable_write_*/"
                    "durable_replace (fsync → rename → fsync dir) so "
                    "the publish survives a power cut",
                ))
                continue
            if owner in ("dataclasses", "jax", "jnp", "np", "numpy"):
                continue  # library .replace helpers, never a publish
            if len(node.args) == 1 and not node.keywords:
                # The pathlib.Path.replace/rename(target) shape: one
                # positional argument, no keywords (str.replace takes
                # two, struct .replace takes keywords).
                out.append(self.finding(
                    ctx, node.lineno,
                    f".{func.attr}(target) rename-publish outside "
                    "resilience.durability — use durable_write_*/"
                    "durable_replace, or justify with "
                    "# dsst: ignore[durable-write]",
                ))
        return out
