"""bare-except: no swallowed errors in the library or scripts.

Swallowed exceptions are how robustness bugs hide: a retry loop that
"works" because the failure it should surface is eaten two frames down
is worse than no retry at all. Two patterns are banned:

- bare ``except:`` — catches ``KeyboardInterrupt``/``SystemExit`` too,
  which no library code here should ever intend;
- silent broad handlers — ``except Exception:`` / ``except
  BaseException:`` (alone or in a tuple) whose entire body is ``pass``
  (or a docstring + ``pass``); catching broadly is sometimes right, but
  then the handler must DO something: log, count, re-wrap, or fall back.

The old script's file→count allowlist is gone: audited swallows now
carry an in-source ``# dsst: ignore[bare-except] reason`` where they
happen, so the justification lives next to the code it excuses.
"""

from __future__ import annotations

import ast

from ..core import Checker, FileContext, Finding, register_checker

_BROAD = {"Exception", "BaseException"}


def _is_broad(expr: ast.expr | None) -> bool:
    if expr is None:
        return True  # bare except
    if isinstance(expr, ast.Name):
        return expr.id in _BROAD
    if isinstance(expr, ast.Tuple):
        return any(_is_broad(e) for e in expr.elts)
    return False


def _is_silent(handler: ast.ExceptHandler) -> bool:
    body = handler.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
        getattr(body[0], "value", None), ast.Constant
    ):
        body = body[1:]  # skip a docstring-style leading constant
    return all(isinstance(stmt, ast.Pass) for stmt in body)


@register_checker
class BareExceptChecker(Checker):
    name = "bare-except"
    description = (
        "no bare `except:` and no silent `except Exception: pass` — "
        "swallowed errors hide robustness bugs"
    )
    roots = ("package",)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out = []
        for node in ctx.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                out.append(self.finding(
                    ctx, node.lineno,
                    "bare `except:` — name the exceptions (or Exception) "
                    "you actually mean",
                ))
            elif _is_broad(node.type) and _is_silent(node):
                out.append(self.finding(
                    ctx, node.lineno,
                    "silent broad except (body is just `pass`) — log, "
                    "count, or narrow it; swallowed errors hide "
                    "robustness bugs",
                ))
        return out
