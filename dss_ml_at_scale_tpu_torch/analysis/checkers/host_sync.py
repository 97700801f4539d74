"""host-sync: no host synchronization inside ``# dsst: hotpath`` code.

The torch meaning of the JAX rule. CUDA work is queued asynchronously:
the step loop, the feeder and the serving threads stay ahead of the card
only while nothing on their path waits for it. A single ``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()``, ``float(t)``/``int(t)``/
``bool(t)`` of a card tensor, ``np.asarray(t)``, ``torch.cuda.
synchronize()`` or an ``Event``/``Stream`` ``.synchronize()`` blocks the
host until the queued kernels finish, turning asynchronous dispatch back
into lockstep. The numbers stay right, so no test fails: only a profile
or this checker catches it.

Mark latency-critical code with ``# dsst: hotpath`` on (or directly
above) a ``def``/``for``/``while`` line; the whole body is then checked.
Marked in the port: the trainer's step loop, the feeder thread and its
consumer pop, the serving decode and batcher threads, and the serving
score path. Deliberate syncs (a throttled metrics fetch, a host batch
that is numpy anyway) carry ``# dsst: ignore[host-sync] reason`` where
they happen.

Flagged inside hot code: ``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``.synchronize()`` (``torch.cuda.synchronize()`` and an
event's or stream's), ``np.asarray``/``np.array``/``np.copy`` calls,
and ``float()``/``int()``/``bool()`` of a non-literal. The AST cannot
tell a tensor from a Python number, so a cast of a host value is flagged
too and is suppressed with its reason (or hoisted).
"""

from __future__ import annotations

import ast

from ..astutil import call_name
from ..core import Checker, FileContext, Finding, register_checker

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_NP_MODULES = {"np", "numpy", "onp"}
_NP_SYNC_ATTRS = {"asarray", "array", "copy"}
_HOST_CASTS = {"float", "int", "bool"}
_HOT_STMTS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.For, ast.While)


@register_checker
class HostSyncChecker(Checker):
    name = "host-sync"
    description = (
        "torch: no .item()/.cpu()/.tolist()/.numpy()/float()/int()/bool()/"
        "np.asarray/torch.cuda.synchronize()/Event-or-Stream .synchronize() "
        "inside functions or loops marked `# dsst: hotpath` (each blocks "
        "the host on the card's queue)"
    )
    roots = ("package",)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        # A marked loop inside a marked function reports each call once
        # (duplicates would also mint two baseline keys for one defect).
        seen: set[int] = set()
        for node in ctx.nodes:
            if isinstance(node, _HOT_STMTS) and ctx.is_hotpath_marked(node):
                scan: list[ast.AST] = []
                if isinstance(node, (ast.For, ast.While)):
                    scan.extend(node.body + node.orelse)
                    # The loop header runs every iteration too.
                    scan.append(
                        node.test if isinstance(node, ast.While)
                        else node.iter
                    )
                else:
                    scan.extend(node.body)
                for stmt in scan:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and id(sub) not in seen:
                            seen.add(id(sub))
                            f = self._check_call(ctx, sub)
                            if f is not None:
                                out.append(f)
        return out

    def _check_call(self, ctx: FileContext,
                    node: ast.Call) -> Finding | None:
        name = call_name(node)
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _SYNC_METHODS:
                return self.finding(
                    ctx, node.lineno,
                    f".{node.func.attr}() in a hotpath — waits for the "
                    "card's queued kernels to finish; move it off the hot "
                    "loop or let the value ride telemetry asynchronously",
                )
            if (
                isinstance(node.func.value, ast.Name)
                and node.func.value.id in _NP_MODULES
                and node.func.attr in _NP_SYNC_ATTRS
            ):
                return self.finding(
                    ctx, node.lineno,
                    f"np.{node.func.attr}() in a hotpath — of a card tensor "
                    "it is a blocking device→host copy; keep data on the "
                    "card or stage it on the feeder thread",
                )
        if name in _HOST_CASTS and node.args and not isinstance(
            node.args[0], ast.Constant
        ):
            return self.finding(
                ctx, node.lineno,
                f"{name}() of a computed value in a hotpath — of a card "
                "tensor this is a blocking scalar fetch; hoist it or "
                "suppress with a reason",
            )
        return None
