"""retrace-hazard: patterns that build a kernel or compile a graph more
than once per program, or keep every build forever.

The torch meaning of the JAX rule. JAX's hazard is a jit cache that
misses (a fresh callable per loop turn or per call) and an unbounded
cache of compiled ops keyed by array dims. The port's counterparts are:

- **unbounded caches minting built artifacts**: ``@functools.cache`` /
  ``@lru_cache(maxsize=None)`` on a factory that builds or loads a
  kernel (``ops/_build.py``'s ``build``/``load``, ``ctypes.CDLL``,
  ``torch.utils.cpp_extension.load``), captures a CUDA graph
  (``torch.cuda.CUDAGraph``, ``make_graphed_callables``) or compiles
  (``torch.compile``), or whose parameters look like array dims. Each
  entry pins a loaded library, a graph's private memory pool or a
  compiled artifact for the life of the process: the shape-keyed leak
  ``ops/fused_matmul.py`` once shipped in JAX, in torch form.
- ``torch.compile(...)`` or ``torch.cuda.CUDAGraph()`` **inside a loop**:
  every turn compiles (or captures) again.
- ``torch.compile(lambda ...)`` **inside a function**: the lambda is a
  fresh object per call, so every call recompiles and the old artifact
  stays cached by dynamo.

A bare ``@lru_cache`` or ``@lru_cache(N)`` is bounded and not flagged.
"""

from __future__ import annotations

import ast

from ..astutil import ancestors, call_name, dotted_name
from ..core import Checker, FileContext, Finding, register_checker

# Calls that compile or capture: hazardous in a loop or around a lambda.
_COMPILERS = {"compile", "CUDAGraph", "make_graphed_callables"}
# Calls whose result a cache entry would pin: built/loaded kernels,
# graphs, compiled artifacts.
_ARTIFACT_FACTORIES = _COMPILERS | {
    "CDLL", "LoadLibrary", "build", "build_all", "load", "load_inline",
    "graph", "jit",  # triton.jit
}
# Parameter names that smell like array dimensions — the cache key that
# grows without bound as shapes vary.
_SHAPE_PARAMS = {"m", "n", "k", "b", "shape", "shapes", "dim", "dims",
                 "size", "sizes", "rows", "cols", "batch", "batch_size",
                 "length", "seq_len", "width", "height"}


def _is_compiler_call(node: ast.Call) -> bool:
    """``torch.compile(...)``/``compile(fn)`` of a callable — not the
    builtin ``compile(source, filename, mode)`` nor ``re.compile``."""
    name = call_name(node)
    if name not in _COMPILERS:
        return False
    if name != "compile":
        return True
    owner = dotted_name(node.func.value) if isinstance(
        node.func, ast.Attribute) else None
    return owner == "torch" or (owner is None and len(node.args) <= 1)


def _is_unbounded_cache_decorator(dec: ast.expr) -> bool:
    """``@functools.cache``, ``@lru_cache(maxsize=None)``. A bare
    ``@lru_cache`` or ``@lru_cache()`` defaults to maxsize=128."""
    if isinstance(dec, (ast.Name, ast.Attribute)):
        dotted = dotted_name(dec)
        return bool(dotted) and dotted.split(".")[-1] == "cache"
    name = call_name(dec) if isinstance(dec, ast.Call) else None
    if name == "cache":
        return True
    if name == "lru_cache":
        for kw in dec.keywords:
            if kw.arg == "maxsize" and (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            ):
                return True
        if dec.args and isinstance(dec.args[0], ast.Constant) and (
            dec.args[0].value is None
        ):
            return True
    return False


@register_checker
class RetraceHazardChecker(Checker):
    name = "retrace-hazard"
    description = (
        "torch: no unbounded cache (functools.cache, lru_cache(maxsize=None)) "
        "on a factory that builds/loads kernels, captures CUDA graphs or "
        "torch.compiles, or is keyed by array dims; no torch.compile/"
        "CUDAGraph minted in a loop or around a lambda per call"
    )
    roots = ("package",)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        parents = ctx.parents
        for node in ctx.nodes:
            if isinstance(node, ast.Call) and _is_compiler_call(node):
                out.extend(self._check_compiler_call(ctx, node, parents))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_cached_factory(ctx, node))
        return out

    def _check_compiler_call(self, ctx, node: ast.Call,
                             parents) -> list[Finding]:
        out = []
        what = call_name(node)
        in_loop = any(
            isinstance(a, (ast.For, ast.While, ast.AsyncFor))
            for a in ancestors(node, parents)
        )
        if in_loop:
            out.append(self.finding(
                ctx, node.lineno,
                f"{what}() inside a loop — every iteration compiles (or "
                "captures) again; hoist it out of the loop",
            ))
        if node.args and isinstance(node.args[0], ast.Lambda):
            in_function = any(
                isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                for a in ancestors(node, parents)
            )
            if in_function and not in_loop:
                out.append(self.finding(
                    ctx, node.lineno,
                    f"{what}(lambda ...) inside a function — the lambda is "
                    "a fresh cache key per call, so every call recompiles; "
                    "define the function once at module scope",
                ))
        return out

    def _check_cached_factory(self, ctx, node) -> list[Finding]:
        if not any(_is_unbounded_cache_decorator(d)
                   for d in node.decorator_list):
            return []
        mints = any(
            isinstance(n, ast.Call) and call_name(n) in _ARTIFACT_FACTORIES
            for n in ast.walk(node)
        )
        params = [
            a.arg for a in (
                node.args.posonlyargs + node.args.args + node.args.kwonlyargs
            )
        ]
        shape_keyed = sorted(p for p in params if p.lower() in _SHAPE_PARAMS)
        if not (mints or shape_keyed):
            return []
        detail = []
        if mints:
            detail.append(
                "the body builds/loads a kernel, captures a graph or "
                "compiles, so every cache entry pins that artifact"
            )
        if shape_keyed:
            detail.append(
                f"parameter(s) {', '.join(shape_keyed)} look like array "
                "dims — a shape-keyed unbounded cache"
            )
        return [self.finding(
            ctx, node.lineno,
            f"unbounded cache on {node.name!r}: " + "; ".join(detail)
            + " — bound maxsize or key on a closed config set",
        )]
