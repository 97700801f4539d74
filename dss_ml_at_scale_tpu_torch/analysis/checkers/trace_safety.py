"""trace-safety: no Python control flow / host ops on tensor values inside
``torch.autograd.Function``.

The torch meaning of the JAX rule. JAX's hazard is Python branching on a
tracer inside ``jit``: it raises, or silently bakes one branch into the
compiled program. The port's autograd Functions (the kernels' ``forward``
and ``backward``, the collectives, the pipeline schedule) run eagerly, so
the same code is a hazard of two kinds: every ``if t > 0``, ``bool(t)``,
``float(t)``, ``t.item()`` or ``np.*(t)`` on a card tensor is a host sync
per call, and a CUDA-graph capture of the step (planned for the decode
step) records only the branch taken while capturing, exactly as a trace
would. The fix is the same family as JAX's: ``torch.where``, masks, and
host values decided before ``apply``.

Detection is a conservative per-function taint pass over the
``forward``/``backward`` methods of every class whose base is
``torch.autograd.Function``:

- in ``forward``, every parameter after ``ctx`` is tainted, EXCEPT
  parameters annotated with a non-tensor type (``causal: bool``,
  ``grid: PipeGrid``) and positions that some ``<Class>.apply(...)`` call
  in the same file fills with a host value: a literal, a ``bool()``/
  ``int()``/``float()``/``str()`` cast, or a parameter of the calling
  function annotated with a non-tensor type;
- in ``backward``, every parameter after ``ctx`` (the output cotangents)
  is tainted, and so is whatever is unpacked from ``ctx.saved_tensors``;
  other ``ctx.<attr>`` reads are host values saved by ``forward``;
- taint propagates through assignments; ``.shape``/``.ndim``/``.dtype``/
  ``.device``/``.is_cuda``/``.requires_grad`` access, ``.size()``/
  ``.numel()``/``.dim()``/``.stride()``/``.is_contiguous()``, ``len()``,
  ``x is None`` tests and ``isinstance()`` are host metadata and launder
  taint.

Flagged: ``if``/``while``/conditional expressions over a live tainted
value, ``bool()``/``float()``/``int()`` of one, ``.item()``/``.tolist()``
on one, and ``np.*``/``numpy.*`` calls receiving one. A ``for`` over a
tensor is not flagged (unlike JAX's rule): it walks the first axis by
shape, which is host metadata.
"""

from __future__ import annotations

import ast

from ..astutil import call_name, dotted_name
from ..core import Checker, FileContext, Finding, register_checker

_FUNCTION_BASES = {"torch.autograd.Function", "autograd.Function", "Function"}
_METHODS = {"forward", "backward"}
# Reading these off a tensor yields host metadata, no sync.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_sparse", "is_leaf"}
_STATIC_CALLS = {"len", "isinstance", "type", "size", "numel", "dim",
                 "stride", "is_contiguous", "element_size", "data_ptr",
                 "is_floating_point", "is_complex"}
_HOST_CASTS = {"bool", "float", "int"}
_HOST_VALUE_CALLS = {"bool", "float", "int", "str", "tuple"}
_SYNC_METHODS = {"item", "tolist"}
_NP_MODULES = {"np", "numpy", "onp"}
_NP_OK_ATTRS = {"shape", "ndim", "dtype", "result_type", "issubdtype"}


def _is_tensor_annotation(ann: ast.expr | None) -> bool:
    """True for ``torch.Tensor``/``Tensor`` and any union or Optional
    holding one; an absent annotation counts as a tensor (taint errs
    toward reporting)."""
    if ann is None:
        return True
    for node in ast.walk(ann):
        name = dotted_name(node) if isinstance(
            node, (ast.Name, ast.Attribute)) else None
        if name and name.split(".")[-1] == "Tensor":
            return True
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "Tensor" in node.value:
            return True
    return False


def _host_params(fn) -> set[str]:
    """Parameters of ``fn`` annotated with a non-tensor type."""
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    return {a.arg for a in args
            if a.annotation is not None and not _is_tensor_annotation(a.annotation)}


class _TaintedUse(ast.NodeVisitor):
    """Collect live (unlaundered) uses of tainted names in an expression."""

    def __init__(self, taint: set[str]):
        self.taint = taint
        self.live: list[ast.Name] = []

    def visit_Name(self, node: ast.Name) -> None:
        if node.id in self.taint:
            self.live.append(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in _STATIC_ATTRS:
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if call_name(node) in _STATIC_CALLS:
            return
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        # `x is None` on an optional tensor argument is host identity.
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) and (
            any(
                isinstance(c, ast.Constant) and c.value is None
                for c in [node.left, *node.comparators]
            )
        ):
            return
        self.generic_visit(node)


def _live_uses(expr: ast.expr, taint: set[str]) -> list[ast.Name]:
    v = _TaintedUse(taint)
    v.visit(expr)
    return v.live


def _bound_names(target: ast.expr) -> list[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


def _reads_saved_tensors(expr: ast.expr, ctx_name: str) -> bool:
    return any(
        isinstance(n, ast.Attribute) and n.attr == "saved_tensors"
        and isinstance(n.value, ast.Name) and n.value.id == ctx_name
        for n in ast.walk(expr)
    )


class _FunctionBody(ast.NodeVisitor):
    """One forward/backward body: propagate taint, flag violations."""

    def __init__(self, checker: Checker, ctx: FileContext,
                 taint: set[str], ctx_name: str, where: str):
        self.checker = checker
        self.ctx = ctx
        self.taint = taint
        self.ctx_name = ctx_name
        self.where = where
        self.findings: list[Finding] = []

    def _flag(self, node: ast.AST, what: str, names: list[ast.Name]) -> None:
        ids = sorted({n.id for n in names})
        self.findings.append(self.checker.finding(
            self.ctx, node.lineno,
            f"{what} on tensor value(s) {', '.join(ids)} inside "
            f"{self.where} — a host sync per call, and a branch a CUDA-graph "
            "capture would bake; use torch.where/masks or decide it on the "
            "host before apply()",
        ))

    def _assign(self, targets: list[ast.expr], value: ast.expr | None):
        if value is None:
            return
        if _live_uses(value, self.taint) or _reads_saved_tensors(
                value, self.ctx_name):
            for t in targets:
                self.taint.update(_bound_names(t))

    def visit_Assign(self, node: ast.Assign) -> None:
        self._assign(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._assign([node.target], node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._assign([node.target], node.value)
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        live = _live_uses(node.test, self.taint)
        if live:
            self._flag(node, "Python `if`", live)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        live = _live_uses(node.test, self.taint)
        if live:
            self._flag(node, "conditional expression", live)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        live = _live_uses(node.test, self.taint)
        if live:
            self._flag(node, "Python `while`", live)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        # A `for` over a tensor walks its first axis by shape (host
        # metadata): no sync, nothing a capture bakes. Its loop variable
        # holds tensor data all the same.
        if _live_uses(node.iter, self.taint):
            self.taint.update(_bound_names(node.target))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        args_live = [n for a in node.args for n in _live_uses(a, self.taint)]
        if name in _HOST_CASTS and args_live:
            self._flag(node, f"host cast `{name}()`", args_live)
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS
            and _live_uses(node.func.value, self.taint)
        ):
            self._flag(node, f"`.{node.func.attr}()`",
                       _live_uses(node.func.value, self.taint))
        elif (
            isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in _NP_MODULES
            and node.func.attr not in _NP_OK_ATTRS
            and args_live
        ):
            self._flag(node, f"host numpy call `np.{node.func.attr}()`",
                       args_live)
        self.generic_visit(node)


@register_checker
class TraceSafetyChecker(Checker):
    name = "trace-safety"
    description = (
        "torch: no Python if/while, bool()/float()/int(), .item() or "
        "np.* on tensor arguments inside the forward/backward of a "
        "torch.autograd.Function (a host sync per call; a branch a "
        "CUDA-graph capture would bake)"
    )
    roots = ("package",)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        host_positions = self._apply_host_positions(ctx)
        findings: list[Finding] = []
        for cls in ctx.nodes:
            if not isinstance(cls, ast.ClassDef) or not any(
                dotted_name(b) in _FUNCTION_BASES for b in cls.bases
            ):
                continue
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef) or fn.name not in _METHODS:
                    continue
                params = fn.args.posonlyargs + fn.args.args
                if not params:
                    continue
                ctx_name, rest = params[0].arg, params[1:]
                taint = {a.arg for a in rest}
                if fn.args.vararg is not None:
                    taint.add(fn.args.vararg.arg)
                if fn.name == "forward":
                    taint -= _host_params(fn)
                    static = host_positions.get(cls.name, set())
                    taint -= {a.arg for i, a in enumerate(rest) if i in static}
                body = _FunctionBody(self, ctx, taint, ctx_name,
                                     f"{cls.name}.{fn.name}")
                for stmt in fn.body:
                    body.visit(stmt)
                findings.extend(body.findings)
        return findings

    @staticmethod
    def _apply_host_positions(ctx: FileContext) -> dict[str, set[int]]:
        """class name -> positions of ``forward`` (after ctx) that an
        ``<Class>.apply(...)`` call of this file fills with a host value."""
        out: dict[str, set[int]] = {}
        enclosing: dict[ast.AST, ast.AST | None] = {}

        def visit(node: ast.AST, fn) -> None:
            for child in ast.iter_child_nodes(node):
                enclosing[child] = fn
                visit(child, child if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)

        visit(ctx.tree, None)
        for node in ctx.nodes:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "apply"
                    and isinstance(node.func.value, ast.Name)):
                continue
            caller = enclosing.get(node)
            host = _host_params(caller) if caller is not None else set()
            positions = out.setdefault(node.func.value.id, set())
            for i, arg in enumerate(node.args):
                if isinstance(arg, ast.Starred):
                    break
                if (isinstance(arg, ast.Constant)
                        or (isinstance(arg, ast.Call)
                            and call_name(arg) in _HOST_VALUE_CALLS)
                        or (isinstance(arg, ast.Name) and arg.id in host)):
                    positions.add(i)
        return out
