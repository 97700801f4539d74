"""Small shared AST helpers the checkers lean on.

Kept deliberately tiny: a parent map (ast has no uplinks), call-name
resolution (``compile`` / ``torch.compile`` / ``functools.cache`` all
answer to their terminal identifier), and enclosing-function lookup for the
forwarding-wrapper allowances the registry checkers grant.
"""

from __future__ import annotations

import ast
from typing import Iterator


def parent_map(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing_function_names(tree: ast.AST) -> dict[ast.AST, str | None]:
    """node -> name of its innermost enclosing function (None at module
    scope) — how forwarding wrappers are recognized."""
    out: dict[ast.AST, str | None] = {}

    def visit(node: ast.AST, fn: str | None) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        for child in ast.iter_child_nodes(node):
            out[child] = fn
            visit(child, fn)

    visit(tree, None)
    return out


def call_name(node: ast.Call) -> str | None:
    """Terminal identifier of the callee: ``torch.compile(...)`` ->
    ``compile``."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def dotted_name(node: ast.expr) -> str | None:
    """``torch.autograd.Function`` -> that string; None for non-names."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def ancestors(node: ast.AST,
              parents: dict[ast.AST, ast.AST]) -> Iterator[ast.AST]:
    cur = parents.get(node)
    while cur is not None:
        yield cur
        cur = parents.get(cur)
