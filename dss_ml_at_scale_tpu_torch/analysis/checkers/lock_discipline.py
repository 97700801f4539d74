"""lock-discipline: declared shared state is only touched under its lock.

Six thread families now share this runtime (feeder, serving batcher,
decode pool, worker heartbeats, checkpoint finalizer, SIGTERM path).
The races they breed are the worst kind of bug: rare, silent, and
unreproducible in tests. CPython's GIL makes single *bytecodes* atomic
— it does NOT make check-then-act sequences atomic, and the classes
here already know which attributes are shared. This checker makes that
knowledge enforceable:

- a class declares ``_guarded_by_lock = ("attr", ...)`` (and optionally
  ``_lock_name = "_cond"``; default accepts ``_lock``/``_cond``/
  ``_mutex``). Every ``self.attr`` read or write in the class body must
  then sit inside ``with self.<lock>:``. ``__init__``/``__del__`` are
  exempt (construction happens-before publication).
- module globals bound to mutable literals (``dict``/``list``/``set``)
  in a module that imports ``threading`` must only be *mutated* inside
  functions under a ``with <module-level Lock>:`` — the pattern
  ``hpo/shipping.py`` gets right and ``Thread(target=...)`` entry
  points make mandatory.
- any class that *owns a thread* — constructs ``threading.Thread`` in
  its body, or is handed one (an ``__init__`` parameter named
  ``thread``) — must declare ``_guarded_by_lock`` or carry a reasoned
  suppression on the class line. Owning a thread is what makes state
  shared; an owner with no declared contract is invisible to both this
  rule's attribute check AND the runtime sanitizer (``sanitize``
  enforces the same declarations dynamically), so new threaded code
  cannot opt out of either tier silently. A class whose only
  cross-thread channels are queues/events suppresses with that reason.

The declaration is the contract: attributes NOT listed are not checked,
so adopting the rule is incremental per class.
"""

from __future__ import annotations

import ast

from ..astutil import ancestors, call_name
from ..core import Checker, FileContext, Finding, register_checker

_DEFAULT_LOCK_NAMES = {"_lock", "_cond", "_mutex"}
_EXEMPT_METHODS = {"__init__", "__del__", "__new__"}
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
_MUTATORS = {"append", "add", "update", "pop", "popleft", "setdefault",
             "clear", "extend", "remove", "insert", "discard",
             "appendleft"}
_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.DictComp,
                     ast.ListComp, ast.SetComp)
_MUTABLE_CALLS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                  "deque"}


def _self_attr(node: ast.AST, name: str | None = None) -> str | None:
    """attr name if node is ``self.X`` (optionally requiring X==name)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        if name is None or node.attr == name:
            return node.attr
    return None


def _guarded_tuple(cls: ast.ClassDef) -> tuple[set[str], set[str]]:
    """(guarded attr names, accepted lock attr names) or empty sets."""
    guarded: set[str] = set()
    locks: set[str] = set(_DEFAULT_LOCK_NAMES)
    explicit_lock = None
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
            isinstance(stmt.targets[0], ast.Name)
        ):
            target = stmt.targets[0].id
            if target == "_guarded_by_lock" and isinstance(
                stmt.value, (ast.Tuple, ast.List)
            ):
                guarded = {
                    e.value for e in stmt.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                }
            elif target == "_lock_name" and isinstance(
                stmt.value, ast.Constant
            ) and isinstance(stmt.value.value, str):
                explicit_lock = stmt.value.value
    if explicit_lock is not None:
        locks = {explicit_lock}
    return guarded, locks


@register_checker
class LockDisciplineChecker(Checker):
    name = "lock-discipline"
    description = (
        "attrs in a class's _guarded_by_lock tuple only touched under "
        "`with self._lock`; mutable module globals in threaded modules "
        "only mutated under a module-level lock"
    )
    roots = ("package",)

    def check_file(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        parents = ctx.parents
        thread_names = self._thread_ctor_names(ctx.nodes)
        for node in ctx.nodes:
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node, parents))
                out.extend(
                    self._check_thread_owner(ctx, node, thread_names)
                )
        out.extend(self._check_module_globals(ctx, parents))
        return out

    # -- thread ownership requires a declared contract ---------------------

    @staticmethod
    def _thread_ctor_names(nodes) -> tuple[set[str], set[str]]:
        """(bare Thread aliases, threading-module aliases) in scope —
        `from threading import Thread [as T]` and `import threading
        [as t]` must both feed the owner check, or a rename evades the
        very gate built to stop silent opt-outs."""
        bare: set[str] = set()
        modules: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.ImportFrom) and (
                (node.module or "").split(".")[0] == "threading"
            ):
                for a in node.names:
                    if a.name == "Thread":
                        bare.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] == "threading":
                        modules.add(a.asname or a.name.split(".")[0])
        return bare, modules

    def _check_thread_owner(self, ctx, cls: ast.ClassDef,
                            thread_names) -> list[Finding]:
        bare, modules = thread_names
        guarded, _ = _guarded_tuple(cls)
        if guarded:
            return []
        owns = None
        for node in ast.walk(cls):
            if isinstance(node, ast.Call) and (
                (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "Thread"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in modules
                )
                or (
                    isinstance(node.func, ast.Name)
                    and node.func.id in bare
                )
            ):
                owns = "constructs threading.Thread"
                break
            if isinstance(node, ast.FunctionDef) and node.name == "__init__":
                if any(a.arg == "thread" for a in node.args.args):
                    owns = "is handed a thread in __init__"
        if owns is None:
            return []
        return [self.finding(
            ctx, cls.lineno,
            f"class {cls.name} {owns} but declares no _guarded_by_lock "
            "contract — thread-owning classes must name their shared "
            "state (checked here statically and by `sanitize` at "
            "runtime) or suppress with the reason no lock-guarded "
            "state exists (e.g. queue/event channels only)",
        )]

    # -- class attribute discipline ---------------------------------------

    def _check_class(self, ctx, cls: ast.ClassDef, parents) -> list[Finding]:
        guarded, locks = _guarded_tuple(cls)
        if not guarded:
            return []
        out = []
        for node in ast.walk(cls):
            attr = _self_attr(node)
            if attr is None or attr not in guarded:
                continue
            chain = list(ancestors(node, parents))
            # Innermost enclosing function decides the exemption; a
            # nested class would re-declare its own contract.
            method = next(
                (
                    a for a in chain
                    if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                ),
                None,
            )
            if method is None or method.name in _EXEMPT_METHODS:
                continue
            if self._under_self_lock(chain, locks):
                continue
            lock_disp = (
                sorted(locks)[0] if len(locks) == 1
                else "|".join(sorted(locks))
            )
            out.append(self.finding(
                ctx, node.lineno,
                f"'{attr}' is declared in {cls.name}._guarded_by_lock but "
                f"accessed outside `with self.{lock_disp}` in "
                f"{method.name}() — check-then-act races under "
                "concurrency; hold the lock",
            ))
        return out

    def _under_self_lock(self, chain, locks: set[str]) -> bool:
        for a in chain:
            if isinstance(a, ast.With):
                for item in a.items:
                    expr = item.context_expr
                    # `with self._lock:` or `with self._cond:` —
                    # Condition is a lock too.
                    if any(_self_attr(expr, lk) for lk in locks):
                        return True
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False  # don't inherit a with from an outer scope
        return False

    # -- module-global discipline -----------------------------------------

    def _check_module_globals(self, ctx, parents) -> list[Finding]:
        tree = ctx.tree
        imports_threading = any(
            (isinstance(n, ast.Import) and any(
                a.name.split(".")[0] == "threading" for a in n.names
            )) or (
                isinstance(n, ast.ImportFrom)
                and (n.module or "").split(".")[0] == "threading"
            )
            for n in ctx.nodes
        )
        if not imports_threading:
            return []
        mutable_globals: set[str] = set()
        module_locks: set[str] = set()
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
                isinstance(stmt.targets[0], ast.Name)
            ):
                name, value = stmt.targets[0].id, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ) and stmt.value is not None:
                name, value = stmt.target.id, stmt.value
            else:
                continue
            if isinstance(value, _MUTABLE_LITERALS) or (
                isinstance(value, ast.Call)
                and call_name(value) in _MUTABLE_CALLS
            ):
                mutable_globals.add(name)
            elif isinstance(value, ast.Call) and (
                call_name(value) in _LOCK_FACTORIES
            ):
                module_locks.add(name)
        if not mutable_globals:
            return []

        out = []
        for node in ctx.nodes:
            gname = self._global_mutation(node, mutable_globals)
            if gname is None:
                continue
            chain = list(ancestors(node, parents))
            in_function = any(
                isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                for a in chain
            )
            if not in_function:
                continue  # module import time is single-threaded
            if self._under_module_lock(chain, module_locks):
                continue
            hint = (
                f"hold `with {sorted(module_locks)[0]}:`"
                if module_locks else
                "add a module-level threading.Lock() and hold it"
            )
            out.append(self.finding(
                ctx, node.lineno,
                f"module global '{gname}' (mutable) mutated without a "
                f"lock in a threading module — {hint}; thread entry "
                "points reach this state concurrently",
            ))
        return out

    def _global_mutation(self, node: ast.AST,
                         names: set[str]) -> str | None:
        # g[k] = v  /  del g[k]  /  g[k] += v
        if isinstance(node, ast.Subscript) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ) and isinstance(node.value, ast.Name) and node.value.id in names:
            return node.value.id
        # g.append(...) and friends
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in names
        ):
            return node.func.value.id
        return None

    def _under_module_lock(self, chain, locks: set[str]) -> bool:
        for a in chain:
            if isinstance(a, ast.With):
                for item in a.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Name) and expr.id in locks:
                        return True
        return False
