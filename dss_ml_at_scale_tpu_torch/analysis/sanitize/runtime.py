"""Lock/thread interposition and dynamic guarded-by enforcement.

Port of ``dss_ml_at_scale_tpu/analysis/sanitize/runtime.py``; the
mechanism is the same, its caller filter is the port package.

The mechanism, end to end:

- :func:`sanitize_scope` (re-entrant; an inner scope joins the outer
  arming) patches the four creation points on the ``threading`` module
  — ``Lock``, ``RLock``, ``Condition``, ``Thread``. Each patched
  factory inspects its *caller's module*: only creations from an
  instrumented prefix (``dss_ml_at_scale_tpu_torch.`` by default) return
  wrapped objects, so stdlib internals (``queue``, ``Event``,
  ``socketserver``) and third-party code keep raw primitives and the
  graph stays signal, not noise. torch's own Python locks and threads
  (and the CUDA caching allocator, whose locks live in C++) stay raw
  the same way. Module-level locks created at import
  time (before arming) stay raw too — instrumentation covers objects
  *constructed while armed*, which is why workloads build their
  subsystems inside the scope.
- Every wrapped lock knows its creation site and stack. ``acquire``
  pushes onto a per-thread held list and, for each lock already held,
  records a directed edge ``held-site → acquired-site`` with both
  acquisition stacks (first occurrence wins; reentrant acquires add no
  edges). Cycle detection over the site graph runs at report time.
- Arming also installs data descriptors over the attributes named in
  each instrumented class's ``_guarded_by_lock`` tuple. A read/write
  off the declaring lock is a finding when another *live* thread has
  acquired that lock (or holds it right now) — construction and
  post-join teardown, where the object is effectively single-threaded,
  stay silent. Disarming restores the original class attributes.

Everything here uses the RAW primitives captured at import time; the
sanitizer's one internal lock is always innermost, so the
instrumentation cannot itself deadlock the workload.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Callable, Iterator

# Raw originals, captured before any arming can patch them.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_REAL_THREAD = threading.Thread

_DEFAULT_PREFIXES = ("dss_ml_at_scale_tpu_torch.",)
_DEFAULT_LOCK_ATTRS = ("_lock", "_cond", "_mutex")

_STACK_LIMIT = 16


class Frame(tuple):
    """(filename, lineno, funcname) — one captured stack frame."""

    __slots__ = ()

    @property
    def filename(self) -> str:
        return self[0]

    @property
    def lineno(self) -> int:
        return self[1]

    @property
    def funcname(self) -> str:
        return self[2]


def _capture_stack() -> tuple[Frame, ...]:
    """Cheap stack capture: (file, line, func) triples, innermost first,
    excluding the sanitizer's own frames. No line-text lookup here —
    report time resolves source text via linecache."""
    frames: list[Frame] = []
    f = sys._getframe(1)
    here = __file__
    while f is not None and len(frames) < _STACK_LIMIT:
        fname = f.f_code.co_filename
        if fname != here:
            frames.append(Frame((fname, f.f_lineno, f.f_code.co_name)))
        f = f.f_back
    return tuple(frames)


def _caller_module() -> str:
    """__name__ of the nearest frame outside this module."""
    f = sys._getframe(1)
    here = __file__
    while f is not None:
        if f.f_code.co_filename != here:
            return f.f_globals.get("__name__", "") or ""
        f = f.f_back
    return ""


class LockInfo:
    """Shared bookkeeping of one instrumented lock (or condition)."""

    __slots__ = (
        "kind", "site", "create_stack", "owner", "owner_name",
        "acquire_stack", "owners_ever",
    )

    def __init__(self, kind: str, create_stack: tuple[Frame, ...]):
        self.kind = kind
        # Creation site: the innermost captured frame (the declaring
        # class's __init__ line, typically).
        self.site = create_stack[0] if create_stack else Frame(("?", 0, "?"))
        self.create_stack = create_stack
        self.owner: int | None = None
        self.owner_name: str = ""
        self.acquire_stack: tuple[Frame, ...] = ()
        # ident -> thread name, every thread that ever acquired.
        self.owners_ever: dict[int, str] = {}

    def held_by_current(self) -> bool:
        return self.owner == threading.get_ident()

    def other_live_acquirer(self) -> str | None:
        """Name of another thread that holds this lock now, or has
        acquired it and is still alive — the 'this object is shared
        concurrently' evidence the guarded-by check keys on. Dead
        threads don't count: post-join teardown is single-threaded."""
        me = threading.get_ident()
        owner = self.owner
        if owner is not None and owner != me:
            return self.owner_name or f"ident={owner}"
        for ident, name in list(self.owners_ever.items()):
            if ident == me:
                continue
            try:
                t = threading._active.get(ident)
            except AttributeError:  # exotic interpreter: be conservative
                return name
            if t is not None and t.is_alive():
                return name
        return None


class _Held:
    __slots__ = ("info", "stack", "count")

    def __init__(self, info: LockInfo, stack: tuple[Frame, ...]):
        self.info = info
        self.stack = stack
        self.count = 1


class _State:
    """Process-global sanitizer state. All mutation under ``lock`` (a
    raw lock, always innermost)."""

    def __init__(self):
        self.lock = _REAL_LOCK()
        self.armed = 0
        self.prefixes: tuple[str, ...] = _DEFAULT_PREFIXES
        self.tls = threading.local()
        self.locks: list[LockInfo] = []
        self.threads: list[dict] = []   # {thread, site, stack, name}
        # (site_a, site_b) -> edge record with first-occurrence stacks
        self.edges: dict[tuple, dict] = {}
        # Monotonic edge id: scopes report only cycles that gained an
        # edge on their watch (the whole graph still decides cycles).
        self.edge_seq = 0
        self.guarded_findings: list[dict] = []
        self.guarded_keys: set[tuple] = set()
        self.patched_classes: list[tuple[type, str, object, bool]] = []
        self.scanned_modules: set[str] = set()

    def reset(self) -> None:
        self.locks = []
        self.threads = []
        self.edges = {}
        self.guarded_findings = []
        self.guarded_keys = set()
        self.scanned_modules = set()

    def held_list(self) -> list[_Held]:
        held = getattr(self.tls, "held", None)
        if held is None:
            held = self.tls.held = []
        return held


_STATE = _State()


def is_armed() -> bool:
    return _STATE.armed > 0


def _matches_prefix(module_name: str) -> bool:
    if not module_name:
        return False
    for p in _STATE.prefixes:
        if module_name.startswith(p):
            # Never instrument the sanitizer itself.
            return not module_name.startswith(__package__ or "\0")
    return False


# -- acquire/release bookkeeping ----------------------------------------------


def _note_acquire(info: LockInfo) -> None:
    held = _STATE.held_list()
    for entry in held:
        if entry.info is info:
            entry.count += 1  # reentrant: no edges, no owner churn
            return
    stack = _capture_stack()
    me = threading.get_ident()
    name = threading.current_thread().name
    with _STATE.lock:
        info.owner = me
        info.owner_name = name
        info.acquire_stack = stack
        info.owners_ever[me] = name
        for entry in held:
            a, b = entry.info.site, info.site
            if a == b:
                continue  # same creation site: hierarchy, not an order
            _STATE.edge_seq += 1
            edge = _STATE.edges.get((a, b))
            if edge is None:
                _STATE.edges[(a, b)] = {
                    "held_stack": entry.stack,
                    "acquire_stack": stack,
                    "thread": name,
                    "kinds": (entry.info.kind, info.kind),
                    "count": 1,
                    "seq": _STATE.edge_seq,
                }
            else:
                edge["count"] += 1
                # seq advances on EVERY traversal: a scope owns a cycle
                # it re-exercised, not only one it minted.
                edge["seq"] = _STATE.edge_seq
    held.append(_Held(info, stack))


def _note_release(info: LockInfo) -> None:
    held = _STATE.held_list()
    for i in range(len(held) - 1, -1, -1):
        entry = held[i]
        if entry.info is info:
            entry.count -= 1
            if entry.count == 0:
                del held[i]
                with _STATE.lock:
                    if info.owner == threading.get_ident():
                        info.owner = None
                        info.owner_name = ""
            return
    # Release of a lock this thread never noted (acquired pre-arm or
    # handed across threads): clear ownership defensively.
    with _STATE.lock:
        if info.owner == threading.get_ident():
            info.owner = None


def _suspend_held(info: LockInfo) -> int:
    """Condition.wait drops the lock entirely (all recursion levels):
    mirror that in the held list; returns the count to restore."""
    held = _STATE.held_list()
    for i in range(len(held) - 1, -1, -1):
        if held[i].info is info:
            count = held[i].count
            del held[i]
            with _STATE.lock:
                if info.owner == threading.get_ident():
                    info.owner = None
                    info.owner_name = ""
            return count
    return 0


def _resume_held(info: LockInfo, count: int) -> None:
    if count <= 0:
        return
    me = threading.get_ident()
    name = threading.current_thread().name
    with _STATE.lock:
        info.owner = me
        info.owner_name = name
        info.owners_ever[me] = name
    entry = _Held(info, _capture_stack())
    entry.count = count
    _STATE.held_list().append(entry)


# -- wrappers -----------------------------------------------------------------


class SanitizedLock:
    """Duck-typed ``threading.Lock`` that feeds the order graph."""

    __slots__ = ("_inner", "info")

    def __init__(self, inner, info: LockInfo):
        self._inner = inner
        self.info = info

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self.info)
        return got

    def release(self) -> None:
        _note_release(self.info)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class SanitizedRLock(SanitizedLock):
    """Reentrant variant: bookkeeping counts recursion per thread."""

    __slots__ = ()


class SanitizedCondition:
    """Wraps a real ``Condition`` over a raw lock; acquire/release/wait
    maintain the same bookkeeping a bare lock gets (``wait`` fully
    drops the lock, exactly like the real one)."""

    __slots__ = ("_inner", "info")

    def __init__(self, inner, info: LockInfo):
        self._inner = inner
        self.info = info

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            _note_acquire(self.info)
        return got

    def release(self) -> None:
        _note_release(self.info)
        self._inner.release()

    def __enter__(self):
        self._inner.__enter__()
        _note_acquire(self.info)
        return self

    def __exit__(self, *exc) -> bool:
        _note_release(self.info)
        return self._inner.__exit__(*exc)

    def wait(self, timeout: float | None = None) -> bool:
        saved = _suspend_held(self.info)
        try:
            return self._inner.wait(timeout)
        finally:
            _resume_held(self.info, saved)

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: float | None = None):
        # Reimplemented over self.wait so the bookkeeping sees every
        # drop/reacquire (delegating would bypass the wrapper).
        import time as _time

        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _time.monotonic() + timeout
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    notifyAll = notify_all


def _make_lock_factory(kind: str, real_factory):
    def factory(*args, **kwargs):
        if not is_armed() or not _matches_prefix(_caller_module()):
            return real_factory(*args, **kwargs)
        stack = _capture_stack()
        info = LockInfo(kind, stack)
        if kind == "Condition":
            lock = args[0] if args else kwargs.get("lock")
            if isinstance(lock, SanitizedLock):
                # Share the wrapper's bookkeeping: the condition and
                # the lock are one mutual-exclusion scope.
                info = lock.info
                inner = real_factory(lock._inner)
            else:
                inner = real_factory(lock) if lock is not None \
                    else real_factory()
            wrapped = SanitizedCondition(inner, info)
        elif kind == "RLock":
            wrapped = SanitizedRLock(real_factory(*args, **kwargs), info)
        else:
            wrapped = SanitizedLock(real_factory(*args, **kwargs), info)
        with _STATE.lock:
            _STATE.locks.append(info)
        _scan_module_classes(_caller_module())
        return wrapped

    factory.__name__ = kind
    return factory


class _TrackedThread(_REAL_THREAD):
    """Drop-in ``threading.Thread``: instances created from an
    instrumented module while armed are recorded for the scope-exit
    unjoined check. Everyone else gets stock behavior (it IS a
    Thread, so subclassing and isinstance keep working)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if is_armed():
            if _matches_prefix(_caller_module()):
                stack = _capture_stack()
                with _STATE.lock:
                    _STATE.threads.append({
                        "thread": self,
                        "site": stack[0] if stack else Frame(("?", 0, "?")),
                        "stack": stack,
                        "name": self.name,
                    })


# -- dynamic guarded-by enforcement -------------------------------------------


class _GuardedAttr:
    """Data descriptor interposed over one declared-guarded attribute.

    Storage delegates to whatever the class used before (the slot
    descriptor for ``__slots__`` classes, the instance ``__dict__``
    otherwise), so values written before arming stay visible and
    disarming restores the exact original behavior.
    """

    __slots__ = ("name", "cls_name", "inner", "lock_attrs")

    def __init__(self, name: str, cls_name: str, inner, lock_attrs):
        self.name = name
        self.cls_name = cls_name
        self.inner = inner
        self.lock_attrs = lock_attrs

    def _check(self, obj, mode: str) -> None:
        if not is_armed():
            return
        tls = _STATE.tls
        if getattr(tls, "in_check", False):
            return
        lock = None
        for attr in self.lock_attrs:
            try:
                lock = object.__getattribute__(obj, attr)
            except AttributeError:
                continue
            break
        info = getattr(lock, "info", None)
        if not isinstance(info, LockInfo):
            return  # raw / pre-arm lock: nothing to judge against
        if info.held_by_current():
            return
        tls.in_check = True
        try:
            holder = info.other_live_acquirer()
            if holder is None:
                return  # single-threaded phase (construction, post-join)
            stack = _capture_stack()
            site = stack[0] if stack else Frame(("?", 0, "?"))
            key = (self.cls_name, self.name, site.filename, site.lineno)
            with _STATE.lock:
                if key in _STATE.guarded_keys:
                    return
                _STATE.guarded_keys.add(key)
                _STATE.guarded_findings.append({
                    "cls": self.cls_name,
                    "attr": self.name,
                    "mode": mode,
                    "site": site,
                    "stack": stack,
                    "thread": threading.current_thread().name,
                    "holder": holder,
                    "holder_stack": info.acquire_stack,
                    "lock_site": info.site,
                })
        finally:
            tls.in_check = False

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.inner is not None:
            val = self.inner.__get__(obj, objtype)
        else:
            try:
                val = obj.__dict__[self.name]
            except KeyError:
                raise AttributeError(self.name) from None
        self._check(obj, "read")
        return val

    def __set__(self, obj, value) -> None:
        self._check(obj, "write")
        if self.inner is not None:
            self.inner.__set__(obj, value)
        else:
            obj.__dict__[self.name] = value

    def __delete__(self, obj) -> None:
        self._check(obj, "delete")
        if self.inner is not None:
            self.inner.__delete__(obj)
        else:
            del obj.__dict__[self.name]


def _lock_attrs_for(cls: type) -> tuple[str, ...]:
    explicit = cls.__dict__.get("_lock_name")
    if isinstance(explicit, str):
        return (explicit,)
    return _DEFAULT_LOCK_ATTRS


def _instrument_class(cls: type) -> None:
    guarded = cls.__dict__.get("_guarded_by_lock")
    if not isinstance(guarded, tuple) or not guarded:
        return
    lock_attrs = _lock_attrs_for(cls)
    for attr in guarded:
        current = cls.__dict__.get(attr)
        if isinstance(current, _GuardedAttr):
            continue
        if current is not None and not hasattr(current, "__get__"):
            continue  # a plain class-level value, not instance state
        if current is None and getattr(cls, "__dictoffset__", 0) == 0:
            continue  # no storage we know how to reach
        ga = _GuardedAttr(attr, cls.__qualname__, current, lock_attrs)
        try:
            setattr(cls, attr, ga)
        except (AttributeError, TypeError):
            continue
        _STATE.patched_classes.append((cls, attr, current, current is None))


def _scan_module_classes(module_name: str) -> None:
    """Install guarded descriptors for every ``_guarded_by_lock`` class
    of ``module_name`` — called lazily the first time a module creates
    an instrumented lock, so late imports are covered without an import
    hook."""
    if not module_name or module_name in _STATE.scanned_modules:
        return
    with _STATE.lock:
        if module_name in _STATE.scanned_modules:
            return
        _STATE.scanned_modules.add(module_name)
    mod = sys.modules.get(module_name)
    if mod is None:
        return
    for obj in list(vars(mod).values()):
        if isinstance(obj, type) and obj.__module__ == module_name:
            _instrument_class(obj)


def _scan_all_loaded() -> None:
    for name in list(sys.modules):
        if _matches_prefix(name + "."):
            _scan_module_classes(name)
        elif _matches_prefix(name):
            _scan_module_classes(name)


# -- arming / scopes ----------------------------------------------------------


def _patch_threading() -> None:
    threading.Lock = _make_lock_factory("Lock", _REAL_LOCK)
    threading.RLock = _make_lock_factory("RLock", _REAL_RLOCK)
    threading.Condition = _make_lock_factory("Condition", _REAL_CONDITION)
    threading.Thread = _TrackedThread


def _unpatch_threading() -> None:
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    threading.Thread = _REAL_THREAD


def _uninstrument_classes() -> None:
    for cls, attr, original, was_absent in reversed(_STATE.patched_classes):
        try:
            if was_absent:
                delattr(cls, attr)
            else:
                setattr(cls, attr, original)
        except (AttributeError, TypeError):
            pass
    _STATE.patched_classes = []


class SanitizeScope:
    """One armed region. Nested scopes share the global state; each
    scope's end-of-scope checks cover only what was created inside it
    (watermarks), while the lock-order graph is judged whole — an
    inversion is an inversion no matter which scope saw each half."""

    def __init__(self):
        self._threads_mark = len(_STATE.threads)
        self._locks_mark = len(_STATE.locks)
        self._guarded_mark = len(_STATE.guarded_findings)
        self.edge_seq_mark = _STATE.edge_seq
        self.unjoined: list[dict] = []
        self.leaked: list[dict] = []
        self.finished = False

    # Snapshots for the report builder ------------------------------------

    def guarded_findings(self) -> list[dict]:
        return list(_STATE.guarded_findings[self._guarded_mark:])

    def edges(self) -> dict[tuple, dict]:
        with _STATE.lock:
            return dict(_STATE.edges)

    def lock_count(self) -> int:
        return len(_STATE.locks) - self._locks_mark

    def _finish(self) -> None:
        if self.finished:
            return
        self.finished = True
        for rec in _STATE.threads[self._threads_mark:]:
            t = rec["thread"]
            if t.is_alive():
                self.unjoined.append(dict(rec))
        for info in _STATE.locks[self._locks_mark:]:
            if info.owner is not None:
                self.leaked.append({
                    "site": info.site,
                    "kind": info.kind,
                    "holder": info.owner_name,
                    "stack": info.acquire_stack,
                    "create_stack": info.create_stack,
                })


@contextlib.contextmanager
def sanitize_scope(
    extra_prefixes: tuple[str, ...] = (),
) -> Iterator[SanitizeScope]:
    """Arm the sanitizer for the ``with`` body (re-entrant).

    ``extra_prefixes`` widens the instrumented-caller filter for the
    duration (test fixtures live outside the package). The outermost
    scope resets accumulated state on entry and unpatches on exit.
    """
    with _STATE.lock:
        fresh = _STATE.armed == 0
        _STATE.armed += 1
        if fresh:
            _STATE.reset()
        prev_prefixes = _STATE.prefixes
        if extra_prefixes:
            _STATE.prefixes = tuple(
                dict.fromkeys(_STATE.prefixes + tuple(extra_prefixes))
            )
    if fresh:
        _patch_threading()
    _scan_all_loaded()
    scope = SanitizeScope()
    try:
        yield scope
    finally:
        scope._finish()
        with _STATE.lock:
            _STATE.armed -= 1
            last = _STATE.armed == 0
            # Widening is scoped: a nested fixture scope must not leave
            # its extra prefixes armed for the rest of an outer
            # (session-long) scope. LIFO exit restores exactly the
            # tuple this scope entered with.
            _STATE.prefixes = (
                _DEFAULT_PREFIXES if last else prev_prefixes
            )
        if last:
            _unpatch_threading()
            _uninstrument_classes()
