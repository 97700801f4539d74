"""Entrypoint auditor: recorded-op contracts over the port's real programs.

Port of ``dss_ml_at_scale_tpu/analysis/audit/core.py``. ``lint`` stops
at the Python AST; this tier runs a registry of the port's REAL
entrypoints (the train/eval steps, the health-guarded step, the pipelined
step, the LM decode/slot-decode/prefill, the serving scorer, the fused
ops forward+backward, the batched SARIMAX fit — see :mod:`.entrypoints`)
once each on tiny inputs and audits what they dispatched. Where JAX
lowers a jaxpr on an abstract 8-device mesh, the port records the call
under a ``TorchDispatchMode`` (op, input/output dtypes and shapes) and
``torch.utils.flop_counter``'s FLOP formulas, on torch's ``fake`` process
group at world size 8 (collectives dispatch as ``c10d.*`` ops without
moving a byte), and keeps the hand-written kernels' launch counters
beside the op list (a ctypes launch is not an aten op). The five rules
(:mod:`.rules`):

- **donation**: the tensors JAX donates (params and optimizer state of
  the train steps, the KV cache/arena of the decode programs) are
  updated in place: each keeps its ``data_ptr()`` across the call;
- **dtype-discipline**: no tensor-sized f64/c128 in the recorded ops,
  and the dtype casts stay within the entrypoint's budget;
- **sharding-collectives**: each recorded ``c10d.*`` op (and each DDP
  gradient bucket, through the audit's own comm hook) moves no more
  bytes than JAX's per-collective ceilings;
- **host-interop**: no ``aten._local_scalar_dense``, ``aten.nonzero`` or
  device→host copy inside a hotpath entrypoint; on a card the recorded
  call also runs under ``torch.cuda.set_sync_debug_mode("error")`` (or
  under ``"warn"``, counting the synchronizing calls, for an entrypoint
  that declares its syncs);
- **program-baseline**: a content hash of the recorded op sequence plus
  FLOP/byte budgets, committed in the port's
  ``analysis/baselines/audit.json`` per device. The hash is pinned to
  torch's ``major.minor`` (decompositions differ between releases): one
  from another version is reported as unpinned, not as a failure. The
  budgets are checked wherever the device has a record.

Each entrypoint runs its warm-up calls (lazy optimizer state, kernel
builds, first-use allocations, DDP's bucket rebuild) and then the
recorded call, so the record is the steady state. The framework mirrors :mod:`..core`: per-entrypoint
suppressions with MANDATORY reasons (declared in the registry), baseline
add/expire/reopen semantics, text/JSON renderers (schema ``version`` 1),
and exit codes 0/1/2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping, Sequence

from ..core import BASELINE_DIR, Finding, LintUsageError

DEFAULT_AUDIT_BASELINE = BASELINE_DIR / "audit.json"
AUDIT_SCHEMA_VERSION = 1
AUDIT_WORLD_SIZE = 8

# Fraction by which flops/bytes may exceed their committed budget before
# the program-baseline rule calls it a regression.
COST_TOLERANCE = 0.05

# Memory addresses in reprs churn per process; scrub them so the program
# hash is stable across runs of the same code.
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")

# Factory ops allocate; they move no data and count as no bytes.
_ALLOC_OPS = {"aten.empty", "aten.empty_strided", "aten.empty_like",
              "aten.new_empty", "aten.new_empty_strided"}


class AuditUsageError(LintUsageError):
    """Bad invocation (unknown entrypoint/rule, missing --reason): exit 2."""


@dataclasses.dataclass(frozen=True)
class AuditFinding(Finding):
    """One audit diagnostic. ``path`` holds the entrypoint name and
    ``ident`` the stable within-entrypoint identity the baseline key
    hashes (so message rewording never churns the baseline)."""

    ident: str = ""

    def text(self) -> str:
        return f"{self.path}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        out = super().to_json()
        out["entrypoint"] = self.path
        out["ident"] = self.ident
        return out


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registered entrypoint, built and ready to run.

    ``fn(*args)`` is the REAL production callable (not a test twin) on
    tiny inputs already on the audit device. ``donated`` returns the
    named tensors that must be updated in place (JAX's donated buffers),
    read before and after the recorded call. ``launches`` names the
    hand-written kernels' launch counters to read around the call
    (``name -> callable returning the count``). ``suppress`` maps a rule
    name (the whole rule) or one finding's ``rule:ident`` -> mandatory
    reason for per-entrypoint suppressions.
    """

    name: str
    fn: Callable
    args: tuple = ()
    donated: Callable[[], Mapping[str, Any]] | None = None
    # Tensors the program keeps on the host by design (Adam's step
    # counters, which torch keeps on the CPU unless ``capturable``): a
    # scalar read of one is no device sync.
    host_state: Callable[[], Sequence[Any]] | None = None
    hotpath: bool = True
    # dtype-discipline: tolerated dtype casts in the recorded call.
    cast_budget: int = 8
    # Calls before the recorded one, so that it is the steady state.
    warmup: int = 1
    # The sync-debug mode of the recorded call of a hotpath entrypoint on
    # a card: "error" stops the call at its first synchronizing CUDA call;
    # "warn" lets it run and counts them (an entrypoint that syncs by
    # design, the count pinned by a ``rule:ident`` suppression).
    sync_debug: str = "error"
    launches: Mapping[str, Callable[[], int]] = dataclasses.field(
        default_factory=dict)
    suppress: Mapping[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten/c10d op of the recorded call."""

    name: str
    inputs: tuple    # ((dtype, shape, device_type), ...)
    outputs: tuple   # ((dtype, shape, device_type), ...)
    is_view: bool
    # The storage a scalar read (``aten._local_scalar_dense``) read.
    read_ptr: int | None = None

    def signature(self) -> str:
        def fmt(ts):
            return ",".join(f"{d}{list(s)}" for d, s, _ in ts)
        return f"{self.name}({fmt(self.inputs)})->{fmt(self.outputs)}"


def _tensor_meta(x) -> tuple | None:
    import torch

    if isinstance(x, torch.Tensor):
        return (str(x.dtype).replace("torch.", ""), tuple(x.shape),
                x.device.type)
    return None


def _flat_metas(obj) -> tuple:
    """Metas of every tensor in nested lists/tuples/dicts, in order."""
    import torch

    out: list = []

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            out.append(_tensor_meta(x))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(obj)
    return tuple(out)


def _recorder_class():
    """A ``TorchDispatchMode`` recording (op, metas) and counting FLOPs
    with ``torch.utils.flop_counter``'s formulas — built lazily, so
    importing this module imports no torch internals. (``FlopCounterMode``
    itself also tracks modules through hooks that a recompute inside an
    autograd ``Function``'s backward trips; its per-op formulas are the
    same.)"""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: list[OpRecord] = []
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            packet = getattr(func, "overloadpacket", func)
            count = flop_registry.get(packet)
            if count is None and getattr(func, "_can_decompose", bool)():
                # A composite op (``aten.matmul`` under inference mode)
                # reaches the mode whole: record its parts, as
                # FlopCounterMode counts them.
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            host = None
            if str(packet) == "aten._local_scalar_dense" and args:
                host = args[0].data_ptr()
            self.ops.append(OpRecord(
                name=str(packet),
                inputs=_flat_metas((args, kwargs)),
                outputs=_flat_metas(out),
                is_view=bool(getattr(func, "is_view", False)),
                read_ptr=host,
            ))
            return out

    return _Recorder


class _SyncError(Exception):
    """The recorded call synchronized the host under sync-debug "error"."""


class EntrypointContext:
    """Everything rules need about ONE entrypoint, computed at most once:
    the warm-up call, then the recorded call (ops, FLOPs, donated
    pointers, kernel launches, collective bytes). A failure in any stage
    is captured as ``trace_error`` — the runner reports it as a finding
    instead of aborting the whole audit."""

    def __init__(self, spec: ProgramSpec, device: str, world):
        self.spec = spec
        self.device = device
        self.world = world
        self.name = spec.name
        self.ops: list[OpRecord] = []
        self.flops: float | None = None
        self.launches: dict[str, int] = {}
        self.donated_before: dict[str, int] = {}
        self.donated_after: dict[str, int | None] = {}
        self.bucket_bytes: list[int] = []
        self.sync_mode: str | None = None
        self.sync_error: str | None = None
        self.syncs: int | None = None
        # Kernel launches of the warm-up and recorded calls together.
        self.launches_total: dict[str, int] = {}
        self.host_ptrs: set[int] = set()
        self.trace_error: str | None = None
        self.baseline_programs: dict = {}
        self._done = False

    def run(self) -> None:
        if self._done:
            if self.trace_error:
                raise _TraceFailed(self.name, self.trace_error)
            return
        self._done = True
        try:
            counters = {k: f() for k, f in self.spec.launches.items()}
            for _ in range(self.spec.warmup):
                self.spec.fn(*self.spec.args)
            self._sync()
            if self.spec.hotpath and self.device.startswith("cuda"):
                self.sync_mode = self.spec.sync_debug
            try:
                self._record(self.sync_mode)
            except _SyncError as e:
                self.sync_error = str(e)
                self._record(None)
            self.launches_total = {k: f() - counters[k]
                                   for k, f in self.spec.launches.items()}
        except Exception as e:  # noqa: BLE001 - reported as a finding
            self.trace_error = f"run: {type(e).__name__}: {e}"
            raise _TraceFailed(self.name, self.trace_error) from e

    def _sync(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def _record(self, sync_debug: str | None) -> None:
        import warnings

        import torch

        donated = self.spec.donated
        self.donated_before = ({k: v.data_ptr() for k, v in donated().items()}
                               if donated is not None else {})
        counters = {k: f() for k, f in self.spec.launches.items()}
        self.world.buckets.clear()
        self.host_ptrs = ({t.data_ptr() for t in self.spec.host_state()}
                          if self.spec.host_state is not None else set())
        rec = _recorder_class()()
        watch = (warnings.catch_warnings(record=True) if sync_debug == "warn"
                 else contextlib.nullcontext([]))
        with rec, watch as caught:
            if sync_debug == "warn":
                warnings.simplefilter("always")
            if sync_debug:
                torch.cuda.set_sync_debug_mode(sync_debug)
            try:
                self.spec.fn(*self.spec.args)
            except RuntimeError as e:
                if sync_debug == "error" and "synchroniz" in str(e):
                    raise _SyncError(str(e).splitlines()[0]) from e
                raise
            finally:
                if sync_debug:
                    torch.cuda.set_sync_debug_mode(0)
        self.syncs = (sum("synchroniz" in str(w.message) for w in caught)
                      if sync_debug == "warn" else None)
        self._sync()
        self.ops = rec.ops
        self.flops = float(rec.flops)
        self.launches = {k: f() - counters[k]
                         for k, f in self.spec.launches.items()}
        self.bucket_bytes = list(self.world.buckets)
        self.donated_after = {}
        if donated is not None:
            after = donated()
            self.donated_after = {
                k: (after[k].data_ptr() if k in after else None)
                for k in self.donated_before
            }

    @property
    def bytes(self) -> float:
        """Bytes the recorded call's ops wrote: the outputs of every
        non-view, non-allocating op."""
        total = 0
        for op in self.ops:
            if op.is_view or op.name in _ALLOC_OPS:
                continue
            for dtype, shape, _ in op.outputs:
                n = 1
                for d in shape:
                    n *= d
                total += n * _itemsize(dtype)
        return float(total)

    def program_hash(self) -> str:
        """Content-addressed identity of the recorded program: the op
        sequence with its dtypes and shapes (addresses scrubbed), plus the
        kernels launched. Stable across runs of the same code on one torch
        release and device; any semantic edit reopens it."""
        self.run()
        body = "\n".join(_ADDR_RE.sub("0x", op.signature()) for op in self.ops)
        launches = ",".join(f"{k}={v}" for k, v in sorted(self.launches.items()))
        return hashlib.blake2s((body + "\n" + launches).encode(),
                               digest_size=10).hexdigest()


def _itemsize(dtype: str) -> int:
    import torch

    try:
        return getattr(torch, dtype).itemsize
    except AttributeError:
        return 4


class _TraceFailed(Exception):
    """Internal: one entrypoint's run failed; the runner turns it into a
    ``trace-error`` finding and moves on."""

    def __init__(self, name: str, detail: str):
        super().__init__(f"{name}: {detail}")
        self.name = name
        self.detail = detail


# -- the audit world: torch's fake process group ------------------------------


class AuditWorld:
    """The fake process group of the audit (world size 8, this process
    rank 0) and the comm hook the data-parallel entrypoints register on
    their DDP wrapper: DDP's reducer cannot run on the fake group (its
    hook result is None), so the hook records each gradient bucket's
    bytes and returns the bucket as a completed future."""

    def __init__(self, world_size: int = AUDIT_WORLD_SIZE):
        self.world_size = world_size
        self.buckets: list[int] = []

    def comm_hook(self, state, bucket):
        import torch

        buf = bucket.buffer()
        self.buckets.append(buf.numel() * buf.element_size())
        fut = torch.futures.Future()
        fut.set_result(buf)
        return fut

    def attach(self, ddp) -> None:
        ddp.register_comm_hook(None, self.comm_hook)


@contextlib.contextmanager
def audit_world(world_size: int = AUDIT_WORLD_SIZE):
    """Join torch's ``fake`` process group for the audit, and leave it
    after. A process already in a group is refused: the audit's world must
    not mix with a real one."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise AuditUsageError(
            "audit runs on its own fake process group; this process is "
            "already in one")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield AuditWorld(world_size)
    finally:
        dist.destroy_process_group()


# -- rules -------------------------------------------------------------------


class AuditRule:
    """Base audit rule: one pass over a shared :class:`EntrypointContext`."""

    name: str = ""
    description: str = ""

    def check(self, ctx: EntrypointContext) -> Iterable[AuditFinding]:
        raise NotImplementedError

    def finding(self, ctx: EntrypointContext, ident: str,
                message: str) -> AuditFinding:
        return AuditFinding(
            rule=self.name, path=ctx.name, line=0, message=message,
            ident=ident,
        )


_RULES: dict[str, type[AuditRule]] = {}


def register_rule(cls: type[AuditRule]) -> type[AuditRule]:
    if not cls.name:
        raise ValueError(f"audit rule {cls.__name__} has no name")
    if cls.name in _RULES:
        raise ValueError(f"duplicate audit rule {cls.name!r}")
    _RULES[cls.name] = cls
    return cls


def rule_names() -> list[str]:
    _load_rules()
    return sorted(_RULES)


def rule_catalog() -> list[tuple[str, str]]:
    _load_rules()
    return [(n, _RULES[n].description) for n in sorted(_RULES)]


def _load_rules() -> None:
    from . import rules  # noqa: F401 - import registers the classes


# -- keys and baseline -------------------------------------------------------


def _finding_keys(findings: list[AuditFinding]) -> list[AuditFinding]:
    """Content-addressed keys over (rule, entrypoint, ident, occurrence):
    editing the PROGRAM re-opens findings, editing diagnostics prose does
    not."""
    seen: dict[tuple[str, str, str], int] = {}
    out = []
    for f in findings:
        ident = f.ident or f.message
        trip = (f.rule, f.path, ident)
        n = seen.get(trip, 0)
        seen[trip] = n + 1
        digest = hashlib.blake2s(
            f"{f.rule}\0{f.path}\0{ident}\0{n}".encode(), digest_size=8
        ).hexdigest()
        out.append(dataclasses.replace(f, key=f"{f.rule}:{digest}"))
    return out


def load_audit_baseline(path: Path) -> dict:
    """{"entries": {...}, "programs": {...}} (both possibly empty).
    ``programs`` maps entrypoint -> device type -> pin record."""
    if not path.exists():
        return {"entries": {}, "programs": {}}
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        raise AuditUsageError(f"baseline {path} is not valid JSON: {e}")
    if not isinstance(data, dict):
        raise AuditUsageError(f"baseline {path}: top level must be an object")
    entries = data.get("entries", {})
    programs = data.get("programs", {})
    if not isinstance(entries, dict) or not isinstance(programs, dict):
        raise AuditUsageError(
            f"baseline {path}: 'entries' and 'programs' must be objects"
        )
    return {"entries": entries, "programs": programs}


def write_audit_baseline(
    path: Path,
    result: "AuditResult",
    old: dict,
    new_reason: str | None,
) -> int:
    """Rewrite the baseline: this run's device gets the CURRENT pins
    (hash, torch release, costs; keeping an authored reason where one
    exists), other devices' pins are kept, accepted findings keep old
    reasons or take ``new_reason`` (required for new keys), stale keys
    don't survive."""
    old_entries = old.get("entries", {})
    old_programs = old.get("programs", {})
    entries: dict[str, dict] = {}
    added = 0
    broken = sorted({
        f.path for f in result.findings + result.baselined
        if f.rule == "trace-error"
    })
    if broken:
        raise AuditUsageError(
            "refusing --update-baseline: trace errors on "
            f"{', '.join(broken)} — their program pins would be "
            "dropped from the baseline; fix the registry first"
        )
    acceptable = [
        f for f in result.findings + result.baselined
        if f.rule not in ("program-baseline", "trace-error")
    ]
    for f in sorted(acceptable, key=lambda f: (f.path, f.rule, f.ident)):
        prev = old_entries.get(f.key)
        if prev is not None and str(prev.get("reason", "")).strip():
            reason = prev["reason"]
        else:
            if not (new_reason and new_reason.strip()):
                raise AuditUsageError(
                    f"new finding {f.key} ({f.path}) needs --reason TEXT "
                    "to enter the audit baseline"
                )
            reason = new_reason.strip()
            added += 1
        entries[f.key] = {
            "reason": reason,
            "rule": f.rule,
            "entrypoint": f.path,
            "ident": f.ident,
            "message": f.message,
        }
    programs: dict[str, dict] = {}
    for name, prog in sorted(result.programs.items()):
        devices = dict(old_programs.get(name, {}))
        prev = devices.get(result.device, {})
        rec = {
            "hash": prog["hash"],
            "torch": prog["torch"],
            "flops": prog.get("flops"),
            "bytes": prog.get("bytes"),
        }
        if str(prev.get("reason", "")).strip():
            rec["reason"] = prev["reason"]
        devices[result.device] = rec
        programs[name] = devices
    payload = {
        "_comment": (
            "audit baseline of the port. 'programs' pins each registry "
            "entrypoint's recorded program per device (op-sequence hash, "
            "torch major.minor, FLOPs and bytes budgets) — a hash change "
            "on the same torch release or a cost regression beyond "
            "tolerance fails the audit until `audit --update-baseline "
            "--reason '...'` re-pins it. 'entries' are accepted findings, "
            "each with a mandatory reason; entries whose finding "
            "disappeared go stale and FAIL the audit."
        ),
        "version": AUDIT_SCHEMA_VERSION,
        "programs": programs,
        "entries": entries,
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n",
                    encoding="utf-8")
    return added


# -- the runner --------------------------------------------------------------


@dataclasses.dataclass
class AuditResult:
    rules: list[str]
    entrypoints: list[str]
    findings: list[AuditFinding]          # active
    baselined: list[AuditFinding]
    suppressed: list[AuditFinding]
    stale_baseline: list[dict]
    programs: dict[str, dict]             # name -> {hash, flops, bytes, ...}
    device: str = "cpu"

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_baseline

    @property
    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def render_text(self) -> str:
        lines = [f.text() for f in self.findings]
        for entry in self.stale_baseline:
            what = entry.get("kind", "entry")
            lines.append(
                f"{entry.get('entrypoint', '?')}: [baseline] stale "
                f"{what} {entry['key']} — no longer produced; "
                "regenerate (audit --update-baseline)"
            )
        for name in sorted(self.programs):
            prog = self.programs[name]
            launched = ", ".join(f"{k}={v}" for k, v in
                                 sorted(prog.get("launches", {}).items()))
            lines.append(
                f"  {name}: hash {prog['hash']} ({prog['pin']}) "
                f"ops={prog['ops']} flops={prog['flops']:.4g} "
                f"bytes={prog['bytes']:.4g}"
                + (f" launches: {launched}" if launched else "")
            )
        lines.append(
            f"{len(self.findings)} finding(s), "
            f"{len(self.baselined)} baselined, "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.stale_baseline)} stale baseline entr(y/ies) "
            f"[{len(self.entrypoints)} entrypoint(s) on {self.device}; "
            f"rules: {', '.join(self.rules)}]"
        )
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "version": AUDIT_SCHEMA_VERSION,
            "device": self.device,
            "rules": self.rules,
            "entrypoints": self.entrypoints,
            "counts": {
                "active": len(self.findings),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "stale_baseline": len(self.stale_baseline),
            },
            "ok": self.ok,
            "findings": [f.to_json() for f in self.findings],
            "baselined": [f.to_json() for f in self.baselined],
            "suppressed": [f.to_json() for f in self.suppressed],
            "stale_baseline": self.stale_baseline,
            "programs": self.programs,
        }, indent=2)


def torch_release() -> str:
    """``major.minor`` of the running torch: what a program hash is
    pinned to."""
    import torch

    return ".".join(torch.__version__.split("+")[0].split(".")[:2])


def run_audit(
    entrypoints: Sequence[str] | None = None,
    *,
    rules: Sequence[str] | None = None,
    baseline_path: Path | None = None,
    device: str = "cpu",
    specs: Mapping[str, Callable] | None = None,
) -> AuditResult:
    """Run the audit; the single entry point the CLI and the tests share.

    ``entrypoints``/``rules`` select subsets. ``specs`` overrides the
    registry entirely (fixture tests inject synthetic entrypoints); each
    value is a ``build(device, world) -> ProgramSpec`` callable. Baseline
    staleness is judged only against the selected entrypoints and rules.
    """
    _load_rules()
    from . import entrypoints as registry

    builders = dict(specs) if specs is not None else registry.builders()
    names = list(entrypoints) if entrypoints else sorted(builders)
    unknown = [n for n in names if n not in builders]
    if unknown:
        raise AuditUsageError(
            f"unknown entrypoint(s) {', '.join(sorted(unknown))}; "
            f"known: {', '.join(sorted(builders))}"
        )
    rule_list = list(rules) if rules else sorted(_RULES)
    unknown = [n for n in rule_list if n not in _RULES]
    if unknown:
        raise AuditUsageError(
            f"unknown audit rule(s) {', '.join(sorted(unknown))}; "
            f"known: {', '.join(sorted(_RULES))}"
        )
    checkers = [_RULES[n]() for n in rule_list]

    from ... import telemetry

    entrypoints_total = telemetry.counter(
        "audit_entrypoints_total", "entrypoints traced by the audit"
    )
    findings_total = telemetry.counter(
        "audit_findings_total", "active findings reported by the audit"
    )

    bl_path = (
        DEFAULT_AUDIT_BASELINE if baseline_path is None else baseline_path
    )
    baseline = load_audit_baseline(bl_path)
    entries = baseline["entries"]
    bl_programs = baseline["programs"]
    dev_type = device.split(":")[0]

    raw: list[AuditFinding] = []
    suppressed: list[AuditFinding] = []
    programs: dict[str, dict] = {}
    audited: list[str] = []
    import torch

    # Each entrypoint is built from seed 0; the caller's generators are
    # put back after.
    rng_devices = [torch.device(device).index or 0] if dev_type == "cuda" else []
    with torch.random.fork_rng(devices=rng_devices), audit_world() as world:
        for name in names:
            torch.manual_seed(0)
            try:
                spec = builders[name](device, world)
            except Exception as e:  # noqa: BLE001 - builder bugs are findings
                raw.append(AuditFinding(
                    rule="trace-error", path=name, line=0, ident="build",
                    message=f"entrypoint builder failed: "
                            f"{type(e).__name__}: {e}",
                ))
                continue
            _validate_suppressions(spec)
            ctx = EntrypointContext(spec, device, world)
            ctx.baseline_programs = bl_programs
            audited.append(name)
            try:
                ctx.run()
            except _TraceFailed as e:
                raw.append(AuditFinding(
                    rule="trace-error", path=name, line=0, ident="run",
                    message=f"could not run the entrypoint: {e.detail}",
                ))
                continue
            for checker in checkers:
                for f in checker.check(ctx):
                    if (spec.suppress.get(f.rule)
                            or spec.suppress.get(f"{f.rule}:{f.ident}")):
                        suppressed.append(f)
                    else:
                        raw.append(f)
            rec = bl_programs.get(name, {}).get(dev_type)
            current = ctx.program_hash()
            pinned = (rec is not None and rec.get("torch") == torch_release())
            programs[name] = {
                "hash": current,
                "torch": torch_release(),
                "pin": ("pinned" if pinned and rec.get("hash") == current
                        else "changed" if pinned
                        else f"unpinned on {dev_type} torch {torch_release()}"),
                "ops": len(ctx.ops),
                "flops": ctx.flops,
                "bytes": ctx.bytes,
                "launches": ctx.launches,
                "launches_total": ctx.launches_total,
                "sync_debug": ctx.sync_mode,
                "sync_error": ctx.sync_error,
                "syncs": ctx.syncs,
            }

    keyed = _finding_keys(raw)

    active: list[AuditFinding] = []
    baselined: list[AuditFinding] = []
    matched: set[str] = set()
    for f in keyed:
        entry = entries.get(f.key)
        if entry is not None and str(entry.get("reason", "")).strip():
            baselined.append(f)
            matched.add(f.key)
        else:
            active.append(f)

    rule_set = set(rule_list) | {"trace-error"}
    ep_set = set(names)
    stale = [
        {"key": k, "kind": "entry", **entry}
        for k, entry in sorted(entries.items())
        if k not in matched
        and entry.get("rule") in rule_set
        and entry.get("entrypoint") in ep_set
    ]
    # A baselined program whose entrypoint left the registry is stale
    # ballast exactly like a fixed lint finding.
    if specs is None and not entrypoints:
        stale.extend(
            {"key": f"program:{name}", "kind": "program",
             "entrypoint": name}
            for name in sorted(bl_programs)
            if name not in builders
        )

    active.sort(key=lambda f: (f.path, f.rule, f.ident))
    entrypoints_total.inc(len(audited))
    findings_total.inc(len(active))
    return AuditResult(
        rules=rule_list,
        entrypoints=names,
        findings=active,
        baselined=baselined,
        suppressed=suppressed,
        stale_baseline=stale,
        programs=programs,
        device=dev_type,
    )


def _validate_suppressions(spec: ProgramSpec) -> None:
    for rule, reason in spec.suppress.items():
        if not str(reason).strip():
            raise AuditUsageError(
                f"entrypoint {spec.name}: suppression for rule "
                f"{rule!r} has no reason — every silenced diagnostic "
                "carries its audit trail in the registry"
            )
