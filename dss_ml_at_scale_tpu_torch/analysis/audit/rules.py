"""The five rules of ``audit``, in their torch meaning.

Port of ``dss_ml_at_scale_tpu/analysis/audit/rules.py``. Each rule reads
the shared :class:`~.core.EntrypointContext` — one warm-up and one
recorded call per entrypoint no matter how many rules run — and emits
:class:`~.core.AuditFinding`s whose ``ident`` is chosen to be stable
under message rewording (the baseline keys hash idents, not prose).
"""

from __future__ import annotations

import math
from typing import Iterable

from .core import (
    COST_TOLERANCE,
    AuditFinding,
    AuditRule,
    EntrypointContext,
    register_rule,
    torch_release,
)

# -- donation -----------------------------------------------------------------


@register_rule
class DonationRule(AuditRule):
    name = "donation"
    description = (
        "torch: the tensors JAX donates (params + optimizer state of the "
        "train steps, the KV cache/arena of decode) are updated in place — "
        "each keeps its data_ptr() across a call; a fresh tensor each step "
        "doubles their peak memory"
    )

    def check(self, ctx: EntrypointContext) -> Iterable[AuditFinding]:
        for key, before in sorted(ctx.donated_before.items()):
            after = ctx.donated_after.get(key)
            if after is None:
                yield self.finding(
                    ctx, f"gone:{key}",
                    f"donated tensor {key} is gone after the call — the "
                    "state was rebuilt instead of updated in place",
                )
            elif after != before:
                yield self.finding(
                    ctx, f"moved:{key}",
                    f"donated tensor {key} has new storage after the call "
                    "— the step allocated a replacement instead of "
                    "updating it in place",
                )


# -- dtype discipline ---------------------------------------------------------

_WIDE = {"float64", "complex128"}
_CAST_OPS = {"aten._to_copy", "aten.to", "aten._to_copy_"}


@register_rule
class DtypeDisciplineRule(AuditRule):
    name = "dtype-discipline"
    description = (
        "torch: no tensor-sized float64/complex128 produced by a recorded "
        "op (a silent promotion doubles bytes), and the dtype casts "
        "(aten._to_copy changing dtype) stay within the entrypoint's budget"
    )

    def check(self, ctx: EntrypointContext) -> Iterable[AuditFinding]:
        seen: dict[tuple[str, str, tuple], int] = {}
        casts = 0
        for op in ctx.ops:
            for dtype, shape, _ in op.outputs:
                if dtype in _WIDE and math.prod(shape) > 1:
                    key = (op.name, dtype, shape)
                    seen[key] = seen.get(key, 0) + 1
            if (op.name in _CAST_OPS and op.inputs and op.outputs
                    and op.inputs[0][0] != op.outputs[0][0]):
                casts += 1
        for (name, dtype, shape), count in sorted(seen.items()):
            yield self.finding(
                ctx, f"wide:{name}:{dtype}:{list(shape)}",
                f"{name} produces tensor-sized {dtype}{list(shape)} "
                f"({count}x) — a wide-float promotion that doubles bytes; "
                "pin the dtype explicitly",
            )
        budget = ctx.spec.cast_budget
        if casts > budget:
            yield self.finding(
                ctx, "cast-churn",
                f"{casts} dtype casts in the recorded call (budget "
                f"{budget}) — cast once outside the step, or raise the "
                "entrypoint's cast_budget with the reason",
            )


# -- sharding / collectives ---------------------------------------------------

# c10d op -> the JAX collective whose ceiling it answers to.
_C10D_KINDS = {
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.broadcast_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}

_DTYPE_BYTES = {"bool": 1, "uint8": 1, "int8": 1, "int16": 2, "float16": 2,
                "bfloat16": 2, "int32": 4, "float32": 4, "int64": 8,
                "float64": 8, "complex64": 8, "complex128": 16}

# Default per-op byte ceilings: JAX's (rules.py). All-reduce is the
# collective data-parallel training is MADE of, so it gets headroom;
# an all-gather / all-to-all above 1 MiB is a surprise materialization.
_DEFAULT_LIMITS = {
    "all-reduce": 64 << 20,
    "reduce-scatter": 64 << 20,
    "collective-permute": 64 << 20,
    "all-gather": 1 << 20,
    "all-to-all": 1 << 20,
}


def _op_bytes(op) -> int:
    """Payload of one collective: what it returns (the reduced or gathered
    tensors, as JAX counts a collective's result shape), else the buffer
    it sends or fills."""
    metas = op.outputs or op.inputs[:1]
    return sum(_DTYPE_BYTES.get(dtype, 4) * math.prod(shape)
               for dtype, shape, _ in metas)


@register_rule
class ShardingCollectivesRule(AuditRule):
    name = "sharding-collectives"
    description = (
        "torch: on the fake process group at world size 8, no recorded "
        "c10d collective (nor DDP gradient bucket, through the audit's comm "
        "hook) moves more bytes than its JAX ceiling (all-reduce 64 MiB, "
        "all-gather/all-to-all 1 MiB)"
    )

    def check(self, ctx: EntrypointContext) -> Iterable[AuditFinding]:
        limits = _DEFAULT_LIMITS
        counts: dict[tuple[str, str, int], int] = {}

        def note(kind: str, what: str, nbytes: int) -> None:
            if nbytes > limits[kind]:
                key = (kind, what, nbytes)
                counts[key] = counts.get(key, 0) + 1

        for op in ctx.ops:
            kind = _C10D_KINDS.get(op.name)
            if kind is None:
                continue
            shape = ",".join(f"{d}{list(s)}" for d, s, _ in
                             (op.outputs or op.inputs[:1]))
            note(kind, f"{op.name}:{shape}", _op_bytes(op))
        for nbytes in ctx.bucket_bytes:
            note("all-reduce", "ddp-bucket", nbytes)
        for (kind, what, nbytes), n in sorted(counts.items()):
            yield self.finding(
                ctx, f"{kind}:{what}",
                f"{kind} of {what} ({nbytes} bytes, {n}x) exceeds the "
                f"{limits[kind]}-byte ceiling — an unplanned "
                "cross-rank materialization",
            )


# -- host interop -------------------------------------------------------------

_SYNC_OPS = {"aten._local_scalar_dense", "aten.nonzero",
             "aten.masked_select", "aten.unique", "aten._unique2",
             "aten.unique_consecutive"}
_COPY_OPS = {"aten._to_copy", "aten.copy_", "aten.to"}


@register_rule
class HostInteropRule(AuditRule):
    name = "host-interop"
    description = (
        "torch: no aten._local_scalar_dense (.item()/int()/bool() of a "
        "tensor), aten.nonzero-style data-dependent shapes or device->host "
        "copy inside a hotpath entrypoint; on a card the call runs under "
        "torch.cuda.set_sync_debug_mode('error'), or 'warn' counting the "
        "syncs where the entrypoint declares them; each finding's ident "
        "carries its count, so a suppression pins how many"
    )

    def check(self, ctx: EntrypointContext) -> Iterable[AuditFinding]:
        if not ctx.spec.hotpath:
            return
        counts: dict[str, int] = {}
        for op in ctx.ops:
            if op.name in _SYNC_OPS:
                if op.read_ptr is not None and op.read_ptr in ctx.host_ptrs:
                    continue  # a host-resident counter: no device sync
                counts[op.name] = counts.get(op.name, 0) + 1
            elif (op.name in _COPY_OPS and op.inputs and op.outputs
                  and op.inputs[0][2] == "cuda" and op.outputs[0][2] == "cpu"):
                counts["device->host copy"] = counts.get("device->host copy", 0) + 1
        for what, n in sorted(counts.items()):
            yield self.finding(
                ctx, f"sync:{what}:{n}",
                f"{n} {what} op(s) inside the call — a host sync per step "
                "on a hot path; keep the value on the card or mark the "
                "entrypoint hotpath=False with a reason",
            )
        if ctx.sync_error is not None:
            yield self.finding(
                ctx, "sync-debug",
                "the call synchronizes the host under "
                f"set_sync_debug_mode('error'): {ctx.sync_error}",
            )
        if ctx.syncs:
            yield self.finding(
                ctx, f"sync-debug:{ctx.syncs}",
                f"{ctx.syncs} synchronizing CUDA call(s) under "
                "set_sync_debug_mode('warn')",
            )


# -- program baseline ---------------------------------------------------------


@register_rule
class ProgramBaselineRule(AuditRule):
    name = "program-baseline"
    description = (
        "torch: the recorded op sequence's hash (pinned per device and "
        "torch major.minor) and its FLOPs/bytes budgets (per device) stay "
        "as the port's analysis/baselines/audit.json pins them — a hash "
        "from another torch release is unpinned, not a failure"
    )

    def check(self, ctx: EntrypointContext) -> Iterable[AuditFinding]:
        records = ctx.baseline_programs.get(ctx.name)
        if not records:
            yield self.finding(
                ctx, "unbaselined",
                "entrypoint has no program baseline — pin it with "
                "`audit --update-baseline --reason '...'`",
            )
            return
        rec = records.get(ctx.device.split(":")[0])
        if rec is None:
            return  # no pin on this device: reported as unpinned
        current = ctx.program_hash()
        if rec.get("torch") == torch_release() and current != rec.get("hash"):
            yield self.finding(
                ctx, "hash",
                f"program changed: op-sequence hash {current} != baselined "
                f"{rec.get('hash')} (torch {torch_release()}) — re-pin with "
                "--update-baseline --reason if intended",
            )
        cost = {"flops": ctx.flops, "bytes": ctx.bytes}
        for kind in ("flops", "bytes"):
            budget = rec.get(kind)
            if budget is None or cost[kind] is None:
                continue
            if cost[kind] > budget * (1.0 + COST_TOLERANCE):
                yield self.finding(
                    ctx, kind,
                    f"{kind} regression: {cost[kind]:.4g} > budget "
                    f"{budget:.4g} (+{COST_TOLERANCE:.0%} tolerance) — "
                    "the program got more expensive; fix or re-pin with "
                    "--update-baseline --reason",
                )
