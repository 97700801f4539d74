"""The port's ``audit`` tier: the real gate, each rule's twins, and the
framework.

- **the real gate**: the 13 entrypoints of the port's registry (the JAX
  registry's, one for one) run on the CPU (``--device cpu``), clean
  against the port's committed baseline (``analysis/baselines/audit.json``):
  no active finding, no stale entry, every accepted entry with a reason;
- **per-rule twins**: small synthetic entrypoints, one that breaks the
  rule and one that keeps it, for donation (in-place state), dtype
  discipline, collectives on the fake process group of 8 ranks, host
  interop and the program baseline;
- **the framework**: registry suppressions (reason mandatory), build and
  run failures as findings, pin / reopen on a hash change / reopen on a
  cost regression / unpinned on another torch release / expire, the CLI.
"""

from __future__ import annotations

import functools
import json

import pytest
import torch
import torch.distributed as dist

from dss_ml_at_scale_tpu.analysis.audit import entrypoint_names as jax_entrypoint_names
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.analysis.audit import (
    AUDIT_WORLD_SIZE,
    DEFAULT_AUDIT_BASELINE,
    AuditUsageError,
    ProgramSpec,
    audit_world,
    entrypoint_names,
    load_audit_baseline,
    rule_names,
    run_audit,
    write_audit_baseline,
)
from dss_ml_at_scale_tpu_torch.analysis.audit.core import torch_release
from dss_ml_at_scale_tpu_torch.config.cli import main

RULES = ["donation", "dtype-discipline", "host-interop", "program-baseline",
         "sharding-collectives"]


def _audit(builders: dict, rules: list[str], tmp_path, baseline=None):
    return run_audit(specs=builders, rules=rules, device="cpu",
                     baseline_path=baseline or tmp_path / "none.json")


# -- the real gate ------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _registry_result():
    """ONE whole-registry audit shared by the gates below."""
    return run_audit(device="cpu")


def test_registry_clean_against_committed_baseline():
    res = _registry_result()
    assert res.findings == [], "\n".join(f.text() for f in res.findings)
    assert res.stale_baseline == [], [e["key"] for e in res.stale_baseline]
    assert res.exit_code == 0 and res.device == "cpu"
    assert sorted(res.rules) == RULES == rule_names()


def test_registry_covers_the_jax_entrypoints():
    """All 13 of the JAX registry's entrypoints, by the same names."""
    assert entrypoint_names() == sorted(jax_entrypoint_names())
    assert len(entrypoint_names()) == 13
    assert set(_registry_result().programs) == set(entrypoint_names())


def test_every_audit_baseline_entry_has_a_reason_and_both_devices_pinned():
    baseline = load_audit_baseline(DEFAULT_AUDIT_BASELINE)
    for key, entry in baseline["entries"].items():
        assert str(entry.get("reason", "")).strip(), f"audit baseline entry {key} has no reason"
    assert set(baseline["programs"]) == set(entrypoint_names())
    for name, devices in baseline["programs"].items():
        # Pinned on the CPU here and on the card (an H100 run of
        # `audit --device cuda --update-baseline`).
        assert set(devices) == {"cpu", "cuda"}, name
        for pin in devices.values():
            assert {"hash", "torch", "flops", "bytes"} <= set(pin), name


def test_registry_programs_on_the_cpu():
    """What the CPU run records: the kernels' plain versions (no launch),
    the suppressed verdict read of the health guard, FLOPs counted."""
    res = _registry_result()
    progs = res.programs
    assert progs["ops.fused_matmul.grad"]["launches"] == {"K1": 0, "K2": 0, "K3": 0}
    assert progs["ops.flash_attention.grad"]["launches"] == {"K4": 0}
    assert all(p["flops"] > 0 for n, p in progs.items() if n != "ops.fused_norm.grad")
    assert progs["ops.fused_matmul.grad"]["launches_total"] == {"K1": 0, "K2": 0, "K3": 0}
    # No card here: no sync-debug mode, no error, no count.
    assert not any(p["sync_debug"] or p["sync_error"] or p["syncs"] for p in progs.values())
    (sup,) = res.suppressed
    assert (sup.path, sup.rule, sup.ident) == (
        "train_step.classifier.health", "host-interop", "sync:aten._local_scalar_dense:1")
    pins = {n: p["pin"] for n, p in progs.items()}
    assert set(pins.values()) <= {"pinned", f"unpinned on cpu torch {torch_release()}"}


def test_audit_emits_registered_telemetry():
    def val(name: str) -> float:
        for m in telemetry.snapshot()["metrics"]:
            if m["name"] == name and not m["labels"]:
                return m["value"]
        return 0.0

    _registry_result()
    assert val("audit_entrypoints_total") >= len(entrypoint_names())


def test_the_audit_leaves_no_process_group():
    _registry_result()
    assert not dist.is_initialized()


def test_ddp_steps_go_through_the_audit_comm_hook():
    """DDP's reducer cannot run on the fake group: the data-parallel steps
    carry the audit's comm hook, which records each gradient bucket."""
    from dss_ml_at_scale_tpu_torch.analysis.audit import entrypoints
    from dss_ml_at_scale_tpu_torch.analysis.audit.core import EntrypointContext

    with audit_world() as world:
        assert dist.get_world_size() == AUDIT_WORLD_SIZE
        spec = entrypoints.train_step_lm("cpu", world)
        ctx = EntrypointContext(spec, "cpu", world)
        ctx.run()
    n_params = sum(p.numel() for p in spec.fn.__self__.model.parameters())
    assert ctx.bucket_bytes and sum(ctx.bucket_bytes) == 4 * n_params
    assert any(op.name == "c10d.allreduce_" for op in ctx.ops) is False
    assert ctx.donated_before and ctx.donated_before == ctx.donated_after


# -- per-rule twins -----------------------------------------------------------


def _state_spec(name: str, in_place: bool):
    state = {"w": torch.ones(16), "m": torch.zeros(16)}

    def step(x):
        if in_place:
            state["w"].add_(x)
            state["m"].mul_(0.9).add_(x)
        else:
            state["w"] = state["w"] + x
            state["m"] = state["m"] * 0.9 + x

    return lambda device, world: ProgramSpec(
        name=name, fn=step, args=(torch.ones(16),), donated=lambda: dict(state))


def test_donation_flags_replaced_state(tmp_path):
    res = _audit({"twin": _state_spec("twin", in_place=False)}, ["donation"], tmp_path)
    assert sorted(f.ident for f in res.findings) == ["moved:m", "moved:w"]


def test_donation_spares_in_place_state(tmp_path):
    res = _audit({"twin": _state_spec("twin", in_place=True)}, ["donation"], tmp_path)
    assert res.findings == []


def _dtype_spec(kind: str):
    def step(x):
        if kind == "wide":
            return (x.double() * 2).sum()
        if kind == "churn":
            for _ in range(5):
                x = x.to(torch.float16).to(torch.float32)
            return x
        return (x * 2).sum()  # pinned: f32 throughout

    return lambda device, world: ProgramSpec(
        name=kind, fn=step, args=(torch.ones(8, 8),), cast_budget=4)


def test_dtype_flags_tensor_sized_f64(tmp_path):
    res = _audit({"wide": _dtype_spec("wide")}, ["dtype-discipline"], tmp_path)
    assert any(f.ident.startswith("wide:") and "float64[8, 8]" in f.message
               for f in res.findings), [f.text() for f in res.findings]


def test_dtype_flags_cast_churn_over_budget(tmp_path):
    res = _audit({"churn": _dtype_spec("churn")}, ["dtype-discipline"], tmp_path)
    assert [f.ident for f in res.findings] == ["cast-churn"]
    assert "10 dtype casts" in res.findings[0].message


def test_dtype_spares_pinned_twin(tmp_path):
    res = _audit({"pinned": _dtype_spec("pinned")}, ["dtype-discipline"], tmp_path)
    assert res.findings == []


def _sync_spec(name: str, **kw):
    counter = torch.zeros((), dtype=torch.int64)

    def step(x):
        counter.add_(1)
        n = int(counter)                 # a read of host-resident state
        if name == "item":
            return x.sum().item() + n    # a scalar read of the result
        if name == "nonzero":
            return x.nonzero() if n else x
        return x * n

    return lambda device, world: ProgramSpec(
        name=name, fn=step, args=(torch.arange(6.0),),
        host_state=lambda: [counter], **kw)


def test_host_interop_flags_scalar_reads_and_nonzero(tmp_path):
    res = _audit({"item": _sync_spec("item"), "nonzero": _sync_spec("nonzero")},
                 ["host-interop"], tmp_path)
    assert sorted((f.path, f.ident) for f in res.findings) == [
        ("item", "sync:aten._local_scalar_dense:1"), ("nonzero", "sync:aten.nonzero:1")]
    assert "1 aten._local_scalar_dense" in res.findings[0].message


def test_host_interop_spares_host_state_and_cold_paths(tmp_path):
    res = _audit({"clean": _sync_spec("clean"),
                  "item": _sync_spec("item", hotpath=False)}, ["host-interop"], tmp_path)
    assert res.findings == []


def _collective_spec(name: str, numel: int, op: str, **kw):
    def step(x):
        if op == "all_gather":
            out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
            dist.all_gather(out, x)
        else:
            dist.all_reduce(x)
        return x

    return lambda device, world: ProgramSpec(
        name=name, fn=step, args=(torch.ones(numel),), **kw)


def test_sharding_flags_surprise_allgather(tmp_path):
    # 64 Ki f32 per rank, gathered over 8 ranks: 2 MiB > the 1 MiB ceiling.
    res = _audit({"gather": _collective_spec("gather", 1 << 16, "all_gather")},
                 ["sharding-collectives"], tmp_path)
    assert len(res.findings) == 1
    assert res.findings[0].ident.startswith("all-gather:c10d.allgather_:")
    assert f"{8 * 4 * (1 << 16)} bytes" in res.findings[0].message


def test_sharding_spares_small_and_allreduce(tmp_path):
    res = _audit({"small": _collective_spec("small", 1 << 10, "all_gather"),
                  "reduce": _collective_spec("reduce", 1 << 16, "all_reduce")},
                 ["sharding-collectives"], tmp_path)
    assert res.findings == []


def test_sharding_holds_a_broadcast_to_the_allgather_ceiling(tmp_path):
    def step(x):
        dist.broadcast(x, src=0)
        return x

    spec = lambda device, world: ProgramSpec(name="bcast", fn=step,  # noqa: E731
                                             args=(torch.ones(1 << 19),))
    res = _audit({"bcast": spec}, ["sharding-collectives"], tmp_path)
    assert [f.ident for f in res.findings] == ["all-gather:c10d.broadcast_:float32[524288]"]


# -- suppressions and failures ------------------------------------------------


def test_suppression_with_reason_silences_and_is_reported(tmp_path):
    spec = _sync_spec("item", suppress={"host-interop": "a deliberate metrics read"})
    res = _audit({"item": spec}, ["host-interop"], tmp_path)
    assert res.findings == [] and [f.path for f in res.suppressed] == ["item"]


def test_health_guard_suppression_pins_one_verdict_read(tmp_path):
    """The health-guarded step's suppression names its one verdict read
    by count: the real step is clean, and a second scalar read planted in
    the guarded step is an active finding."""
    import dataclasses

    from dss_ml_at_scale_tpu_torch.analysis.audit import entrypoints

    def planted(device, world):
        spec = entrypoints.train_step_classifier_health(device, world)

        def step(*args):
            out = spec.fn(*args)
            float(out[1]["train_loss"])  # the planted second sync
            return out

        return dataclasses.replace(spec, fn=step)

    real = _audit({"real": entrypoints.train_step_classifier_health}, ["host-interop"], tmp_path)
    assert real.findings == [] and [f.ident for f in real.suppressed] == [
        "sync:aten._local_scalar_dense:1"]
    res = _audit({"planted": planted}, ["host-interop"], tmp_path)
    assert [(f.rule, f.ident) for f in res.findings] == [
        ("host-interop", "sync:aten._local_scalar_dense:2")]
    assert res.suppressed == []


def test_host_interop_reads_the_sync_debug_outcome():
    """On a card the recorded call's sync-debug outcome is a finding of
    its own: the error under "error", the count under "warn" (so a
    suppression pins how many)."""
    from dss_ml_at_scale_tpu_torch.analysis.audit.core import EntrypointContext
    from dss_ml_at_scale_tpu_torch.analysis.audit.rules import HostInteropRule

    spec = ProgramSpec(name="s", fn=lambda: None)
    ctx = EntrypointContext(spec, "cuda", None)
    assert list(HostInteropRule().check(ctx)) == []
    ctx.sync_error = "called a synchronizing CUDA operation"
    ctx.syncs = 2
    assert [f.ident for f in HostInteropRule().check(ctx)] == ["sync-debug", "sync-debug:2"]


def test_suppression_without_reason_is_a_usage_error(tmp_path):
    spec = _sync_spec("item", suppress={"host-interop": "  "})
    with pytest.raises(AuditUsageError, match="no reason"):
        _audit({"item": spec}, ["host-interop"], tmp_path)
    assert not dist.is_initialized()


def test_builder_and_run_failures_are_trace_error_findings(tmp_path):
    def broken_builder(device, world):
        raise RuntimeError("registry bug")

    def broken(x):
        raise ValueError("shape mismatch")

    res = _audit({"builder": broken_builder,
                  "run": lambda d, w: ProgramSpec(name="run", fn=broken, args=(1,))},
                 ["donation"], tmp_path)
    assert sorted((f.path, f.rule, f.ident) for f in res.findings) == [
        ("builder", "trace-error", "build"), ("run", "trace-error", "run")]


def test_unknown_entrypoint_and_rule_are_usage_errors():
    with pytest.raises(AuditUsageError):
        run_audit(["not.an.entrypoint"], device="cpu")
    with pytest.raises(AuditUsageError):
        run_audit(["ops.fused_norm.grad"], rules=["not-a-rule"], device="cpu")


def test_a_process_in_a_group_is_refused(tmp_path):
    with audit_world():
        with pytest.raises(AuditUsageError, match="already in one"):
            _audit({"twin": _state_spec("twin", True)}, ["donation"], tmp_path)
    assert not dist.is_initialized()


# -- the program baseline -----------------------------------------------------


def _program_spec(extra_op: bool):
    def step(x):
        y = torch.mm(x, x)
        return torch.mm(y, x) if extra_op else y

    return lambda device, world: ProgramSpec(name="prog", fn=step, args=(torch.ones(8, 8),))


def test_program_baseline_pin_and_reopen(tmp_path):
    bl = tmp_path / "audit.json"
    res = _audit({"prog": _program_spec(False)}, ["program-baseline"], tmp_path, bl)
    assert [f.ident for f in res.findings] == ["unbaselined"]
    write_audit_baseline(bl, res, load_audit_baseline(bl), None)
    res = _audit({"prog": _program_spec(False)}, ["program-baseline"], tmp_path, bl)
    assert res.findings == [] and res.programs["prog"]["pin"] == "pinned"
    # An edited program on the same torch release reopens (the hash), and
    # its extra product is a FLOP regression too.
    res = _audit({"prog": _program_spec(True)}, ["program-baseline"], tmp_path, bl)
    assert sorted(f.ident for f in res.findings) == ["bytes", "flops", "hash"]
    assert res.programs["prog"]["pin"] == "changed"


def test_program_hash_of_another_torch_release_is_unpinned(tmp_path):
    bl = tmp_path / "audit.json"
    res = _audit({"prog": _program_spec(False)}, ["program-baseline"], tmp_path, bl)
    write_audit_baseline(bl, res, {}, None)
    data = json.loads(bl.read_text())
    data["programs"]["prog"]["cpu"].update(hash="0" * 20, torch="1.0")
    bl.write_text(json.dumps(data))
    res = _audit({"prog": _program_spec(False)}, ["program-baseline"], tmp_path, bl)
    assert res.findings == []
    assert res.programs["prog"]["pin"].startswith("unpinned on cpu")
    # The budgets still hold on another release.
    res = _audit({"prog": _program_spec(True)}, ["program-baseline"], tmp_path, bl)
    assert sorted(f.ident for f in res.findings) == ["bytes", "flops"]


def test_program_pins_of_other_devices_survive_an_update(tmp_path):
    bl = tmp_path / "audit.json"
    res = _audit({"prog": _program_spec(False)}, ["program-baseline"], tmp_path, bl)
    write_audit_baseline(bl, res, {}, None)
    data = json.loads(bl.read_text())
    data["programs"]["prog"]["cuda"] = {"hash": "x", "torch": "2.11", "flops": 1.0,
                                        "bytes": 1.0}
    bl.write_text(json.dumps(data))
    write_audit_baseline(bl, res, load_audit_baseline(bl), None)
    assert set(load_audit_baseline(bl)["programs"]["prog"]) == {"cpu", "cuda"}


def test_accepted_finding_expires_when_fixed(tmp_path):
    bl = tmp_path / "audit.json"
    res = _audit({"twin": _state_spec("twin", False)}, ["donation"], tmp_path, bl)
    write_audit_baseline(bl, res, {}, "known copy, fix pending")
    res = _audit({"twin": _state_spec("twin", False)}, ["donation"], tmp_path, bl)
    assert res.findings == [] and len(res.baselined) == 2
    res = _audit({"twin": _state_spec("twin", True)}, ["donation"], tmp_path, bl)
    assert res.findings == [] and len(res.stale_baseline) == 2 and res.exit_code == 1


def test_new_baseline_entry_requires_reason(tmp_path):
    bl = tmp_path / "audit.json"
    res = _audit({"twin": _state_spec("twin", False)}, ["donation"], tmp_path, bl)
    with pytest.raises(AuditUsageError, match="needs --reason"):
        write_audit_baseline(bl, res, {}, None)


def test_update_baseline_refuses_a_broken_registry(tmp_path):
    def broken(device, world):
        raise RuntimeError("registry bug")

    res = _audit({"broken": broken}, ["donation"], tmp_path)
    with pytest.raises(AuditUsageError, match="trace errors"):
        write_audit_baseline(tmp_path / "audit.json", res, {}, "any")


# -- CLI ----------------------------------------------------------------------


def test_cli_list_rules_and_entrypoints(capsys):
    assert main(["audit", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        line = next(ln for ln in out.splitlines() if ln.startswith(rule))
        assert "torch" in line
    assert main(["audit", "--list-entrypoints"]) == 0
    assert capsys.readouterr().out.split() == entrypoint_names()


def test_cli_usage_errors(capsys):
    assert main(["audit", "--device", "cpu", "--entrypoints", "nope"]) == 2
    assert main(["audit", "--device", "cpu", "--entrypoints", "ops.fused_norm.grad",
                 "--update-baseline", "--reason", "x"]) == 2


def test_cli_refuses_a_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert main(["audit"]) == 2
    assert "no CUDA device" in capsys.readouterr().out


def test_cli_single_entrypoint_json(capsys):
    assert main(["audit", "--device", "cpu", "--entrypoints", "ops.fused_norm.grad",
                 "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["version"] == 1 and payload["ok"] is True
    assert payload["device"] == "cpu"
    assert payload["entrypoints"] == ["ops.fused_norm.grad"]
    assert payload["programs"]["ops.fused_norm.grad"]["pin"] in (
        "pinned", f"unpinned on cpu torch {torch_release()}")
