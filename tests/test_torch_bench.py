"""The port's ``bench``, case by case against JAX's ``tests/test_bench.py``,
and held to the JAX package where both compute the same thing.

Four layers, cheapest first: the statistics (median/MAD, tolerance,
verdicts: equal to JAX's on seeded sample sets); the fingerprinted baseline
(add/expire/reopen, foreign fingerprints, ``--require-baseline``: the same
verdicts and exit codes as JAX's, and the same written blocks); the
registry, runner and child protocol (JAX's scenario names and metric keys,
the one-JSON-line child, salvage of a killed child); and the integrations
on the CPU (the feeder_e2e attribution cross-check, the achieved-FLOPs/s
gauges priced by the port's per-device audit pins, the profile merge with
``torch.profiler``, real scenarios at two repetitions). Everything runs
with ``--device cpu``: the card's run is ``chip_smoke.py``'s.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dss_ml_at_scale_tpu.bench import core as jax_core
from dss_ml_at_scale_tpu.bench import stats as jax_stats
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.bench import (
    BenchResult,
    BenchUsageError,
    Metric,
    Scenario,
    environment_fingerprint,
    fingerprint_key,
    get_scenario,
    load_bench_baseline,
    measure_scenario,
    run_bench,
    scenario_names,
    write_bench_baseline,
)
from dss_ml_at_scale_tpu_torch.bench import core as bench_core
from dss_ml_at_scale_tpu_torch.bench import stats
from dss_ml_at_scale_tpu_torch.config.cli import main

REPO = Path(__file__).resolve().parents[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


# -- stats core ---------------------------------------------------------------


def test_warmup_discard():
    assert stats.discard_warmup([9.0, 1.0, 1.1, 1.2], 1) == [1.0, 1.1, 1.2]
    assert stats.discard_warmup([1.0], 0) == [1.0]
    with pytest.raises(ValueError):
        stats.discard_warmup([1.0], -1)


def test_median_and_mad_robust_to_outlier():
    clean = [100.0, 101.0, 99.0, 100.5, 99.5]
    s_clean = stats.summarize(clean)
    s_stalled = stats.summarize(clean + [400.0])
    assert abs(s_clean.median - 100.0) <= 0.5
    assert abs(s_stalled.median - s_clean.median) <= 1.0
    assert s_stalled.mad < 5.0
    assert stats.median([1.0, 3.0]) == 2.0  # even-length interpolation


def test_tolerance_derives_from_dispersion():
    quiet = stats.Summary(median=100.0, mad=0.5, n=5)
    noisy = stats.Summary(median=100.0, mad=20.0, n=5)
    assert stats.tolerance(quiet, quiet, floor=0.25) == 0.25
    assert stats.tolerance(quiet, noisy, floor=0.25) == pytest.approx(0.8)
    assert stats.tolerance(noisy, quiet, floor=0.25) == pytest.approx(0.8)


def test_large_regression_cannot_inflate_its_own_tolerance():
    base = stats.Summary(median=100.0, mad=1.0, n=5)
    regressed = stats.Summary(median=1000.0, mad=100.0, n=5)
    assert stats.tolerance(regressed, base, floor=0.25) == pytest.approx(0.4)
    assert stats.classify("lower", regressed, base, floor=0.25)["verdict"] == "regression"


@pytest.mark.parametrize("direction,cur,verdict", [
    ("higher", 30.0, "regression"),
    ("higher", 170.0, "improvement"),
    ("higher", 95.0, "within-noise"),
    ("lower", 170.0, "regression"),
    ("lower", 30.0, "improvement"),
    ("lower", 105.0, "within-noise"),
])
def test_classify_verdicts(direction, cur, verdict):
    base = stats.Summary(median=100.0, mad=1.0, n=5)
    out = stats.classify(direction, stats.Summary(median=cur, mad=1.0, n=5), base,
                         floor=0.35)
    assert out["verdict"] == verdict
    assert out["tolerance"] == pytest.approx(0.35)


def test_classify_edges():
    cur = stats.Summary(median=50.0, mad=1.0, n=5)
    assert stats.classify("higher", cur, None)["verdict"] == "no-baseline"
    zero = stats.Summary(median=0.0, mad=0.0, n=5)
    assert stats.classify("higher", cur, zero)["verdict"] == "no-baseline"
    base = stats.Summary(median=100.0, mad=0.0, n=5)
    assert stats.classify("higher", cur, base, gate=False)["verdict"] == "informational"
    with pytest.raises(ValueError):
        stats.classify("sideways", cur, base)


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("seed", range(4))
def test_stats_equal_jax_on_seeded_samples(seed):
    """summarize/tolerance/classify of both packages on the same sample
    sets: equal within 1e-12 relative, the same verdicts, including JAX's
    edges (no baseline, a zero or empty baseline, ungated, a zero current
    median, the regression that must not widen its own band)."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 9))
        cur = list(rng.lognormal(3.0, rng.uniform(0.01, 0.6), n))
        base = list(rng.lognormal(3.0, rng.uniform(0.01, 0.6), int(rng.integers(1, 9))))
        pairs = []
        for mod, xs, ys in ((stats, cur, base), (jax_stats, cur, base)):
            pairs.append((mod.summarize(xs), mod.summarize(ys)))
        (pc, pb), (jc, jb) = pairs
        for a, b in ((pc, jc), (pb, jb)):
            assert a.n == b.n and _close(a.median, b.median) and _close(a.mad, b.mad)
        floor = float(rng.uniform(0.05, 1.5))
        assert _close(stats.tolerance(pc, pb, floor=floor),
                      jax_stats.tolerance(jc, jb, floor=floor))
        for direction in ("higher", "lower"):
            for gate in (True, False):
                assert stats.classify(direction, pc, pb, gate=gate, floor=floor) == \
                    jax_stats.classify(direction, jc, jb, gate=gate, floor=floor)
    edges = [(stats.Summary(50.0, 1.0, 5), None),
             (stats.Summary(50.0, 1.0, 5), stats.Summary(0.0, 0.0, 5)),
             (stats.Summary(50.0, 1.0, 5), stats.Summary(100.0, 1.0, 0)),
             (stats.Summary(0.0, 0.0, 5), stats.Summary(100.0, 1.0, 5)),
             (stats.Summary(1000.0, 100.0, 5), stats.Summary(100.0, 1.0, 5))]
    for cur_s, base_s in edges:
        jcur = jax_stats.Summary(cur_s.median, cur_s.mad, cur_s.n)
        jbase = None if base_s is None else jax_stats.Summary(base_s.median, base_s.mad,
                                                               base_s.n)
        for direction in ("higher", "lower"):
            assert stats.classify(direction, cur_s, base_s, floor=0.25) == \
                jax_stats.classify(direction, jcur, jbase, floor=0.25)
    assert (stats.MAD_MULTIPLIER, stats.DEFAULT_REL_FLOOR) == \
        (jax_stats.MAD_MULTIPLIER, jax_stats.DEFAULT_REL_FLOOR)


# -- synthetic scenarios (framework loop, baseline round-trips) ---------------


def _synth_scenario(values, name="synth", warmup=1, extra=None, cls=Scenario,
                    metric=Metric):
    it = iter(values)

    def measure(_ctx):
        out = {"synth_metric": next(it)}
        if extra is not None:
            out["_extra"] = extra
        return out

    return cls(
        name=name, description="synthetic", tier="tier1",
        metrics=(metric("synth_metric", "units", "higher", floor=0.25),),
        measure=measure, repetitions=len(values) - warmup, warmup=warmup,
    )


@pytest.fixture
def synth_registry(monkeypatch):
    """Injects synthetic scenarios into the port's live registry (restored
    after the test) and returns a register(sc) helper."""
    bench_core._load_scenarios()

    def register(sc):
        monkeypatch.setitem(bench_core._SCENARIOS, sc.name, sc)
        return sc

    return register


def test_measure_scenario_discards_warmup_and_checkpoints(tmp_path):
    sc = _synth_scenario([999.0, 10.0, 11.0, 12.0], warmup=1)
    partial = tmp_path / "partial.json"
    record = measure_scenario(sc, partial_path=partial, env={}, device="cpu")
    assert record["samples"]["synth_metric"] == [10.0, 11.0, 12.0]
    assert record["completed"] == 3
    assert record["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    assert set(record["seconds"]) == {"setup", "repetitions"}
    assert json.loads(partial.read_text()) == record


def test_measure_scenario_rejects_undeclared_metric():
    sc = Scenario(name="synth", description="", tier="tier1",
                  metrics=(Metric("declared", "u"),),
                  measure=lambda ctx: {"undeclared": 1.0}, repetitions=1, warmup=0)
    with pytest.raises(BenchUsageError, match="undeclared"):
        measure_scenario(sc, env={}, device="cpu")


def test_scenario_schema_validation():
    with pytest.raises(ValueError, match="direction"):
        Metric("m", "u", "sideways")
    with pytest.raises(ValueError, match="tier"):
        Scenario(name="x", description="", tier="warp", metrics=(), measure=lambda c: {})
    with pytest.raises(ValueError, match="tier"):
        Scenario(name="x", description="", tier="tpu", metrics=(), measure=lambda c: {})
    with pytest.raises(ValueError, match="steps_metric"):
        Scenario(name="x", description="", tier="tier1", metrics=(Metric("m", "u"),),
                 measure=lambda c: {}, steps_metric="absent")


def test_needs_world_scenario_runs_inside_the_audit_world():
    import torch.distributed as dist

    seen = {}

    def setup(device, world):
        seen["setup"] = (device, world.world_size, dist.get_world_size())
        return {}

    sc = Scenario(name="synth", description="", tier="tier1", metrics=(Metric("m", "u"),),
                  setup=setup, measure=lambda ctx: {"m": float(dist.get_world_size())},
                  repetitions=1, warmup=0, needs_world=True)
    record = measure_scenario(sc, env={}, device="cpu")
    assert seen["setup"] == ("cpu", 8, 8) and record["samples"]["m"] == [8.0]
    assert not dist.is_initialized()  # the fake group is left after


def test_run_bench_judges_against_fingerprinted_baseline(tmp_path, synth_registry):
    register = synth_registry
    fp = fingerprint_key(environment_fingerprint("cpu"))
    bl = tmp_path / "bench.json"
    register(_synth_scenario([100.0, 100.0, 101.0, 99.0]))
    res = run_bench(["synth"], baseline_path=bl, isolation=False, device="cpu")
    assert res.results["synth"]["metrics"]["synth_metric"]["verdict"] == "no-baseline"
    assert res.exit_code == 0
    with pytest.raises(BenchUsageError, match="reason"):
        write_bench_baseline(bl, res, load_bench_baseline(bl), None)
    write_bench_baseline(bl, res, load_bench_baseline(bl), "initial")
    entry = json.loads(bl.read_text())["entries"][fp]["scenarios"]["synth"]
    assert entry["reason"] == "initial"
    assert entry["metrics"]["synth_metric"]["median"] == 100.0

    register(_synth_scenario([100.0, 100.0, 101.0, 99.0]))
    res = run_bench(["synth"], baseline_path=bl, isolation=False, device="cpu")
    assert res.results["synth"]["metrics"]["synth_metric"]["verdict"] == "within-noise"
    assert res.exit_code == 0

    register(_synth_scenario([50.0, 50.0, 51.0, 49.0]))
    res = run_bench(["synth"], baseline_path=bl, isolation=False, device="cpu")
    assert res.results["synth"]["metrics"]["synth_metric"]["verdict"] == "regression"
    assert res.exit_code == 1
    assert any(f["kind"] == "regression" for f in res.findings)

    write_bench_baseline(bl, res, load_bench_baseline(bl), None)
    entry = json.loads(bl.read_text())["entries"][fp]["scenarios"]["synth"]
    assert entry["reason"] == "initial"
    assert entry["metrics"]["synth_metric"]["median"] == 50.0


def test_foreign_fingerprint_entries_never_gate_or_expire(tmp_path, synth_registry):
    register = synth_registry
    bl = tmp_path / "bench.json"
    foreign = {"env": {"platform": "cuda"}, "scenarios": {
        "long_gone_scenario": {"reason": "another card's truth",
                               "metrics": {"x": {"median": 1.0}}}}}
    key = "cuda:NVIDIA_H100_80GB_HBM3:700.00_W:1dev:torch2.11:cuda13.0:drv580:py3.12:8cpu"
    bl.write_text(json.dumps({"version": 1, "entries": {key: foreign}}))
    register(_synth_scenario([5.0, 5.0], warmup=1))
    res = run_bench(["synth"], baseline_path=bl, isolation=False, device="cpu")
    assert res.exit_code == 0
    write_bench_baseline(bl, res, load_bench_baseline(bl), "r")
    assert json.loads(bl.read_text())["entries"][key] == foreign


def test_stale_baseline_entries_fail(tmp_path, synth_registry):
    register = synth_registry
    env = environment_fingerprint("cpu")
    fp = fingerprint_key(env)
    bl = tmp_path / "bench.json"
    bl.write_text(json.dumps({"version": 1, "entries": {fp: {"env": env, "scenarios": {
        "unregistered_scenario": {"reason": "r", "metrics": {"x": {"median": 1.0}}},
        "synth": {"reason": "r", "metrics": {
            "synth_metric": {"median": 5.0, "mad": 0.0, "n": 3},
            "dropped_metric": {"median": 2.0, "mad": 0.0, "n": 3}}}}}}}))
    register(_synth_scenario([5.0, 5.0], warmup=1))
    res = run_bench(["synth"], baseline_path=bl, isolation=False, device="cpu")
    stale = [f for f in res.findings if f["kind"] == "stale"]
    assert res.exit_code == 1
    assert {f.get("scenario") for f in stale} == {"unregistered_scenario", "synth"}
    write_bench_baseline(bl, res, load_bench_baseline(bl), "r")
    scen = json.loads(bl.read_text())["entries"][fp]["scenarios"]
    assert "unregistered_scenario" not in scen
    assert "dropped_metric" not in scen["synth"]["metrics"]
    register(_synth_scenario([5.0, 5.0], warmup=1))
    assert run_bench(["synth"], baseline_path=bl, isolation=False,
                     device="cpu").exit_code == 0


def test_extra_block_carried_into_report(synth_registry, tmp_path):
    synth_registry(_synth_scenario([1.0, 1.0], warmup=1, extra={"detail": {"k": "v"}}))
    res = run_bench(["synth"], baseline_path=tmp_path / "b.json", isolation=False,
                    device="cpu")
    assert res.results["synth"]["extra"] == {"detail": {"k": "v"}}


def test_update_baseline_refuses_salvaged_results(tmp_path, synth_registry):
    synth_registry(_synth_scenario([5.0, 5.0], warmup=1))
    res = run_bench(["synth"], baseline_path=tmp_path / "b.json", isolation=False,
                    device="cpu")
    res.results["synth"]["salvaged"] = True
    with pytest.raises(BenchUsageError, match="salvaged"):
        write_bench_baseline(tmp_path / "b.json", res, {"entries": {}}, "r")


def test_profile_repetitions_flag_reaches_the_profile(monkeypatch, tmp_path):
    from dss_ml_at_scale_tpu_torch.bench import profile as profile_mod

    seen = {}

    def fake_profile(name, out, *, repetitions, min_profiler_dur_us, device):
        seen["reps"], seen["device"] = repetitions, device
        return {"out": str(out), "spans": 0, "flows": 0, "profiler_events": 0,
                "profiler_events_dropped": 0, "kernel_events": 0, "window_us": None,
                "launches": {}, "mfu": None}

    monkeypatch.setattr(profile_mod, "profile_scenario", fake_profile)
    out = str(tmp_path / "x.json")
    assert main(["bench", "--repetitions", "5", "--device", "cpu", "profile", "feeder_e2e",
                 "--out", out]) == 0
    assert seen == {"reps": 5, "device": "cpu"}
    assert main(["bench", "--device", "cpu", "profile", "feeder_e2e", "--repetitions", "3",
                 "--out", out]) == 0
    assert seen["reps"] == 3
    assert main(["bench", "--device", "cpu", "profile", "feeder_e2e", "--out", out]) == 0
    assert seen["reps"] == 1


def test_require_baseline_fails_ungated_host(tmp_path, synth_registry):
    register = synth_registry
    register(_synth_scenario([5.0, 5.0], warmup=1))
    bl = tmp_path / "empty.json"
    assert run_bench(["synth"], baseline_path=bl, isolation=False,
                     device="cpu").exit_code == 0
    register(_synth_scenario([5.0, 5.0], warmup=1))
    res = run_bench(["synth"], baseline_path=bl, isolation=False, device="cpu",
                    require_baseline=True)
    assert res.exit_code == 1
    assert any(f["kind"] == "no-baseline" for f in res.findings)


def test_in_process_scenario_defect_is_finding_not_usage_error(tmp_path, synth_registry):
    synth_registry(Scenario(name="synth", description="", tier="tier1",
                            metrics=(Metric("declared", "u"),),
                            measure=lambda ctx: {"undeclared": 1.0},
                            repetitions=1, warmup=0))
    res = run_bench(["synth"], baseline_path=tmp_path / "b.json", isolation=False,
                    device="cpu")
    assert res.exit_code == 1
    assert any(f["kind"] == "error" and "undeclared" in f["message"] for f in res.findings)
    with pytest.raises(BenchUsageError, match="repetitions"):
        run_bench(["synth"], baseline_path=tmp_path / "b.json", isolation=False,
                  repetitions=0, device="cpu")


def test_recorder_scenario_parks_and_restores_live_recorder(tmp_path):
    from dss_ml_at_scale_tpu_torch.telemetry import flightrec

    sc = get_scenario("recorder_overhead")
    outer = tmp_path / "outer_tail.jsonl"
    flightrec.enable(outer)
    try:
        ctx = sc.setup("cpu", None)
        try:
            out = sc.measure(ctx)
        finally:
            sc.teardown(ctx)
        assert flightrec.get_recorder().path == outer.absolute()
        assert out["recorder_emit_tail_us"] > 0
        assert not any(e.get("thread") == "bench" for e in flightrec.read_events(outer))
    finally:
        flightrec.disable(outer)


def test_salvage_partial_contract(tmp_path):
    p = tmp_path / "partial.json"
    assert bench_core._salvage_partial(p) is None
    p.write_text(json.dumps({"scenario": "x", "completed": 0}))
    assert bench_core._salvage_partial(p) is None
    p.write_text(json.dumps({"scenario": "x", "completed": 2, "samples": {"m": [1, 2]}}))
    assert bench_core._salvage_partial(p)["completed"] == 2


# -- baseline: both packages' writers and verdicts -----------------------------


def _result(mod, fp_key: str, env: dict, names=("decode", "serving")):
    """A synthetic BenchResult of ``mod`` over real scenario names."""
    results = {}
    for i, name in enumerate(names):
        results[name] = {"tier": "tier1", "completed": 3, "metrics": {
            m: {"unit": "u", "direction": "higher",
                "summary": {"median": 10.0 * (i + 1) + j, "mad": 0.5, "n": 3}}
            for j, m in enumerate(x.name for x in mod._SCENARIOS[name].metrics)}}
    return mod.BenchResult(scenarios=list(names), env=env, fingerprint_key=fp_key,
                           results=results, findings=[], mfu={})


def test_baseline_written_equal_to_jax(tmp_path):
    jax_core._load_scenarios()
    bench_core._load_scenarios()
    env, key = {"platform": "cpu"}, "same:fingerprint"
    old = {"entries": {"other:box": {"env": {}, "scenarios": {"x": {"reason": "kept"}}},
                       key: {"env": env, "scenarios": {"decode": {"reason": "authored",
                                                                  "metrics": {}}}}}}
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    assert write_bench_baseline(ours, _result(bench_core, key, env), json.loads(
        json.dumps(old)), "new entries") == \
        jax_core.write_bench_baseline(theirs, _result(jax_core, key, env), json.loads(
            json.dumps(old)), "new entries") == 1
    a, b = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert a["version"] == b["version"] == 1
    assert a["entries"] == b["entries"]
    assert a["entries"][key]["scenarios"]["decode"]["reason"] == "authored"
    assert a["entries"][key]["scenarios"]["serving"]["reason"] == "new entries"


def _verdict_run(mod, register, tmp_path, values, bl, *, require=False, device=None):
    register(mod, _synth_scenario(values, cls=mod.Scenario, metric=mod.Metric))
    kw = {"device": device} if device else {}
    res = mod.run_bench(["synth"], baseline_path=bl, isolation=False,
                        require_baseline=require, **kw)
    m = res.results["synth"]["metrics"]["synth_metric"]
    return m["verdict"], res.exit_code, sorted(f["kind"] for f in res.findings)


def test_baseline_semantics_equal_jax(tmp_path, monkeypatch):
    """Add, reopen at a new level, expire, a foreign fingerprint and
    --require-baseline: the same verdicts and exit codes in both packages."""
    jax_core._load_scenarios()
    bench_core._load_scenarios()

    def register(mod, sc):
        monkeypatch.setitem(mod._SCENARIOS, sc.name, sc)

    outcomes = {}
    for mod, dev in ((bench_core, "cpu"), (jax_core, None)):
        bl = tmp_path / f"{mod.__name__}.json"
        env = mod.environment_fingerprint(dev) if dev else mod.environment_fingerprint()
        fp = mod.fingerprint_key(env)
        bl.write_text(json.dumps({"version": 1, "entries": {"foreign:key": {
            "env": {}, "scenarios": {"gone": {"reason": "r", "metrics": {}}}}}}))
        steps = [_verdict_run(mod, register, tmp_path, [100.0, 100.0, 101.0, 99.0], bl,
                              device=dev)]
        steps.append(_verdict_run(mod, register, tmp_path, [100.0, 100.0], bl,
                                  require=True, device=dev))
        register(mod, _synth_scenario([100.0, 100.0, 101.0, 99.0], cls=mod.Scenario,
                                      metric=mod.Metric))
        res = mod.run_bench(["synth"], baseline_path=bl, isolation=False,
                            **({"device": dev} if dev else {}))
        mod.write_bench_baseline(bl, res, mod.load_bench_baseline(bl), "added")
        steps.append(_verdict_run(mod, register, tmp_path, [100.0, 100.0, 101.0, 99.0], bl,
                                  device=dev))
        steps.append(_verdict_run(mod, register, tmp_path, [40.0, 40.0, 41.0, 39.0], bl,
                                  device=dev))
        steps.append(_verdict_run(mod, register, tmp_path, [300.0, 300.0], bl, device=dev))
        register(mod, _synth_scenario([40.0, 40.0, 41.0, 39.0], cls=mod.Scenario,
                                      metric=mod.Metric))
        res = mod.run_bench(["synth"], baseline_path=bl, isolation=False,
                            **({"device": dev} if dev else {}))
        mod.write_bench_baseline(bl, res, mod.load_bench_baseline(bl), None)  # reopen
        steps.append(_verdict_run(mod, register, tmp_path, [40.0, 40.0, 41.0, 39.0], bl,
                                  device=dev))
        data = json.loads(bl.read_text())
        data["entries"][fp]["scenarios"]["left_the_registry"] = {"reason": "r", "metrics": {}}
        bl.write_text(json.dumps(data))
        steps.append(_verdict_run(mod, register, tmp_path, [40.0, 40.0], bl, device=dev))
        outcomes[mod.__name__] = (steps, data["entries"]["foreign:key"])
    port, theirs = outcomes.values()
    assert port == theirs
    verdicts = [s[0] for s in port[0]]
    assert verdicts == ["no-baseline", "no-baseline", "within-noise", "regression",
                        "improvement", "within-noise", "within-noise"]
    assert [s[1] for s in port[0]] == [0, 1, 0, 1, 0, 0, 1]


# -- registry + catalog reconciliation ----------------------------------------


def test_registry_matches_catalog_and_jax():
    from dss_ml_at_scale_tpu.telemetry.catalog import KNOWN_BENCH_METRICS as JAX_BENCH
    from dss_ml_at_scale_tpu_torch.telemetry.catalog import (
        KNOWN_BENCH_METRICS,
        KNOWN_SPANS,
        SPAN_ATTRIBUTION,
    )

    assert KNOWN_BENCH_METRICS == JAX_BENCH
    names = scenario_names()
    assert set(names) == set(KNOWN_BENCH_METRICS) == set(jax_core.scenario_names())
    for name in names:
        sc, theirs = get_scenario(name), jax_core.get_scenario(name)
        assert tuple(m.name for m in sc.metrics) == tuple(KNOWN_BENCH_METRICS[name])
        # JAX's schema, floors, repetitions, warm-up and timeout, metric by metric.
        assert [dataclasses.astuple(m) for m in sc.metrics] == \
            [dataclasses.astuple(m) for m in theirs.metrics]
        assert (sc.repetitions, sc.warmup, sc.timeout_s) == \
            (theirs.repetitions, theirs.warmup, theirs.timeout_s)
        assert sc.tier == {"tpu": "cuda"}.get(theirs.tier, theirs.tier)
        assert sc.needs_world == theirs.needs_mesh
        assert sc.steps_metric == theirs.steps_metric or name == "group_fit"
    assert set(SPAN_ATTRIBUTION) <= set(KNOWN_SPANS)
    assert set(SPAN_ATTRIBUTION.values()) <= {"data_wait", "transfer", "compute", "host"}


def test_group_fit_geometry_is_jax():
    from dss_ml_at_scale_tpu.workloads import forecasting as jf
    from dss_ml_at_scale_tpu_torch.workloads import forecasting as pf

    for name in ("GROUP_FIT_BENCH_GROUPS", "GROUP_FIT_BENCH_WEEKS", "GROUP_FIT_BENCH_HORIZON"):
        assert getattr(pf, name) == getattr(jf, name)
    ours, theirs = dataclasses.asdict(pf.GROUP_FIT_BENCH_CFG), \
        dataclasses.asdict(jf.GROUP_FIT_BENCH_CFG)
    assert ours == {k: theirs[k] for k in ours}


# -- child protocol -----------------------------------------------------------


def _run_child(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.bench", *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO), env=_env(),
    )


def test_child_protocol_success_and_partial(tmp_path):
    partial = tmp_path / "p.json"
    proc = _run_child(["--scenario", "sanitizer_overhead", "--partial", str(partial),
                       "--repetitions", "2", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["scenario"] == "sanitizer_overhead"
    assert record["completed"] == 2
    assert len(record["samples"]["sanitizer_overhead_ratio"]) == 2
    assert json.loads(partial.read_text())["completed"] == 2


def test_child_protocol_failure_is_json_not_crash():
    proc = _run_child(["--scenario", "no_such_scenario", "--device", "cpu"], timeout=120)
    assert proc.returncode == 0
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["failed"] is True
    assert "no_such_scenario" in record["error"]


def test_child_killed_at_its_timeout_is_salvaged(tmp_path):
    """A real child that outlives its scenario's timeout: the parent kills
    it and salvages the repetitions its durable partial holds."""
    sc = dataclasses.replace(get_scenario("slo_overhead"), timeout_s=12.0)
    record, note = bench_core._run_child(sc, 100_000, tmp_path, "cpu")
    assert record is not None and record["salvaged"] is True, note
    assert record["completed"] >= 1 and "timed out after 12s; salvaged" in note
    assert len(record["samples"]["slo_overhead_ratio"]) == record["completed"]


# -- CLI ----------------------------------------------------------------------


def test_cli_usage_errors(capsys):
    assert main(["bench", "--scenarios", "decode", "--tier", "tier1", "--device", "cpu"]) == 2
    assert main(["bench", "--scenarios", "no_such", "--device", "cpu"]) == 2
    assert main(["bench", "--tier", "warp", "--device", "cpu"]) == 2
    assert main(["bench", "--tier", "tpu"]) == 2  # before any card check
    assert "'cuda'" in capsys.readouterr().err


def test_cli_list_scenarios_is_jax_registry(capsys):
    assert main(["bench", "--list-scenarios"]) == 0
    listed = {}
    for line in capsys.readouterr().out.splitlines():
        name, _, rest = line.partition(" ")
        listed[name] = rest.strip().split("]")[0].lstrip("[").strip()
    jax_tiers = {n: t for n, t, _ in jax_core.scenario_catalog()}
    assert listed == {n: {"tpu": "cuda"}.get(t, t) for n, t in jax_tiers.items()}
    assert len(listed) == 11


def test_cli_synthetic_regression_exits_nonzero(tmp_path, capsys):
    env = environment_fingerprint("cpu")
    fp = fingerprint_key(env)
    bl = tmp_path / "bench.json"
    bl.write_text(json.dumps({"version": 1, "entries": {fp: {"env": env, "scenarios": {
        "sanitizer_overhead": {"reason": "synthetic: impossible ratio", "metrics": {
            "sanitizer_overhead_ratio": {"median": 0.001, "mad": 0.0, "n": 5}}}}}}}))
    rc = main(["bench", "--scenarios", "sanitizer_overhead", "--json", "--baseline",
               str(bl), "--repetitions", "2", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1 and report["ok"] is False
    assert report["counts"]["regressions"] == 1
    m = report["results"]["sanitizer_overhead"]["metrics"]["sanitizer_overhead_ratio"]
    assert m["verdict"] == "regression"


def test_cli_serving_json_then_slo_check_report(tmp_path):
    """`bench --scenarios serving --json --device cpu` through the CLI (the
    scenario in its own child, a stub server in its child), then `slo check
    --report` on that very artifact (its embedded /slo snapshot)."""
    cli = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli"]
    proc = subprocess.run(cli + ["bench", "--scenarios", "serving", "--json", "--device",
                                 "cpu", "--repetitions", "2"],
                          capture_output=True, text=True, timeout=240, env=_env(), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["version"] == 1 and report["ok"] is True
    assert report["fingerprint"]["platform"] == "cpu"
    res = report["results"]["serving"]
    assert res["completed"] == 2 and res["metrics"]["serving_throughput_rps"][
        "summary"]["median"] > 0
    assert res["extra"]["loadgen"]["trace_propagated"] == res["extra"]["loadgen"]["requests"]
    assert [o["name"] for o in res["extra"]["slo"]["objectives"]][0] == "serving_latency_p99"
    artifact = tmp_path / "bench.json"
    artifact.write_text(proc.stdout)
    check = subprocess.run(cli + ["slo", "check", "--report", str(artifact)],
                           capture_output=True, text=True, timeout=120, env=_env())
    assert check.returncode == 0, check.stdout + check.stderr


# -- the real scenarios on the CPU ----------------------------------------------


def test_real_scenarios_on_the_cpu(tmp_path):
    names = ["decode", "recorder_overhead", "slo_overhead", "sanitizer_overhead", "serving"]
    res = run_bench(names, repetitions=2, baseline_path=tmp_path / "b.json",
                    isolation=False, device="cpu")
    assert res.findings == [] and res.exit_code == 0
    for name in names:
        r = res.results[name]
        assert r["completed"] == 2, name
        assert r["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
        assert r["seconds"]["wall"] >= r["seconds"]["setup"] + r["seconds"]["repetitions"]
        for metric, m in r["metrics"].items():
            assert m["summary"]["n"] == 2 and math.isfinite(m["summary"]["median"]), metric
    assert res.results["recorder_overhead"]["metrics"]["recorder_tail_bytes_per_event"][
        "summary"]["median"] > 0
    assert res.env["platform"] == "cpu" and res.fingerprint_key.startswith("cpu:cpu:None:")


def test_sanitizer_overhead_beside_a_session_scope():
    """Under an armed outer scope (the DSST_SANITIZE=1 session plugin's), the
    plain side still takes the real lock and the outer scope stays armed."""
    from dss_ml_at_scale_tpu_torch.analysis.sanitize import is_armed, sanitize_scope
    from dss_ml_at_scale_tpu_torch.bench import scenarios

    with sanitize_scope():
        out = get_scenario("sanitizer_overhead").measure(None)
        assert is_armed()
    assert not is_armed()
    assert out["sanitizer_overhead_ratio"] > 1.0
    assert scenarios._ACQUIRES == 20_000


# -- feeder_e2e cross-check, MFU, percentiles ---------------------------------


@pytest.fixture(scope="module")
def feeder_ctx():
    from dss_ml_at_scale_tpu_torch.analysis.audit.core import audit_world

    sc = get_scenario("feeder_e2e")
    with audit_world() as world:
        ctx = sc.setup("cpu", world)
        yield sc, ctx
        sc.teardown(ctx)


def test_feeder_e2e_crosscheck_passes(feeder_ctx):
    sc, ctx = feeder_ctx
    out = sc.measure(ctx)
    assert out["e2e_images_per_sec"] > 0
    assert out["e2e_unexplained_fraction"] < 0.5


def test_feeder_e2e_crosscheck_fails_on_attribution_gap(feeder_ctx, monkeypatch):
    from dss_ml_at_scale_tpu_torch.bench import scenarios as scen_mod

    sc, ctx = feeder_ctx
    monkeypatch.setattr(scen_mod, "_attribution_buckets",
                        lambda tail, since: {"data_wait": 0.0, "transfer": 0.0,
                                             "compute": 0.0, "host": 0.0})
    with pytest.raises(RuntimeError, match="unexplained"):
        sc.measure(ctx)


def _pins(tmp_path) -> Path:
    p = tmp_path / "audit.json"
    p.write_text(json.dumps({"programs": {"ep": {"cpu": {"flops": 100.0},
                                                 "cuda": {"flops": 250.0}}}}))
    return p


def test_mfu_gauges_priced_by_the_per_device_audit_pins(tmp_path, monkeypatch):
    import torch

    from dss_ml_at_scale_tpu_torch.bench import mfu

    flops = mfu.pinned_flops("train_step.classifier", "cpu")
    assert flops and flops > 0 and mfu.pinned_flops("train_step.classifier", "cuda") > 0
    assert mfu.pinned_flops("no.such.entrypoint") is None
    pins = _pins(tmp_path)
    assert mfu.pinned_flops("ep", "cpu", pins) == 100.0
    assert mfu.pinned_flops("ep", "cuda:0", pins) == 250.0
    card = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    block = mfu.publish_achieved("ep", 10.0, device_kind=card, device="cuda",
                                 baseline_path=pins)
    assert block["achieved_flops_per_sec"] == pytest.approx(2500.0)
    assert block["arithmetic"] == "tf32"
    assert block["utilization"] == pytest.approx(2500.0 / 494.7e12)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    block = mfu.publish_achieved("ep", 10.0, device_kind=card, baseline_path=pins)
    assert block["arithmetic"] == "fp32" and block["peak_flops_per_sec"] == 66.9e12
    assert block["utilization"] == pytest.approx(2500.0 / 66.9e12)
    cpu = mfu.publish_achieved("ep", 10.0, device_kind="cpu", device="cpu",
                               baseline_path=pins)
    assert cpu["utilization"] is None and cpu["achieved_flops_per_sec"] == 1000.0
    text = telemetry.render_prometheus()
    assert "entrypoint_achieved_flops_per_sec" in text
    assert "entrypoint_flops_utilization" in text
    assert mfu.publish_achieved("no.such.entrypoint", 10.0) is None


def _tail(path, period):
    events = []
    for i in range(4):
        base = {"name": "train_step", "ts": i * period, "pid": 1, "tid": 1,
                "trace": "t1", "span": f"{i:08x}", "kind": "step"}
        events.append({**base, "ph": "B"})
        events.append({**base, "ph": "E", "dur": 0.5})
    path.write_text("\n".join(json.dumps(e) for e in events) + "\n")
    return path


def test_mfu_publish_from_trace_equals_jax(tmp_path):
    from dss_ml_at_scale_tpu.bench import mfu as jax_mfu
    from dss_ml_at_scale_tpu_torch.bench import mfu

    pins = _pins(tmp_path)
    jax_pins = tmp_path / "jax_audit.json"
    jax_pins.write_text(json.dumps({"programs": {"ep": {"flops": 250.0}}}))
    for period, want in ((0.5, 2.0), (1.0, 4 / 3.5)):
        tail = _tail(tmp_path / f"t{period}.jsonl", period)
        ours = mfu.publish_from_trace(tail, "ep", device="cuda", baseline_path=pins)
        theirs = jax_mfu.publish_from_trace(tail, "ep", baseline_path=jax_pins)
        assert ours["steps_per_sec"] == theirs["steps_per_sec"] == pytest.approx(want, rel=1e-3)
        assert ours["achieved_flops_per_sec"] == theirs["achieved_flops_per_sec"]
    assert mfu.publish_from_trace(tmp_path / "empty.jsonl", "ep", baseline_path=pins) is None


def test_loadgen_percentiles_equal_jax():
    from dss_ml_at_scale_tpu.bench import loadgen as jax_loadgen
    from dss_ml_at_scale_tpu_torch.bench import loadgen

    rng = np.random.default_rng(7)
    for n in (1, 2, 7, 100, 1001):
        samples = sorted(rng.lognormal(-4.0, 0.7, n).tolist())
        for p in (0.5, 0.9, 0.99):
            assert loadgen.percentile(samples, p) == jax_loadgen.quantile(samples, p)
    assert loadgen.percentile([], 0.99) is None


# -- fingerprint, baseline path, benchlib -------------------------------------


def test_card_fingerprint_from_nvidia_smi_without_touching_cuda(tmp_path, monkeypatch):
    """On a card the fingerprint comes from an nvidia-smi child: name, power
    limit, driver and card count, each in the key; no torch.cuda entry is
    touched (the parent starts no CUDA context before its children)."""
    import torch

    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W, 580.65.06'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    for name in ("is_available", "device_count", "get_device_name", "init",
                 "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail("touched torch.cuda"))
    env = environment_fingerprint("cuda")
    assert (env["platform"], env["device"], env["power_limit"], env["driver"],
            env["device_count"]) == ("cuda", "NVIDIA H100 80GB HBM3", "700.00 W",
                                     "580.65.06", 1)
    key = fingerprint_key(env)
    assert key.startswith("cuda:NVIDIA_H100_80GB_HBM3:700.00_W:1dev:torch")
    assert "drv580.65.06" in key
    assert fingerprint_key({**env, "power_limit": "500.00 W"}) != key
    with pytest.raises(BenchUsageError, match="card 1"):
        environment_fingerprint("cuda:1")


def test_default_baseline_is_the_ports():
    assert bench_core.DEFAULT_BENCH_BASELINE == \
        REPO / "dss_ml_at_scale_tpu_torch" / "analysis" / "baselines" / "bench.json"
    data = load_bench_baseline(bench_core.DEFAULT_BENCH_BASELINE)
    assert isinstance(data["entries"], dict)


def test_benchlib_batches_equal_jax_and_window_ends_on_the_loss():
    import torch

    from dss_ml_at_scale_tpu.utils import benchlib as jax_benchlib
    from dss_ml_at_scale_tpu_torch.utils import benchlib

    ours = benchlib.synthetic_image_batch(4, 8, num_classes=5, seed=3)
    theirs = jax_benchlib.synthetic_image_batch(4, 8, num_classes=5, seed=3)
    for k in ("image", "label"):
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k])
    dev = benchlib.synthetic_image_batch_device(3, 4, 5, seed=1, device="cpu")
    again = benchlib.synthetic_image_batch_device(3, 4, 5, seed=1, device="cpu")
    assert torch.equal(dev["image"], again["image"]) and dev["label"].dtype == torch.int32

    calls = []

    class Loss:
        def __init__(self, i):
            self.i = i

        def item(self):
            calls.append(self.i)
            return float(self.i)

    count = iter(range(100))
    seconds = benchlib.timed_train_steps(lambda b: {"train_loss": Loss(next(count))},
                                         None, steps=3, warmup=2)
    assert seconds >= 0 and calls == [1, 4]  # the last warmup step, the last timed step
