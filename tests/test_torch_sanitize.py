"""The port's ``sanitize`` tier: the real gate, each rule's twins, the
framework, and a chaos cycle with the sanitizer armed.

- **the real gate**: every workload on the port's subsystems (feeder,
  serving scheduler, worker pool, run journal, trace handoffs) runs
  armed with ``--device cpu`` and reports no unbaselined finding and no
  stale entry of the port's ``analysis/baselines/sanitize.json``;
- **seeded twins**: the JAX package's fixtures under
  ``tests/fixtures/sanitize/`` (read, not changed), imported under the
  ``sanfix_`` prefix that ``extra_prefixes`` instruments: each rule bites
  its positive twin (an AB/BA cycle with both stacks, an off-lock guarded
  write, an unjoined thread, a leaked lock) and spares its negative twin;
- **the framework**: suppressions (reason mandatory), baseline
  add/expire, a disarmed scope that restores plain ``threading``, the
  caller filter that leaves torch's own locks and threads raw;
- **chaos**: a ``DSST_SANITIZE=1`` SIGKILL ``train`` cycle on the CPU
  (every child armed) still converges, and its completed children report
  no finding.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from dss_ml_at_scale_tpu_torch.analysis import LintUsageError, load_baseline
from dss_ml_at_scale_tpu_torch.analysis.sanitize import (
    DEFAULT_SANITIZE_BASELINE,
    RULES,
    build_result,
    is_armed,
    run_workloads,
    sanitize_scope,
    workload_names,
)
from dss_ml_at_scale_tpu_torch.analysis.sanitize import runtime as sanrt
from dss_ml_at_scale_tpu_torch.analysis.sanitize.report import update_baseline
from dss_ml_at_scale_tpu_torch.config.cli import main

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "sanitize"


def _load_fixture(name: str):
    """A fixture module under the ``sanfix_`` prefix, fresh per call."""
    modname = f"sanfix_{name}"
    spec = importlib.util.spec_from_file_location(modname, FIXTURES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _run_fixture(name: str, tmp_path):
    mod = _load_fixture(name)
    with sanitize_scope(extra_prefixes=("sanfix_",)) as scope:
        ret = mod.run()
    res = build_result(scope, [name], baseline_path=tmp_path / "empty.json", full_run=False)
    return res, ret


# -- the real gate ------------------------------------------------------------


def test_gate_all_workloads_clean_against_baseline():
    names = workload_names()
    assert names == ["feeder", "journal", "serving", "trace", "workers"]
    with sanitize_scope() as scope:
        run_workloads(names, device="cpu")
    res = build_result(scope, names, full_run=True)
    assert res.findings == [], "\n" + "\n".join(f.text() for f in res.findings)
    assert res.stale_baseline == [], res.stale_baseline
    assert res.stats["locks"] > 10  # a real pass: instrumentation saw locks


def test_every_baseline_entry_has_a_reason():
    assert DEFAULT_SANITIZE_BASELINE == (
        ROOT / "dss_ml_at_scale_tpu_torch/analysis/baselines/sanitize.json")
    for key, entry in load_baseline(DEFAULT_SANITIZE_BASELINE).items():
        assert str(entry.get("reason", "")).strip(), f"baseline entry {key} has no reason"


def test_the_caller_filter_is_the_port_and_leaves_torch_raw():
    """The instrumented prefix is the port's (the JAX prefix does not match
    it). Armed, the feeder's own thread is recorded, while the stdlib
    queue's lock it rides and anything torch creates stay raw."""
    assert sanrt._DEFAULT_PREFIXES == ("dss_ml_at_scale_tpu_torch.",)
    assert not "dss_ml_at_scale_tpu_torch.data".startswith("dss_ml_at_scale_tpu.")
    import numpy as np

    from dss_ml_at_scale_tpu_torch.data.prefetch import Feeder

    with sanitize_scope() as scope:
        assert not sanrt._matches_prefix("torch.cuda")
        assert sanrt._matches_prefix("dss_ml_at_scale_tpu_torch.data.prefetch")
        feeder = Feeder(iter([{"x": np.zeros(2, np.float32)}] * 3), "cpu", name="filter")
        assert len(list(feeder)) == 3
        feeder.close()
        assert not isinstance(feeder._queue.mutex, sanrt.SanitizedLock)
    res = build_result(scope, ["feeder"], full_run=False)
    assert res.findings == []
    threads = [r["name"] for r in sanrt._STATE.threads]
    assert "feeder-filter" in threads


# -- seeded twins -------------------------------------------------------------


def test_lock_order_cycle_detected_with_both_stacks(tmp_path):
    res, _ = _run_fixture("lock_order_positive", tmp_path)
    (f,) = [f for f in res.findings if f.rule == "lock-order"]
    assert "lock_order_positive.py" in f.path and "conflicting orders" in f.message
    assert len(f.stacks) == 4
    text = f.text()
    assert "with lock_a:" in text and "with lock_b:" in text
    assert "sanfix-ab" in text and "sanfix-ba" in text


def test_lock_order_clean_twin(tmp_path):
    res, _ = _run_fixture("lock_order_negative", tmp_path)
    assert res.findings == [], "\n".join(f.text() for f in res.findings)


def test_guarded_by_off_lock_write_detected(tmp_path):
    res, _ = _run_fixture("guarded_by_positive", tmp_path)
    (f,) = [f for f in res.findings if f.rule == "guarded-by"]
    assert "Box.state" in f.message and "off the lock" in f.message
    labels = [label for label, _ in f.stacks]
    assert any(lb.startswith("offending") for lb in labels)
    assert any("lock last acquired by" in lb for lb in labels)
    assert "racy_bump" in f.text()


def test_guarded_by_clean_twin(tmp_path):
    res, _ = _run_fixture("guarded_by_negative", tmp_path)
    assert res.findings == [], "\n".join(f.text() for f in res.findings)


def test_guarded_by_suppression_with_reason(tmp_path):
    res, _ = _run_fixture("guarded_by_suppressed", tmp_path)
    assert [f.rule for f in res.suppressed] == ["guarded-by"]
    assert res.findings == []


def test_unjoined_thread_detected(tmp_path):
    res, release = _run_fixture("unjoined_thread_positive", tmp_path)
    try:
        (f,) = [f for f in res.findings if f.rule == "unjoined-thread"]
        assert "sanfix-unjoined" in f.message
    finally:
        release.set()


def test_unjoined_thread_clean_twin(tmp_path):
    res, _ = _run_fixture("unjoined_thread_negative", tmp_path)
    assert res.findings == []


def test_leaked_lock_detected(tmp_path):
    res, lock = _run_fixture("leaked_lock_positive", tmp_path)
    try:
        (f,) = [f for f in res.findings if f.rule == "leaked-lock"]
        assert "still held" in f.message
    finally:
        lock.release()


def test_leaked_lock_clean_twin(tmp_path):
    res, _ = _run_fixture("leaked_lock_negative", tmp_path)
    assert res.findings == []


def _jax_run_fixture(name: str, tmp_path):
    from dss_ml_at_scale_tpu.analysis.sanitize import build_result as jax_build_result
    from dss_ml_at_scale_tpu.analysis.sanitize import sanitize_scope as jax_sanitize_scope

    mod = _load_fixture(name)
    with jax_sanitize_scope(extra_prefixes=("sanfix_",)) as scope:
        ret = mod.run()
    res = jax_build_result(scope, [name], baseline_path=tmp_path / "jax.json", full_run=False)
    return res, ret


def _release(ret) -> None:
    """Let a fixture's parked thread finish, or its leaked lock go."""
    if isinstance(ret, threading.Event):
        ret.set()
    elif hasattr(ret, "locked") and ret.locked():
        ret.release()


def _shape(res) -> list:
    return [sorted((f.rule, f.path, f.line, len(f.stacks)) for f in found)
            for found in (res.findings, res.suppressed)]


@pytest.mark.parametrize("fixture", sorted(p.stem for p in FIXTURES.glob("*.py")))
def test_fixture_findings_match_the_jax_sanitizer(fixture, tmp_path):
    """Each of the JAX package's fixtures, run under JAX's sanitizer and
    then under the port's: the same (rule, path, line, stack count)
    findings and suppressions."""
    jax_res, ret = _jax_run_fixture(fixture, tmp_path)
    _release(ret)
    port_res, ret = _run_fixture(fixture, tmp_path)
    _release(ret)
    assert _shape(port_res) == _shape(jax_res)
    assert [f.rule for f in port_res.findings] == [f.rule for f in jax_res.findings]
    # The seeded twins bite under both: the comparison is not empty = empty.
    assert any(_shape(jax_res)) == fixture.endswith(("_positive", "_suppressed"))


def test_reasonless_suppression_does_not_silence(tmp_path):
    src = (FIXTURES / "guarded_by_suppressed.py").read_text(encoding="utf-8")
    import re

    stripped = re.sub(r"(# dsst: ignore\[guarded-by\]).*", r"\1", src)
    assert stripped != src
    path = tmp_path / "guarded_by_reasonless.py"
    path.write_text(stripped)
    spec = importlib.util.spec_from_file_location("sanfix_reasonless", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["sanfix_reasonless"] = mod
    spec.loader.exec_module(mod)
    with sanitize_scope(extra_prefixes=("sanfix_",)) as scope:
        mod.run()
    res = build_result(scope, ["x"], baseline_path=tmp_path / "e.json", full_run=False)
    assert [f.rule for f in res.findings] == ["guarded-by"] and res.suppressed == []


# -- baseline semantics -------------------------------------------------------


def _fixture_scope(name: str):
    mod = _load_fixture(name)
    with sanitize_scope(extra_prefixes=("sanfix_",)) as scope:
        mod.run()
    return scope


def test_baseline_accepts_then_expires(tmp_path):
    baseline = tmp_path / "sanitize.json"
    res = build_result(_fixture_scope("lock_order_positive"), ["fixture"],
                       baseline_path=baseline, full_run=True)
    assert len(res.findings) == 1
    update_baseline(baseline, res, "seeded fixture: accepted for the test")
    res2 = build_result(_fixture_scope("lock_order_positive"), ["fixture"],
                        baseline_path=baseline, full_run=True)
    assert res2.findings == [] and len(res2.baselined) == 1 and res2.ok
    scope = _fixture_scope("lock_order_negative")
    res3 = build_result(scope, ["fixture"], baseline_path=baseline, full_run=True)
    assert not res3.ok and len(res3.stale_baseline) == 1
    assert build_result(scope, ["fixture"], baseline_path=baseline, full_run=False).ok


def test_update_baseline_requires_reason(tmp_path):
    baseline = tmp_path / "b.json"
    res = build_result(_fixture_scope("lock_order_positive"), ["fixture"],
                       baseline_path=baseline, full_run=True)
    with pytest.raises(LintUsageError, match="--reason"):
        update_baseline(baseline, res, None)


# -- disarmed = plain threading -----------------------------------------------


def test_disarmed_restores_plain_threading_objects():
    from dss_ml_at_scale_tpu_torch.telemetry.registry import _CounterValue

    assert not is_armed()
    orig = _CounterValue.__dict__["value"]
    assert threading.Lock is sanrt._REAL_LOCK
    with sanitize_scope():
        assert threading.Lock is not sanrt._REAL_LOCK
        assert threading.Thread is not sanrt._REAL_THREAD
        assert isinstance(_CounterValue.__dict__["value"], sanrt._GuardedAttr)
    assert threading.Lock is sanrt._REAL_LOCK
    assert threading.RLock is sanrt._REAL_RLOCK
    assert threading.Condition is sanrt._REAL_CONDITION
    assert threading.Thread is sanrt._REAL_THREAD
    assert _CounterValue.__dict__["value"] is orig
    assert type(threading.Lock()).__module__ == "_thread"


def test_nested_scopes_refcount():
    with sanitize_scope():
        patched = threading.Lock
        with sanitize_scope():
            assert threading.Lock is patched
        assert threading.Lock is patched
    assert threading.Lock is sanrt._REAL_LOCK


def test_guarded_classes_of_the_port_are_instrumented():
    """The 18 ``_guarded_by_lock`` classes of the port (WorkerPool's
    among them) get their descriptors while armed."""
    from dss_ml_at_scale_tpu_torch.resilience.workers import WorkerPool

    with sanitize_scope():
        pool = WorkerPool(["a"], probe=None)
        assert isinstance(WorkerPool.__dict__["_idle"], sanrt._GuardedAttr)
        assert pool.get(timeout=1.0) == "a"
        pool.close()
    assert "_idle" not in WorkerPool.__dict__


# -- regressions the JAX sanitizer surfaced, held on the port -----------------


def test_device_monitor_concurrent_start_spawns_one_thread():
    from dss_ml_at_scale_tpu_torch.telemetry.device import DeviceMonitor
    from dss_ml_at_scale_tpu_torch.telemetry.registry import MetricsRegistry

    mon = DeviceMonitor(MetricsRegistry(), interval_s=60.0, devices=[])
    gate = threading.Event()

    def racer():
        gate.wait(5)
        mon.start()

    racers = [threading.Thread(target=racer) for _ in range(8)]
    for t in racers:
        t.start()
    gate.set()
    for t in racers:
        t.join(10)
    alive = [t for t in threading.enumerate() if t.name == "device-monitor" and t.is_alive()]
    try:
        assert len(alive) == 1, alive
    finally:
        mon.stop()
    mon.start()
    mon.stop()


def test_request_outcome_snapshots_under_lock():
    from dss_ml_at_scale_tpu_torch.serving.admission import DeadlineExceeded, Request

    req = Request(2)
    req.complete_item(0, {"score": 1.0})
    req.complete_item(1, {"score": 2.0})
    error, results = req.outcome()
    assert error is None and [r["score"] for r in results] == [1.0, 2.0]
    req2 = Request(1)
    assert req2.fail(DeadlineExceeded("late"))
    error, results = req2.outcome()
    assert isinstance(error, DeadlineExceeded) and results == [None]


# -- CLI ----------------------------------------------------------------------


def test_cli_lists(capsys):
    assert main(["sanitize", "--list-workloads"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in workload_names())
    assert main(["sanitize", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in RULES) and len(RULES) == 4


def test_cli_single_workload_json(capsys):
    assert main(["sanitize", "--workloads", "workers", "--device", "cpu", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == 1 and doc["workloads"] == ["workers"] and doc["ok"] is True
    assert doc["stats"]["locks"] > 0


def test_cli_usage_errors(capsys):
    assert main(["sanitize", "--workloads", "nope", "--device", "cpu"]) == 2
    assert "unknown workload" in capsys.readouterr().err
    assert main(["sanitize", "--workloads", "workers", "--update-baseline", "--reason", "x",
                 "--device", "cpu"]) == 2
    assert "full workload set" in capsys.readouterr().err


def test_cli_refuses_a_missing_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert main(["sanitize", "--workloads", "workers"]) == 2
    assert "no CUDA device" in capsys.readouterr().out


# -- DSST_SANITIZE=1 ----------------------------------------------------------


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_observation_mode_arms_any_command(tmp_path):
    """``DSST_SANITIZE=1`` arms the sanitizer before the command runs,
    leaves its exit code alone, and reports nothing for a clean run."""
    code = ("import sys\n"
            "from dss_ml_at_scale_tpu_torch.config import cli\n"
            "from dss_ml_at_scale_tpu_torch.analysis import sanitize\n"
            "rc = cli.main(['runs', 'list', '--tracking-root', sys.argv[1]])\n"
            "print('armed', sanitize.is_armed(), 'rc', rc)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "runs")], cwd=tmp_path,
                         env=_env(DSST_SANITIZE="1"), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "armed True rc 0"
    assert "observation mode" not in out.stderr


def test_chaos_train_cycle_with_sanitizer_armed(tmp_path, monkeypatch):
    """One SIGKILL chaos ``train`` cycle on the CPU with every child armed:
    the soak converges to the uninterrupted run's exact parameters, and
    the children that ran to their end report no finding."""
    from dss_ml_at_scale_tpu_torch.resilience.chaos import ChaosConfig, run_chaos

    monkeypatch.setenv("DSST_SANITIZE", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    report = run_chaos(ChaosConfig(
        workdir=str(tmp_path / "soak"), cycles=1, seed=3, kill_min_s=1.0,
        kill_max_s=3.0, epochs=2, rows=32, batch_size=16, image_size=32,
        timeout_s=240.0, device="cpu"))
    problems = {k: v for k, v in report["invariants"].items() if not v.get("ok")}
    assert report["ok"], json.dumps(problems, indent=1)
    assert report["kills_delivered"] >= 1
    params = report["invariants"]["params_bitwise_equal"]
    assert params["chaos"] == params["ref"]
    for log in ("final.log", "ref.log"):
        text = (tmp_path / "soak" / "logs" / log).read_text()
        assert "observation mode" not in text, text[-3000:]
