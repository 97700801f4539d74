"""The port's SLO engine against the JAX package's, fed the same samples.

- the feeder-stall and train-step objectives, the serving and LM ones, the
  two-window state machine and the alert journal: the same samples on the
  same fake clock give the same transitions, the same ``alerts.jsonl`` and
  the same ``/slo`` document in both engines (equal as JSON, wall-clock
  ``ts`` taken out);
- ``firing_at_death`` and the journal reader tolerate a torn tail;
- a run store attaches the journal and detaches it, scoped to its path;
- ``slo status|check|watch`` (``--url``, ``--report``) and ``top --once``
  against a CPU port server (JAX's ``tests/test_slo.py`` CLI cases).
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from dss_ml_at_scale_tpu.telemetry import slo as jax_slo
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.telemetry import slo
from dss_ml_at_scale_tpu_torch.telemetry.slo import Objective


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _objectives(mod):
    """Short-window copies of every default objective, in ``mod``'s type."""
    return tuple(
        mod.Objective(**{**{f: getattr(o, f) for f in o.__dataclass_fields__},
                         "fast_window_s": 5.0, "slow_window_s": 25.0,
                         "burn_threshold": 2.0, "pending_for_s": 4.0,
                         "clear_for_s": 6.0, "min_samples": 5})
        for o in mod.default_objectives())


def _drive(mod, journal) -> tuple[list, list]:
    """One fixed history through an engine of ``mod``: requests, waits,
    steps, tokens; returns every evaluation's transitions and the status
    documents, wall-clock stamps removed."""
    clock = FakeClock()
    engine = mod.SloEngine(objectives=_objectives(mod), clock=clock)
    engine.attach_journal(journal)
    engine.set_latency_budget(0.05)
    engine.set_target("train_step_p95", 0.2)
    engine.set_target("ttft_p99", 0.1)
    transitions, docs = [], []
    for t in range(40):
        clock.t = float(t)
        for i in range(4):
            status = 503 if 10 <= t < 20 and i % 2 else 200
            engine.note_request(0.01 + 0.02 * (t % 3), status,
                                trace_id=f"{t:08x}{i:08x}")
        engine.note_feeder_wait(0.9 if 15 <= t < 30 else 0.001)
        engine.note_train_step(0.5 if t >= 25 else 0.1, f"{t:016x}")
        engine.note_ttft(0.02, None)
        engine.note_inter_token(0.005)
        if t % 2:
            transitions.append(engine.evaluate())
            doc = engine.render_status()
            doc.pop("ts")
            docs.append(doc)
    for ts in transitions:
        for tr in ts:
            tr.pop("ts")
    engine.detach_journal(journal)
    return transitions, docs


def _journal(path) -> list[dict]:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for r in rows:
        r.pop("ts")
    return rows


def test_same_samples_give_the_same_alerts_journal_and_status(tmp_path):
    port = _drive(slo, tmp_path / "port.jsonl")
    ref = _drive(jax_slo, tmp_path / "jax.jsonl")
    assert port == ref
    assert _journal(tmp_path / "port.jsonl") == _journal(tmp_path / "jax.jsonl")
    states = {(t["slo"], t["state"]) for t in slo.read_alert_journal(tmp_path / "port.jsonl")}
    # The history makes the error and feeder-stall objectives fire, the
    # error one resolve, and the armed train-step one go pending.
    assert {("serving_error_rate", "firing"), ("feeder_stall_fraction", "firing"),
            ("serving_error_rate", "resolved"), ("train_step_p95", "pending")} <= states
    assert port[1][-1]["firing"] == ["feeder_stall_fraction"]
    assert slo.firing_at_death(tmp_path / "port.jsonl") == \
        jax_slo.firing_at_death(tmp_path / "jax.jsonl")
    assert slo.read_alert_journal(tmp_path / "port.jsonl")


def test_default_objectives_equal_jax():
    assert [o.__dict__ for o in slo.default_objectives()] == \
        [o.__dict__ for o in jax_slo.default_objectives()]
    for args in ((200, 0.01, 0.04), (200, 0.1, 0.04), (503, 0.05, 0.04), (429, 0.0, 0.04),
                 (500, 0.01, 0.04), (404, 0.01, 0.04)):
        assert slo.classify_request(*args) == jax_slo.classify_request(*args)


def test_feeder_and_train_step_objectives():
    clock = FakeClock()
    engine = slo.SloEngine(clock=clock)
    engine.set_target("train_step_p95", 0.05)  # a 0.5 s p95 burns 10x
    for t in range(400):
        clock.t = float(t)
        engine.note_feeder_wait(0.9)
        engine.note_train_step(0.5, trace_id="ab" * 8)
    clock.t = 399.5
    engine.evaluate()
    by = {o["name"]: o for o in engine.render_status()["objectives"]}
    assert by["feeder_stall_fraction"]["state"] == "firing"
    assert by["train_step_p95"]["state"] == "firing"
    assert by["train_step_p95"]["budget"] == 0.05


def test_torn_journal_and_firing_at_death(tmp_path):
    journal = tmp_path / "alerts.jsonl"
    journal.write_text(
        json.dumps({"ts": 1.0, "slo": "feeder_stall_fraction", "state": "pending"}) + "\n"
        + json.dumps({"ts": 2.0, "slo": "feeder_stall_fraction", "state": "firing"}) + "\n"
        + '{"slo": "serving_error_rate", "sta')
    assert slo.firing_at_death(journal) == ["feeder_stall_fraction"]
    assert slo.read_alert_journal(journal) == jax_slo.read_alert_journal(journal)
    assert slo.firing_at_death(tmp_path / "missing.jsonl") == []


def test_attach_carries_burning_alerts_and_detach_is_scoped(tmp_path):
    clock = FakeClock()
    obj = Objective(name="serving_error_rate", description="t", kind="events",
                    target=0.99, fast_window_s=5.0, slow_window_s=25.0,
                    burn_threshold=2.0, pending_for_s=4.0, clear_for_s=6.0, min_samples=5)
    engine = slo.SloEngine(objectives=(obj,), clock=clock)
    run1, run2 = tmp_path / "run1.jsonl", tmp_path / "run2.jsonl"
    engine.attach_journal(run1)
    for _ in range(10):
        engine.note_request(0.01, 503)
    engine.evaluate()
    clock.t = 4.5
    engine.evaluate()
    assert slo.firing_at_death(run1) == ["serving_error_rate"]
    engine.attach_journal(run2)  # still firing: carried into the new journal
    (carried,) = slo.read_alert_journal(run2)
    assert carried["carried"] is True and carried["state"] == "firing"
    engine.detach_journal(run1)  # stale: no-op
    assert engine.journal_path == run2.absolute()
    engine.detach_journal(run2)
    assert engine.journal_path is None


def test_run_store_attaches_and_scopes_the_alert_journal(tmp_path):
    from dss_ml_at_scale_tpu_torch.telemetry import flightrec
    from dss_ml_at_scale_tpu_torch.tracking import RunStore

    engine = telemetry.slo.get_engine()
    store = RunStore(tmp_path, "exp", run_name="r")
    try:
        assert engine.journal_path == (store.path / "alerts.jsonl").absolute()
    finally:
        store.finish()
        flightrec.disable()
    assert engine.journal_path is None


# -- the CLI against a CPU port server ---------------------------------------


@pytest.fixture()
def serving_handle():
    from dss_ml_at_scale_tpu_torch.serving.lm import LMConfig, LMEngine, StubLMDecoder
    from dss_ml_at_scale_tpu_torch.workloads.serving import serve_lm_in_thread

    telemetry.reset()
    engine = LMEngine(StubLMDecoder(step_ms=1.0, slots=2, max_len=48, buckets=(8,)),
                      LMConfig(slots=2, max_len=48, prefill_buckets=(8,),
                               queue_depth=8)).start()
    handle = serve_lm_in_thread(engine)
    yield handle
    handle.close()
    telemetry.reset()


def _run(argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_slo_status_check_watch_and_top(serving_handle):
    url = f"http://127.0.0.1:{serving_handle.port}"
    rc, out, _ = _run(["slo", "status", "--url", url, "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["version"] == 1
    assert {o["name"] for o in doc["objectives"]} == {o.name for o in slo.default_objectives()}
    rc, out, _ = _run(["slo", "status", "--url", url])
    assert rc == 0 and "OBJECTIVE" in out and "firing: (none)" in out
    rc, out, _ = _run(["slo", "check", "--url", url, "--json"])
    assert rc == 0 and json.loads(out)["ok"] is True
    rc, out, _ = _run(["slo", "watch", "--url", url, "--iterations", "1", "--interval", "0"])
    assert rc == 0 and "slo watch" in out
    rc, out, _ = _run(["top", "--url", url, "--once"])
    assert rc == 0 and "dsst top" in out and "ttft_p99" in out


def test_cli_slo_check_report_modes(tmp_path):
    doc = {"version": 1, "objectives": [
        {"name": "serving_error_rate", "state": "firing", "unit": "fraction", "value": 0.5,
         "budget": 0.01, "burn_fast": 50.0, "burn_slow": 50.0, "budget_remaining": -49.0,
         "samples": 60},
        {"name": "ttft_p99", "state": "pending", "unit": "s", "value": 0.2, "budget": 0.1,
         "burn_fast": 2.0, "burn_slow": 2.0, "budget_remaining": -1.0, "samples": 30}],
        "firing": ["serving_error_rate"], "ok": False}
    report = tmp_path / "slo.json"
    report.write_text(json.dumps(doc))
    rc, out, _ = _run(["slo", "check", "--report", str(report), "--json"])
    assert rc == 1 and json.loads(out)["failing"] == ["serving_error_rate"]
    rc, out, _ = _run(["slo", "check", "--report", str(report), "--strict", "--json"])
    assert rc == 1 and json.loads(out)["failing"] == ["serving_error_rate", "ttft_p99"]
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps({"results": {"serving": {"extra": {"slo": {
        **doc, "objectives": [], "firing": [], "ok": True}}}}}))
    assert _run(["slo", "check", "--report", str(bench)])[0] == 0
    (tmp_path / "none.json").write_text("{}")
    assert _run(["slo", "check", "--report", str(tmp_path / "none.json")])[0] == 2


def test_cli_slo_unusable_sources_exit_2():
    rc, _, err = _run(["slo", "status", "--url", "https://host:8008"])
    assert rc == 2 and "only http://" in err
    assert _run(["slo", "check", "--url", "http://127.0.0.1:9"])[0] == 2
    assert _run(["top", "--url", "http://127.0.0.1:9", "--once"])[0] == 2
