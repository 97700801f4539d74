"""The port's trace tooling against the JAX package's, and on a port run.

- ``to_perfetto`` and ``merge_replica_spans`` give the same Perfetto JSON
  in both packages for the same span lists and files;
- ``trace attribution --json`` and ``trace export`` read one file to the
  same report in both CLIs;
- a CPU ``train --device cpu`` run of the port leaves ``flightrec.jsonl``
  registered in its journal (with the alert journal), with per-step traces
  joining the feeder thread's ``reader.next``/``feeder.place`` and the
  loop's ``train_step`` (JAX's ``tests/test_trace.py`` feeder case), and
  ``trace attribution``, ``trace export`` and ``telemetry --run`` read it.
Host Python throughout: equal as JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import time

import pytest

from dss_ml_at_scale_tpu import telemetry as jax_telemetry
from dss_ml_at_scale_tpu.config.cli import main as jax_main
from dss_ml_at_scale_tpu.telemetry import flightrec as jax_flightrec
from dss_ml_at_scale_tpu.telemetry import spans as jax_spans
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.data.prefetch import Feeder
from dss_ml_at_scale_tpu_torch.telemetry import flightrec, spans, tracecontext
from dss_ml_at_scale_tpu_torch.telemetry.spans import SpanLog


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    for mod in (telemetry, jax_telemetry):
        mod.reset()
    flightrec.disable()
    jax_flightrec.disable()
    yield
    flightrec.disable()
    jax_flightrec.disable()
    for mod in (telemetry, jax_telemetry):
        mod.reset()


def _run(entry, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry(argv)
    return rc, out.getvalue()


def _span_list() -> list[dict]:
    """Spans of two traces over three threads of two processes."""
    def sp(name, ts, dur, pid, tid, thread, trace=None, **args):
        e = {"name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid, "thread": thread}
        if trace:
            e.update(trace=trace, span=f"{int(ts * 1000):08x}", parent="00000001",
                     kind="step")
        if args:
            e["args"] = args
        return e
    return [
        sp("reader.next", 1.000, 0.002, 10, 2, "feeder-train", "aa11bb22cc33dd44", feeder="train"),
        sp("feeder.place", 1.002, 0.001, 10, 2, "feeder-train", "aa11bb22cc33dd44"),
        sp("train_step", 1.010, 0.050, 10, 1, "MainThread", "aa11bb22cc33dd44", step=0),
        sp("reader.next", 1.020, 0.003, 10, 2, "feeder-train", "0011223344556677"),
        sp("train_step", 1.070, 0.040, 10, 1, "MainThread", "0011223344556677", step=1),
        sp("serve.request", 1.030, 0.010, 11, 1, "handler", "0011223344556677"),
        sp("untraced", 0.5, 0.1, 10, 1, "MainThread"),
    ]


def test_to_perfetto_equals_jax():
    events = _span_list()
    names = {10: "trainer", 11: "server"}
    got = spans.to_perfetto(events, process_names=names)
    assert got == jax_spans.to_perfetto(events, process_names=names)
    assert sum(1 for e in got["traceEvents"] if e["ph"] in ("s", "f")) >= 4
    assert spans.to_perfetto(events) == jax_spans.to_perfetto(events)


def test_merge_replica_spans_equals_jax(tmp_path):
    events = _span_list()
    a = tmp_path / "replica0.jsonl"
    a.write_text("".join(json.dumps(e) + "\n" for e in events[:4]))
    # The second replica's file is a flight-recorder tail with an open span.
    b = tmp_path / "flightrec.jsonl"
    rec = flightrec.FlightRecorder()
    rec.enable(b)
    for e in events[4:]:
        rec.emit({**e, "ph": "X"})
    rec.emit({**events[2], "ph": "B", "name": "checkpoint", "ts": 2.0})
    rec.disable()
    merged, names = spans.merge_replica_spans([a, b])
    jax_merged, jax_names = jax_spans.merge_replica_spans([a, b])
    assert (merged, names) == (jax_merged, jax_names)
    assert spans.to_perfetto(merged, names) == jax_spans.to_perfetto(jax_merged, jax_names)
    assert any(e.get("args", {}).get("open") for e in merged)


def _fake_run(tmp_path):
    """A small training timeline on a port recorder tail: two complete
    steps (one slow) and an open one, the feeder's spans on a thread."""
    tail = tmp_path / "flightrec.jsonl"
    flightrec.enable(tail)
    log = SpanLog()

    def feed(handoff):
        with handoff.activate():
            with log.span("reader.next", feeder="train"):
                pass
            with log.span("feeder.place", feeder="train"):
                pass

    open_cm = None
    for i, dur in enumerate((0.001, 0.03, None)):
        with tracecontext.trace(kind="step"):
            t = threading.Thread(target=feed, args=(tracecontext.Handoff.capture(),),
                                 name="feeder-train")
            t.start()
            t.join(timeout=10)
            if dur is None:
                open_cm = log.span("train_step", step=i)
                open_cm.__enter__()
            else:
                with log.span("train_step", step=i):
                    time.sleep(dur)
    flightrec.disable()
    return tail, open_cm


@pytest.mark.parametrize("args", [["--json"], [], ["--zscore", "0.9", "--json"]],
                         ids=["json", "table", "anomaly"])
def test_trace_attribution_equals_jax(tmp_path, args):
    tail, open_cm = _fake_run(tmp_path)
    argv = ["trace", "attribution", "--file", str(tail), *args]
    got, want = _run(main, argv), _run(jax_main, argv)
    assert got == want and got[0] == 0
    if "--json" in args:
        report = json.loads(got[1])
        assert report["steps"] == 2 and report["open_spans"] == ["train_step"]
    open_cm.__exit__(None, None, None)


def test_trace_export_equals_jax(tmp_path):
    tail, open_cm = _fake_run(tmp_path)
    out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    rc, text = _run(main, ["trace", "export", "--file", str(tail), "--out", str(out)])
    jax_rc, jax_text = _run(jax_main, ["trace", "export", "--file", str(tail),
                                       "--out", str(jax_out)])
    assert rc == jax_rc == 0
    assert text.replace(str(out), "OUT") == jax_text.replace(str(jax_out), "OUT")
    assert json.loads(out.read_text()) == json.loads(jax_out.read_text())
    assert _run(main, ["trace", "export", "--merge", str(tail), str(tmp_path / "nope"),
                       "--out", str(out)])[0] == 2
    open_cm.__exit__(None, None, None)


def test_feeder_thread_and_consumer_share_one_step_trace():
    feeder = Feeder(iter([{"i": [0]}, {"i": [1]}]), "cpu", name="t")
    traces = []
    try:
        for batch, _prov in feeder:
            with feeder.last_handoff.activate(), telemetry.span("train_step",
                                                                step=int(batch["i"][0])):
                pass
            traces.append(feeder.last_handoff.ctx.trace_id)
    finally:
        feeder.close()
    assert len(set(traces)) == 2
    events = telemetry.get_span_log().events()
    for trace_id in traces:
        group = [e for e in events if e.get("trace") == trace_id]
        assert {"reader.next", "feeder.place", "train_step"} <= {e["name"] for e in group}
        tids = {e["name"]: e["tid"] for e in group}
        assert tids["train_step"] == threading.get_ident() != tids["reader.next"]
    snap = {(m["name"], tuple((m.get("labels") or {}).items())): m
            for m in telemetry.snapshot()["metrics"]}
    assert snap[("feeder_batches_total", (("feeder", "t"),))]["value"] == 2
    assert snap[("feeder_depth", (("feeder", "t"),))]["value"] == 2


@pytest.fixture(scope="module")
def cpu_train_run(tmp_path_factory):
    """One ``train --device cpu`` run of the port (tiny model, 2 epochs of
    3 steps, a val table): its run directory and summary."""
    from dss_ml_at_scale_tpu_torch.datagen.images import write_image_delta

    work = tmp_path_factory.mktemp("train")
    write_image_delta(work / "data", 48, classes=4, size=32, seed=0, mode="overwrite")
    telemetry.reset()
    rc, out = _run(main, [
        "train", "--data", str(work / "data"), "--val-data", str(work / "data"),
        "--model", "tiny", "--num-classes", "4", "--crop", "32", "--batch-size", "16",
        "--epochs", "2", "--learning-rate", "0.01", "--workers", "1", "--no-shuffle",
        "--limit-val-batches", "1", "--checkpoint-dir", str(work / "ck"),
        "--tracking-root", str(work / "runs"), "--device", "cpu"])
    flightrec.disable()
    assert rc == 0, out
    run_dir = next((work / "runs" / "imagenet").iterdir())
    return run_dir, json.loads(out.strip().splitlines()[-1])


def test_cpu_train_run_records_and_registers_its_tails(cpu_train_run):
    from dss_ml_at_scale_tpu_torch.tracking import classify_run, read_journal

    run_dir, summary = cpu_train_run
    cls = classify_run(run_dir)
    assert cls["trace_file"] == str((run_dir / "flightrec.jsonl").absolute())
    assert cls["alerts_file"] == str((run_dir / "alerts.jsonl").absolute())
    assert (run_dir / "alerts.jsonl").is_file()  # empty: no alert moved
    assert {"trace", "slo_journal"} <= {e["event"] for e in read_journal(run_dir)}
    complete, opens = flightrec.reconstruct(flightrec.read_events(run_dir / "flightrec.jsonl"))
    assert opens == []  # a finished run closes every span
    names = [e["name"] for e in complete]
    assert names.count("fit") == 1 and names.count("train_step") == summary["steps"] == 6
    assert names.count("train_epoch") == names.count("eval") == 2
    assert names.count("checkpoint") == names.count("checkpoint.finalize") == 2
    steps = {}
    for e in complete:
        if e.get("kind") == "step":
            steps.setdefault(e["trace"], []).append(e)
    stepped = [g for g in steps.values() if any(e["name"] == "train_step" for e in g)]
    assert len(stepped) == 6
    for group in stepped:
        threads = {e["name"]: e["thread"] for e in group}
        assert threads["reader.next"] == threads["feeder.place"] == "feeder-train"
        assert threads["train_step"] == "MainThread"
    # The save runs under the trace of the step it follows.
    saves = [e for e in complete if e["name"] == "checkpoint"]
    assert all(any(x["name"] == "train_step" for x in steps[s["trace"]]) for s in saves)
    # The run's root span is under its own run trace.
    fit = next(e for e in complete if e["name"] == "fit")
    assert fit["kind"] == "run" and fit["args"] == {"max_epochs": 2}


def test_cpu_train_run_through_the_trace_commands(cpu_train_run, tmp_path):
    run_dir, _ = cpu_train_run
    rc, out = _run(main, ["trace", "attribution", "--run", str(run_dir), "--json"])
    report = json.loads(out)
    assert rc == 0 and report["steps"] == 6 and report["compute_ms_mean"] > 0
    for step in report["per_step"]:
        assert step["compute"] > 0
    # JAX's command reads the port's run directory to the same report.
    assert _run(jax_main, ["trace", "attribution", "--run", str(run_dir), "--json"]) == (rc, out)
    rc, out = _run(main, ["trace", "export", "--run", str(run_dir),
                          "--out", str(tmp_path / "t.json")])
    doc = json.loads((tmp_path / "t.json").read_text())
    assert rc == 0 and any(e["ph"] == "s" for e in doc["traceEvents"])
    rc, out = _run(main, ["trace", "tail", "--run", str(run_dir), "--json", "-n", "4"])
    assert rc == 0 and len(out.strip().splitlines()) == 4


def test_cpu_train_run_through_the_telemetry_command(cpu_train_run, tmp_path):
    run_dir, summary = cpu_train_run
    rc, out = _run(main, ["telemetry", "--run", str(run_dir), "--json"])
    snap = {m["name"]: m for m in json.loads(out)["metrics"] if not m.get("labels")}
    assert rc == 0 and snap["train_step_seconds"]["count"] == summary["steps"]
    assert snap["train_step_window_seconds"]["count"] == summary["steps"]
    assert snap["train_throughput_rows_per_sec"]["value"] > 0
    assert snap["train_compile_events_total"]["value"] == 0  # no kernel on the CPU
    rc, out = _run(main, ["telemetry", "--run", str(run_dir)])
    assert rc == 0 and "train_step_seconds" in out and "feeder_stall_seconds_total" in out
    rc, out = _run(main, ["telemetry", "--run", str(run_dir),
                          "--export-perfetto", str(tmp_path / "p.json")])
    assert rc == 0 and (tmp_path / "p.json").exists()
    assert _run(main, ["telemetry"])[0] == 2


def test_device_monitor_and_compile_tracker_on_the_cpu():
    from dss_ml_at_scale_tpu_torch.telemetry import MetricsRegistry
    from dss_ml_at_scale_tpu_torch.telemetry.device import (
        CompileTracker,
        DeviceMonitor,
        device_memory_stats,
    )

    registry = MetricsRegistry()
    with DeviceMonitor(registry, devices=["cpu"], interval_s=0.01):
        time.sleep(0.05)
    supported = registry.gauge("device_memory_stats_supported", labels=("device",))
    assert supported.labels(device="cpu:0").value == 0.0  # the JAX monitor's CPU answer
    assert registry.counter("device_monitor_samples_total")._children[()].value >= 1
    assert device_memory_stats("cpu") == {}
    counter = registry.counter("train_compile_events_total")
    tracker = CompileTracker(counter)
    assert tracker.update() == 0 and counter._children[()].value == 0
