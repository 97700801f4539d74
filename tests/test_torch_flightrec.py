"""The port's flight recorder against the JAX package's, on the same events.

``telemetry/flightrec.py`` of the port is a copy of the JAX module: the
same event sequence through both recorders writes the same tail lines and
reconstructs to the same spans, a torn tail heals, the tail rotates, and
``disable`` is scoped to its path. The port's ``trace tail`` reads a tail
the JAX package wrote exactly as JAX's ``trace tail`` does (JAX's
``tests/test_trace.py`` flight-recorder cases, on the port). Host Python
throughout: equal as JSON, with the recorder-start meta line's time and
argv taken out.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading

import pytest

from dss_ml_at_scale_tpu import telemetry as jax_telemetry
from dss_ml_at_scale_tpu.config.cli import main as jax_main
from dss_ml_at_scale_tpu.telemetry import flightrec as jax_flightrec
from dss_ml_at_scale_tpu.telemetry import tracecontext as jax_tc
from dss_ml_at_scale_tpu.telemetry.spans import SpanLog as JaxSpanLog
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.telemetry import flightrec, tracecontext
from dss_ml_at_scale_tpu_torch.telemetry.spans import SpanLog, load_span_jsonl


@pytest.fixture(autouse=True)
def _fresh_recorders():
    for mod in (telemetry, jax_telemetry):
        mod.reset()
    flightrec.disable()
    jax_flightrec.disable()
    yield
    flightrec.disable()
    jax_flightrec.disable()
    for mod in (telemetry, jax_telemetry):
        mod.reset()


def _events() -> list[dict]:
    """A fixed event sequence: two traces, a B/E pair, an X, an open B,
    and two spans sharing a span id across traces."""
    base = {"pid": 4242, "tid": 7, "thread": "MainThread"}
    return [
        {**base, "ph": "B", "name": "fit", "ts": 1.0, "trace": "t0", "span": "s0",
         "parent": "r0", "kind": "run", "args": {"max_epochs": 2}},
        {**base, "ph": "B", "name": "train_step", "ts": 2.0, "trace": "t1", "span": "s1",
         "parent": "p1", "kind": "step", "args": {"step": 0}},
        {**base, "ph": "E", "name": "train_step", "ts": 2.0, "dur": 0.25, "trace": "t1",
         "span": "s1", "parent": "p1", "kind": "step", "args": {"step": 0}},
        {**base, "ph": "X", "name": "train_epoch", "ts": 1.5, "dur": 1.0,
         "args": {"epoch": 0, "steps": 1}},
        {**base, "ph": "B", "name": "checkpoint", "ts": 3.0, "trace": "t2", "span": "s1",
         "parent": "p2", "kind": "step", "args": {"step": 1}},
    ]


def _tail_lines(path) -> list[dict]:
    rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    for r in rows:
        if r.get("ph") == "M":  # the recorder-start meta: this process's clock and argv
            r.pop("ts")
            r["args"].pop("argv")
    return rows


def test_same_events_give_the_same_tail_and_reconstruction(tmp_path):
    jax_rec = jax_flightrec.FlightRecorder()
    rec = flightrec.FlightRecorder()
    jax_rec.enable(tmp_path / "jax.jsonl")
    rec.enable(tmp_path / "port.jsonl")
    for e in _events():
        jax_rec.emit(dict(e))
        rec.emit(dict(e))
    jax_rec.disable()
    rec.disable()
    assert _tail_lines(tmp_path / "port.jsonl") == _tail_lines(tmp_path / "jax.jsonl")
    events = [e for e in flightrec.read_events(tmp_path / "port.jsonl") if e["ph"] != "M"]
    assert events == [e for e in jax_flightrec.read_events(tmp_path / "jax.jsonl")
                      if e["ph"] != "M"]
    got = flightrec.reconstruct(events)
    assert got == jax_flightrec.reconstruct(events)
    complete, opens = got
    assert [e["name"] for e in complete] == ["train_epoch", "train_step"]
    assert [e["name"] for e in opens] == ["fit", "checkpoint"]
    # The live view: the same events, oldest first, in both.
    assert rec.tail(3) == jax_rec.tail(3)


def test_torn_tail_heals_and_open_spans_survive(tmp_path):
    tail = tmp_path / "flightrec.jsonl"
    flightrec.enable(tail)
    log = SpanLog()
    with tracecontext.trace(kind="step"):
        with log.span("closed_span"):
            pass
        cm = log.span("train_step", step=7)  # entered, never exited: a kill
        cm.__enter__()
    flightrec.disable()
    with open(tail, "a", encoding="utf-8") as f:
        f.write('{"ph": "B", "name": "torn')  # a kill mid-append
    complete, opens = flightrec.reconstruct(flightrec.read_events(tail))
    assert [e["name"] for e in complete] == ["closed_span"]
    assert [e["name"] for e in opens] == ["train_step"] and opens[0]["args"] == {"step": 7}
    assert [e["name"] for e in load_span_jsonl(tail)
            if e.get("args", {}).get("open")] == ["train_step"]
    # The next append heals the torn line instead of gluing onto it.
    flightrec.enable(tail)
    flightrec.disable()
    assert jax_flightrec.read_events(tail) == flightrec.read_events(tail)
    assert flightrec.read_events(tail)[-1]["name"] == "recorder_start"
    cm.__exit__(None, None, None)


def test_rotation_keeps_the_previous_generation(tmp_path):
    tail = tmp_path / "flightrec.jsonl"
    rec = flightrec.FlightRecorder(max_bytes=2048)
    rec.enable(tail)
    for i in range(60):
        rec.emit({"ph": "X", "name": "s", "ts": float(i), "dur": 0.0, "span": f"{i:08x}",
                  "args": {"i": i}})
    rec.disable()
    assert tail.with_name(tail.name + ".1").exists()
    events = [e for e in flightrec.read_events(tail) if e.get("name") == "s"]
    # The chain reads oldest first, the newest event last, and nothing
    # newer than the rotation point is lost.
    assert events[-1]["args"]["i"] == 59
    assert [e["args"]["i"] for e in events] == sorted(e["args"]["i"] for e in events)
    assert flightrec.read_events(tail) == jax_flightrec.read_events(tail)


def test_disable_is_scoped_to_its_path(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    flightrec.enable(a)
    flightrec.enable(b)  # a newer run re-targets
    flightrec.disable(a)  # a stale disable: no-op
    assert flightrec.get_recorder().path == b
    flightrec.disable(b)
    assert flightrec.get_recorder().path is None


def test_recorder_bytes_counter_and_per_thread_rings(tmp_path):
    flightrec.enable(tmp_path / "t.jsonl")
    log = SpanLog()

    def work():
        with log.span("trial"):
            pass

    t = threading.Thread(target=work, name="worker")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    with log.span("fit"):
        pass
    flightrec.disable()
    names = [e["name"] for e in flightrec.get_recorder().tail(8)]
    assert names.count("trial") == 2 and names.count("fit") == 2  # B and E each
    fam = telemetry.get_registry().counter("flight_recorder_bytes_total")
    assert fam._children[()].value == (tmp_path / "t.jsonl").stat().st_size


def _jax_tail(tmp_path):
    """A tail written by the JAX package: steps on a feeder thread and the
    loop, one of them left open, plus a torn last line."""
    tail = tmp_path / "flightrec.jsonl"
    jax_flightrec.enable(tail)
    log = JaxSpanLog()

    def feed(handoff):
        with handoff.activate():
            with log.span("reader.next", feeder="train"):
                pass
            with log.span("feeder.place", feeder="train"):
                pass

    open_cm = None
    for i in range(3):
        with jax_tc.trace(kind="step"):
            t = threading.Thread(target=feed, args=(jax_tc.Handoff.capture(),),
                                 name="feeder-train")
            t.start()
            t.join(timeout=10)
            if i == 2:
                open_cm = log.span("train_step", step=i)
                open_cm.__enter__()
            else:
                with log.span("train_step", step=i):
                    pass
    jax_flightrec.disable()
    with open(tail, "a", encoding="utf-8") as f:
        f.write('{"ph": "E", "name": "tor')
    return tail, open_cm


def _run(entry, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = entry(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("args", [["--json"], [], ["-n", "2"], ["-n", "0", "--json"]],
                         ids=["json", "table", "window", "opens-only"])
def test_trace_tail_of_a_jax_tail_equals_jax(tmp_path, args):
    tail, open_cm = _jax_tail(tmp_path)
    argv = ["trace", "tail", "--file", str(tail), *args]
    jax_rc, jax_out = _run(jax_main, argv)
    rc, out = _run(main, argv)
    assert (rc, out) == (jax_rc, jax_out)
    assert rc == 0 and "train_step" in out
    open_cm.__exit__(None, None, None)


def test_trace_tail_usage_errors(tmp_path):
    assert _run(main, ["trace", "tail"])[0] == 2
    assert _run(main, ["trace", "tail", "--file", str(tmp_path / "nope")])[0] == 2
    empty = tmp_path / "empty.jsonl"
    empty.write_text("not json\n")
    assert _run(main, ["trace", "tail", "--file", str(empty)]) == \
        _run(jax_main, ["trace", "tail", "--file", str(empty)])


def test_durable_append_heals_a_torn_tail_as_jax_does(tmp_path):
    from dss_ml_at_scale_tpu.resilience import durability as jax_durability
    from dss_ml_at_scale_tpu_torch.resilience import durability

    rows = [{"ph": "X", "name": "a", "ts": 1.0}, {"ph": "B", "name": "b", "ts": 2.0}]
    for name, mod in (("port", durability), ("jax", jax_durability)):
        path = tmp_path / f"{name}.jsonl"
        path.write_text('{"ph": "X", "name": "whole"}\n{"ph": "E", "na')  # a kill mid-append
        assert mod.append_jsonl(path, rows, kind="flightrec", fsync=False) > 0
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert [e["name"] for e in flightrec.read_events(tmp_path / "port.jsonl")] == \
        ["whole", "a", "b"]
