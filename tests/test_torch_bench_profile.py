"""``bench profile`` of the port: flight-recorder spans and a
``torch.profiler`` trace merged into ONE Perfetto file, on the CPU.

The merge is held to JAX's ``_merge_profiler_events`` on the same synthetic
events (pid offset, clock shift, dropped count); the alignment of a real
``torch.profiler`` trace to the recorder's wall clock (Kineto's timestamps
are relative to the trace's ``baseTimeNanoseconds``) is held to a few
milliseconds; and a real profile of ``feeder_e2e`` carries the host spans
with their flow arrows, the profiler's lanes on offset pids inside the
host window, and the achieved-FLOPs/s block priced from its ``train_step``
spans.
"""

import json
import time

import pytest

from dss_ml_at_scale_tpu.bench import profile as jax_profile
from dss_ml_at_scale_tpu_torch.bench import profile as prof
from dss_ml_at_scale_tpu_torch.bench.profile import PROFILER_PID_OFFSET


def _synthetic(relative: bool) -> list[dict]:
    t0 = 5_000.0 if relative else 1.79e15
    return [
        {"ph": "M", "name": "process_name", "pid": 7, "tid": 0, "args": {"name": "python"}},
        {"ph": "X", "name": "aten::mm", "pid": 7, "tid": 7, "ts": t0, "dur": 12.0},
        {"ph": "X", "name": "tiny", "pid": 7, "tid": 7, "ts": t0 + 1, "dur": 0.5},
        {"ph": "X", "name": "kernel", "cat": "kernel", "pid": 0, "tid": 7, "ts": t0 + 3,
         "dur": 40.0},
        {"ph": "i", "name": "marker", "ts": t0 + 2},
        {"ph": "X", "name": "bad pid", "pid": "gpu", "tid": 1, "ts": t0 + 4, "dur": 9.0},
    ]


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("floor", [0.0, 5.0])
def test_merge_equals_jax(relative, floor):
    events = _synthetic(relative)
    wall = 1.792e15
    ours, dropped = prof._merge_profiler_events(events, wall, floor)
    theirs, jax_dropped = jax_profile._merge_profiler_events(events, wall, floor)
    assert dropped == jax_dropped == (1 if floor else 0)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if a.get("ph") == "M":
            assert a["args"]["name"] == "torch: python"
            assert b["args"]["name"] == "jax: python"
            a, b = {**a, "args": None}, {**b, "args": None}
        assert a == b
    assert all(e["pid"] >= PROFILER_PID_OFFSET for e in ours)
    xs = [e["ts"] for e in ours if e.get("ph") == "X"]
    assert (min(xs) == wall) if relative else (min(xs) == 1.79e15)


def test_merge_adds_the_kineto_base(tmp_path):
    """A Kineto trace's ``ts`` counts from ``baseTimeNanoseconds`` (and can
    exceed JAX's epoch floor, so JAX's rule alone would leave it
    unaligned): the merge adds the base back, whatever the wall start."""
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"baseTimeNanoseconds": 1_790_000_000_000_000_000,
                                 "traceEvents": _synthetic(False)[:2] + [
                                     {"ph": "X", "name": "op", "pid": 1, "tid": 1,
                                      "ts": 2.5e12, "dur": 10.0}]}))
    events, base_us = prof._load_profiler_trace(str(trace))
    assert base_us == 1.79e15 and len(events) == 3
    merged, dropped = prof._merge_profiler_events(events, 123.0, 5.0, base_us)
    assert dropped == 0
    assert [e["ts"] for e in merged if e.get("ph") == "X"] == [1.79e15 + 1.79e15,
                                                               1.79e15 + 2.5e12]
    assert prof._load_profiler_trace(str(tmp_path / "missing.json")) == ([], 0.0)


def test_torch_profiler_clock_aligned_to_wall(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as p:
        wall = time.time()
        with record_function("bench.mark"):
            time.sleep(0.02)
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events, base_us = prof._load_profiler_trace(str(path))
    merged, _ = prof._merge_profiler_events(events, 0.0, 0.0, base_us)
    (mark,) = [e for e in merged if e.get("name") == "bench.mark"]
    assert abs(mark["ts"] - wall * 1e6) < 5e3  # microseconds: within 5 ms
    assert mark["dur"] >= 2e4 * 0.9


def test_profile_merges_spans_and_profiler_events(tmp_path):
    out = tmp_path / "merged.json"
    report = prof.profile_scenario("feeder_e2e", out, repetitions=1, device="cpu")
    assert report["spans"] > 0 and report["flows"] > 0
    trace = json.loads(out.read_text())
    evs = trace["traceEvents"]
    host = [e for e in evs if e.get("pid", 0) < PROFILER_PID_OFFSET]
    torch_lanes = [e for e in evs if e.get("pid", 0) >= PROFILER_PID_OFFSET]
    names = {e["name"] for e in host if e.get("ph") == "X"}
    assert {"reader.next", "feeder.place", "train_step"} <= names
    assert any(e.get("ph") in ("s", "f") for e in host)
    assert report["profiler_events"] == len(torch_lanes) > 0
    assert report["kernel_events"] == 0  # no CUDA activity on the CPU
    lanes = [e for e in torch_lanes if e.get("ph") == "M" and e.get("name") == "process_name"]
    assert lanes and all(e["args"]["name"].startswith("torch: ") for e in lanes)
    # One timeline: the train steps' aten ops lie inside the host window.
    w0, w1 = report["window_us"]
    ops = [e["ts"] for e in torch_lanes if e.get("ph") == "X"
           and str(e.get("name", "")).startswith("aten::")]
    assert ops and sum(w0 <= t <= w1 for t in ops) > len(ops) // 4
    assert report["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    block = report["mfu"]
    assert block["entrypoint"] == "train_step.classifier" and block["utilization"] is None
    assert block["steps_per_sec"] > 0 and block["achieved_flops_per_sec"] > 0
