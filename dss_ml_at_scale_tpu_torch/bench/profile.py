"""``bench profile``: host spans + device trace on ONE timeline.

Port of ``dss_ml_at_scale_tpu/bench/profile.py``, with ``torch.profiler``
(CPU and, on a card, CUDA activities) where JAX runs ``jax.profiler``.
The profiler answers "what did the device do" (aten ops, CUDA kernels and
copies on their streams); the flight recorder answers "what did the
runtime do" (feeder handoffs, step dispatch, with cross-thread flow
arrows). Debugging an input stall or a dispatch gap needs both on the SAME
timeline, so this module runs one scenario under both recorders and
merges the results into a single Perfetto ``trace_event`` file:

- the flight-recorder tail renders through
  :func:`~dss_ml_at_scale_tpu_torch.telemetry.spans.to_perfetto`: lanes
  named after runtime threads, ``ph s/f`` flow arrows intact;
- the profiler's Chrome-trace events ride along with their pids offset
  into a dedicated range (no collision with host pids) and their clock
  aligned to the recorder's wall clock. Kineto writes each ``ts`` relative
  to the trace's ``baseTimeNanoseconds`` (an epoch time): the merge adds
  that base back. A trace without a base whose timestamps lie below the
  epoch floor is shifted to the run's wall start, as JAX's merge does.

When the profiled scenario declares an audited ``entrypoint``, its
``train_step`` spans are also priced into the achieved-FLOPs/s gauges
(:mod:`.mfu`) with the card's name: the profile run doubles as a
utilization reading.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

# Profiler pids land here so device lanes can never collide with host
# process pids in the merged file.
PROFILER_PID_OFFSET = 1 << 20

# Timestamps above this are epoch-anchored microseconds (~year 2001+);
# below, the profiler wrote trace-relative time and needs aligning.
_EPOCH_US_FLOOR = 1e12


def _load_profiler_trace(path: str) -> tuple[list[dict], float]:
    """(events, base in microseconds) of one exported Chrome trace; the
    base is 0 when the trace carries none."""
    try:
        with open(path, encoding="utf-8") as fh:
            trace = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return [], 0.0
    evs = trace.get("traceEvents", [])
    events = [e for e in evs if isinstance(e, dict)] if isinstance(evs, list) else []
    base_ns = trace.get("baseTimeNanoseconds")
    return events, (float(base_ns) / 1e3 if base_ns else 0.0)


def _merge_profiler_events(events: list[dict], wall_start_us: float,
                           min_dur_us: float, base_us: float = 0.0,
                           ) -> tuple[list[dict], int]:
    """Offset pids into the profiler range, align the clock, and floor
    event durations. Complete events shorter than ``min_dur_us`` are
    dropped and COUNTED (the report and the CLI both surface the number:
    a silent cap would read as full coverage). Metadata rows always
    survive.

    ``base_us`` (the trace's ``baseTimeNanoseconds`` in microseconds) is
    added to every timestamp; with no base, timestamps below the epoch
    floor are shifted so the first lands on ``wall_start_us``."""
    shift = base_us
    if not shift:
        xs = [e.get("ts") for e in events
              if e.get("ph") in ("X", "B", "E") and e.get("ts") is not None]
        if xs and min(xs) < _EPOCH_US_FLOOR:
            shift = wall_start_us - min(xs)
    out = []
    dropped = 0
    for e in events:
        if (e.get("ph") == "X" and min_dur_us > 0
                and float(e.get("dur", 0.0) or 0.0) < min_dur_us):
            dropped += 1
            continue
        e2 = dict(e)
        try:
            # pid-less events (clock-sync markers) still get a pid so
            # every profiler event lands in the offset lane range.
            e2["pid"] = int(e2.get("pid", 0)) + PROFILER_PID_OFFSET
        except (TypeError, ValueError):
            e2["pid"] = PROFILER_PID_OFFSET
        if shift and e2.get("ts") is not None:
            try:
                e2["ts"] = float(e2["ts"]) + shift
            except (TypeError, ValueError):
                pass
        if e2.get("ph") == "M" and e2.get("name") == "process_name":
            args = dict(e2.get("args", {}))
            args["name"] = f"torch: {args.get('name', '?')}"
            e2["args"] = args
        out.append(e2)
    return out, dropped


def profile_scenario(name: str, out_path: str | os.PathLike, *,
                     repetitions: int = 1,
                     min_profiler_dur_us: float = 5.0,
                     device: str = "cuda") -> dict:
    """Run ``name`` once in-process on ``device`` under the flight recorder
    AND ``torch.profiler``; write ONE merged Perfetto file. Returns
    ``{"out", "spans", "flows", "profiler_events",
    "profiler_events_dropped", "kernel_events", "window_us", "launches",
    "mfu"}``: ``kernel_events`` counts the CUDA kernel events kept, and
    ``window_us`` is the recorder's wall window (its first and last
    event). ``min_profiler_dur_us=0`` keeps every profiler event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..telemetry import flightrec
    from ..telemetry.spans import load_span_jsonl, to_perfetto
    from . import mfu
    from .core import environment_fingerprint, get_scenario, measure_scenario

    sc = get_scenario(name)
    out_path = Path(out_path)
    on_card = torch.device(device).type == "cuda"
    env = environment_fingerprint(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with tempfile.TemporaryDirectory(prefix="dsst_bench_prof_") as tmpdir:
        tail = os.path.join(tmpdir, "flightrec.jsonl")
        trace_path = os.path.join(tmpdir, "torch_trace.json")
        flightrec.enable(tail)
        wall_start = time.time()
        try:
            with profile(activities=activities) as prof:
                # warmup=0: a profile wants the trace, not a gated number.
                record = measure_scenario(sc, repetitions=repetitions, warmup=0,
                                          env={}, device=device)
        finally:
            flightrec.disable(tail)
        prof.export_chrome_trace(trace_path)

        spans = load_span_jsonl(tail)
        merged = to_perfetto(spans)
        flows = sum(
            1 for e in merged["traceEvents"] if e.get("ph") in ("s", "f")
        )
        events, base_us = _load_profiler_trace(trace_path)
        profiler_events, dropped = _merge_profiler_events(
            events, wall_start * 1e6, min_profiler_dur_us, base_us,
        )
        merged["traceEvents"].extend(profiler_events)
        host_ts = [e["ts"] for e in merged["traceEvents"]
                   if e.get("ph") == "X" and e.get("pid", 0) < PROFILER_PID_OFFSET]

        block = None
        if sc.entrypoint:
            block = mfu.publish_from_trace(
                tail, sc.entrypoint, device_kind=env["device"], device=env["platform"],
            )

    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(merged, f)
    return {
        "out": str(out_path),
        "spans": len(spans),
        "flows": flows,
        "profiler_events": len(profiler_events),
        "profiler_events_dropped": dropped,
        "kernel_events": sum(1 for e in profiler_events
                             if e.get("ph") == "X" and e.get("cat") == "kernel"),
        "window_us": [min(host_ts), max(host_ts)] if host_ts else None,
        "launches": record.get("launches", {}),
        "mfu": block,
    }
