"""Achieved-FLOPs/s gauges priced by the audit-pinned cost budgets.

Port of ``dss_ml_at_scale_tpu/bench/mfu.py``. ``audit`` already commits a
FLOPs budget for every production entrypoint, per device
(``analysis/baselines/audit.json``: ``programs[name]["cpu"|"cuda"]
["flops"]``, the FLOPs ``torch.utils.flop_counter``'s formulas count for
the recorded call). Multiplying that pin by a *measured* steps/sec gives
an achieved-FLOPs/s figure and, divided by the card's peak for the
arithmetic the program runs, an MFU-style utilization, with **no new
tracing**: the steps/sec comes from a bench scenario's timed repetitions
or from the flight recorder's ``train_step`` spans.

The gauges land on the process-default registry, so any process that
serves ``GET /metrics`` exposes them after publishing.

Honesty contract: the pin prices ONE program on one device. Publish only
for steps/sec measured on the entrypoint the pin names, on the device the
pin was recorded for: the scenarios that opt in (``Scenario.entrypoint``)
run the audited program itself through its registry builder.

The peak table holds NVIDIA's dense figures for the H100 SXM5, keyed by
the name ``nvidia-smi`` prints. Which peak divides: the audited programs
the scenarios price are float32 (``analysis/audit/entrypoints.py``), so a
program takes the TF32 peak when cuDNN may run its convolutions in TF32
(``torch.backends.cudnn.allow_tf32``, on by default and left so by the
trainer) and the FP32 peak otherwise; the bf16 figure is the card's for a
bfloat16 program.
"""

from __future__ import annotations

import json
from pathlib import Path

# Dense peaks per card (FLOP/s), by arithmetic.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "tf32": 494.7e12, "fp32": 66.9e12},
}


def peak_arithmetic() -> str:
    """The arithmetic a float32 program runs on the card: ``tf32`` or
    ``fp32``, as cuDNN's TF32 switch stands in this process."""
    import torch

    return "tf32" if torch.backends.cudnn.allow_tf32 else "fp32"


def pinned_flops(entrypoint: str, device: str = "cuda",
                 baseline_path: Path | None = None) -> float | None:
    """The audit-committed FLOPs budget of ``entrypoint`` on ``device``
    (``cpu`` or ``cuda``), or None when the entrypoint is unpinned there
    (or the budget was recorded cost-less)."""
    from ..analysis.audit.core import DEFAULT_AUDIT_BASELINE

    path = DEFAULT_AUDIT_BASELINE if baseline_path is None else baseline_path
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None
    prog = data.get("programs", {}).get(entrypoint)
    if not isinstance(prog, dict):
        return None
    rec = prog.get(device.split(":")[0])
    if not isinstance(rec, dict):
        return None
    flops = rec.get("flops")
    return float(flops) if flops else None


def publish_achieved(entrypoint: str, steps_per_sec: float, *,
                     device_kind: str | None = None, device: str = "cuda",
                     baseline_path: Path | None = None) -> dict | None:
    """Set the achieved-FLOPs/s (and, when the card's peak is known,
    utilization) gauges for ``entrypoint``; returns the published block
    or None when the entrypoint has no pinned budget on ``device``."""
    from .. import telemetry

    flops = pinned_flops(entrypoint, device, baseline_path)
    if flops is None or steps_per_sec <= 0:
        return None
    achieved = flops * steps_per_sec
    telemetry.gauge(
        "entrypoint_achieved_flops_per_sec",
        "measured steps/sec times the audit-pinned FLOPs budget",
        labels=("entrypoint",),
    ).labels(entrypoint=entrypoint).set(achieved)
    block = {
        "entrypoint": entrypoint,
        "steps_per_sec": round(steps_per_sec, 4),
        "flops_per_step": flops,
        "achieved_flops_per_sec": achieved,
        "utilization": None,
        "arithmetic": None,
        "peak_flops_per_sec": None,
    }
    peaks = PEAK_FLOPS.get(device_kind or "")
    if peaks:
        arith = peak_arithmetic()
        util = achieved / peaks[arith]
        telemetry.gauge(
            "entrypoint_flops_utilization",
            "achieved FLOPs/s over the card's peak for the program's arithmetic",
            labels=("entrypoint",),
        ).labels(entrypoint=entrypoint).set(util)
        block.update(utilization=util, arithmetic=arith,
                     peak_flops_per_sec=peaks[arith])
    return block


def publish_from_trace(tail_path, entrypoint: str, *,
                       span_name: str = "train_step",
                       device_kind: str | None = None, device: str = "cuda",
                       baseline_path: Path | None = None) -> dict | None:
    """Price an existing flight-recorder tail: ``span_name`` arrival
    rate -> steps/sec -> :func:`publish_achieved`. No new tracing: the
    recorder was already on.

    Steps/sec is spans over the WALL window (first open to last close),
    not ``1/mean(duration)``: inter-step gaps (data wait, exactly what a
    stalled run has) must depress achieved FLOPs/s, or the utilization
    gauge would read *inflated* on the runs it exists to diagnose. A
    single span has no window and falls back to its own duration.
    """
    from ..telemetry import flightrec

    complete, _opens = flightrec.reconstruct(
        flightrec.read_events(tail_path)
    )
    spans = sorted(
        (e for e in complete
         if e.get("name") == span_name and e.get("dur", 0.0) > 0),
        key=lambda e: e.get("ts", 0.0),
    )
    if not spans:
        return None
    window = (spans[-1].get("ts", 0.0) + spans[-1].get("dur", 0.0)
              - spans[0].get("ts", 0.0))
    if window <= 0:
        window = spans[0]["dur"]
    return publish_achieved(
        entrypoint, len(spans) / window, device_kind=device_kind,
        device=device, baseline_path=baseline_path,
    )
