"""The registered scenarios: JAX's eleven, on the port and on ``--device``.

Port of ``dss_ml_at_scale_tpu/bench/scenarios.py``, each scenario at JAX's
geometry, metrics, floors, repetitions, warm-up, tier and timeout. Each
isolates one seam of the system: decode, reader, device feeding, the
train step, the observability layers' own overhead, the group fit and
serving load. Where a scenario runs an audited program it builds it
through the **audit entrypoint registry** (the same builders ``audit``
records, on the audit's fake 8-rank world and on ``--device``), so the
measured program and the pinned cost budget describe the same dispatches:
that is what makes the achieved-FLOPs/s gauges honest.

Declarations here are reconciled against
``telemetry.catalog.KNOWN_BENCH_METRICS`` in both directions by the
``bench-registry`` lint rule: scenario/metric names must be literal.

The ``feeder_e2e`` scenario self-verifies: its measured wall time is
cross-checked against the flight-recorder attribution buckets (the SAME
``telemetry.catalog.SPAN_ATTRIBUTION`` mapping ``trace attribution``
uses), and an unexplained gap fails the scenario.

On a card every timed window ends on a host read that depends on the last
step (the loss's ``.item()``): CUDA runs asynchronously, and a window
without it would time the dispatch rate.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

from .core import Metric, Scenario, register_scenario

# Geometry shared by the decode/reader stages (JAX's): tiny sources so
# tier-1 children finish in seconds; throughput at this size is a
# *relative* gate (same work every run), not an absolute claim.
_SRC_SIZE = 32
_CROP = 32
_N_IMAGES = 96
_BATCH = 16


def _tiny_jpegs(n: int, size: int, seed: int = 0) -> list[bytes]:
    """Blocky low-frequency JPEGs: realistic decode entropy (pure noise
    inflates decode cost; flat color deflates it)."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        blocks = rng.uniform(0, 255, (8, 8, 3))
        img = np.kron(blocks, np.ones((size // 8, size // 8, 1)))
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(
            buf, format="JPEG", quality=85
        )
        out.append(buf.getvalue())
    return out


def _transform_spec():
    from ..data.transform import imagenet_transform_spec

    return imagenet_transform_spec(
        resize=_CROP + _CROP // 8, crop=_CROP, output_dtype="uint8"
    )


# -- decode -------------------------------------------------------------------


def _decode_setup(_device, _world):
    jpegs = _tiny_jpegs(_N_IMAGES, _SRC_SIZE)
    spec = _transform_spec()
    probe = {
        "content": jpegs,
        "label_index": [0] * len(jpegs),
    }
    spec(dict(probe))  # warm the decode path (thread pool, caches)
    return {"spec": spec, "probe": probe}


def _decode_measure(ctx) -> dict:
    t0 = time.perf_counter()
    ctx["spec"](dict(ctx["probe"]))
    dt = time.perf_counter() - t0
    return {"decode_images_per_sec": len(ctx["probe"]["content"]) / dt}


register_scenario(Scenario(
    name="decode",
    description="JPEG decode + transform throughput, raw bytes in, "
    "host batch out (no reader, no device)",
    tier="tier1",
    metrics=(
        Metric("decode_images_per_sec", "images/sec", "higher",
               floor=0.6),
    ),
    setup=_decode_setup,
    measure=_decode_measure,
    repetitions=5,
    timeout_s=120.0,
))


# -- reader -------------------------------------------------------------------


def _reader_setup(_device, _world):
    import pyarrow as pa

    from ..data import write_delta

    tmpdir = tempfile.mkdtemp(prefix="dsst_bench_reader_")
    jpegs = _tiny_jpegs(_N_IMAGES, _SRC_SIZE)
    table = pa.table({
        "content": pa.array(jpegs, type=pa.binary()),
        "label_index": pa.array([i % 7 for i in range(len(jpegs))],
                                type=pa.int64()),
    })
    path = os.path.join(tmpdir, "bench_imagenet")
    write_delta(table, path, max_rows_per_file=max(16, len(jpegs) // 4))
    return {"tmpdir": tmpdir, "path": path, "spec": _transform_spec()}


def _reader_measure(ctx) -> dict:
    from ..data import batch_loader

    n_batches = 4
    with batch_loader(
        ctx["path"],
        batch_size=_BATCH,
        num_epochs=None,
        workers_count=2,
        results_queue_size=8,
        transform_spec=ctx["spec"],
    ) as reader:
        it = iter(reader)
        next(it)  # warm: open files, fill the pool
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        dt = time.perf_counter() - t0
    return {"reader_images_per_sec": _BATCH * n_batches / dt}


register_scenario(Scenario(
    name="reader",
    description="Delta table -> sharded reader -> decode pool -> host "
    "batches (no device)",
    tier="tier1",
    metrics=(
        Metric("reader_images_per_sec", "images/sec", "higher",
               floor=0.6),
    ),
    setup=_reader_setup,
    teardown=lambda ctx: shutil.rmtree(ctx["tmpdir"], ignore_errors=True),
    repetitions=3,
    measure=_reader_measure,
    timeout_s=240.0,
))


# -- compute (the audited classifier train step) ------------------------------


def _audited_train_step(device: str, world):
    """(step, batch): the EXACT program ``audit`` records for
    ``train_step.classifier``, built through the audit registry's builder
    from seed 0 (as the audit builds it) on ``device`` and the audit's
    fake 8-rank world (DDP through the audit's comm hook): the ONE builder
    both the compute and feeder_e2e scenarios share, so they can never
    measure different programs while citing one pin."""
    import torch

    from ..analysis.audit.entrypoints import train_step_classifier

    torch.manual_seed(0)
    spec = train_step_classifier(device, world)
    (batch,) = spec.args
    return spec.fn, batch


def _compute_setup(device, world):
    step, batch = _audited_train_step(device, world)
    return {"step": step, "batch": batch}


def _compute_measure(ctx) -> dict:
    steps = 10
    batch = ctx["batch"]
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = ctx["step"](batch)
    # The window ends on a host read of the last step's loss: on a card
    # the steps only queue work, and the read waits for all of it.
    metrics["train_loss"].item()
    dt = time.perf_counter() - t0
    sps = steps / dt
    return {
        "compute_steps_per_sec": sps,
        "compute_images_per_sec": sps * batch["image"].shape[0],
    }


register_scenario(Scenario(
    name="compute",
    description="audited train_step.classifier program (the audit's "
    "fake 8-rank world) steps/sec; prices the audit-pinned FLOPs budget "
    "into the achieved-FLOPs/s gauges",
    tier="tier1",
    metrics=(
        Metric("compute_steps_per_sec", "steps/sec", "higher",
               floor=0.6),
        Metric("compute_images_per_sec", "images/sec", "higher",
               gate=False),
    ),
    setup=_compute_setup,
    measure=_compute_measure,
    repetitions=3,
    timeout_s=420.0,
    needs_world=True,
    entrypoint="train_step.classifier",
    steps_metric="compute_steps_per_sec",
))


# -- feeder e2e (traced, self-verifying) --------------------------------------


def _feeder_setup(device, world):
    step, batch = _audited_train_step(device, world)
    # One throwaway call so the first measured repetition starts from warm
    # kernels and allocator (the warmup repetition then covers feeder
    # spin-up).
    step(batch)["train_loss"].item()
    return {
        "device": device,
        "step": step,
        "tmpdir": tempfile.mkdtemp(prefix="dsst_bench_feeder_"),
        "rep": 0,
    }


# Rows per synthetic host batch: the audited train_step.classifier batch
# shape (the pinned budget prices that shape); also the numerator of
# e2e_images_per_sec.
_E2E_ROWS = 16


def _host_batches(n: int):
    import numpy as np

    for _ in range(n):
        yield {
            "image": np.zeros((_E2E_ROWS, 16, 16, 3), np.float32),
            "label": np.zeros((_E2E_ROWS,), np.int32),
        }


def _attribution_buckets(tail_path, since: float) -> dict[str, float]:
    """Seconds per attribution bucket over the tail's step-kind spans
    opened after ``since``: the same SPAN_ATTRIBUTION mapping ``trace
    attribution`` reads, so this cross-check and the CLI tool cannot
    drift apart."""
    from ..telemetry import flightrec
    from ..telemetry.catalog import SPAN_ATTRIBUTION

    complete, _opens = flightrec.reconstruct(
        flightrec.read_events(tail_path)
    )
    buckets = {"data_wait": 0.0, "transfer": 0.0, "compute": 0.0,
               "host": 0.0}
    for e in complete:
        if e.get("kind") != "step" or e.get("ts", 0.0) < since:
            continue
        buckets[SPAN_ATTRIBUTION.get(e.get("name"), "host")] += e.get(
            "dur", 0.0
        )
    return buckets


def _feeder_measure(ctx) -> dict:
    from .. import telemetry
    from ..data.prefetch import Feeder
    from ..telemetry import flightrec

    steps = 8
    ctx["rep"] += 1
    # Record onto the recorder's existing tail when one is live (a
    # tracked run, or `bench profile` merging this very trace);
    # otherwise scope a private tail for the cross-check. The `since`
    # mark keeps the bucket read to THIS repetition either way.
    rec = flightrec.get_recorder()
    own_tail = None
    tail = rec.path
    if tail is None:
        own_tail = os.path.join(ctx["tmpdir"], f"tail{ctx['rep']}.jsonl")
        tail = flightrec.enable(own_tail)
    since = time.time()
    try:
        feeder = Feeder(
            _host_batches(steps), ctx["device"], depth=3, name="bench-e2e"
        )
        try:
            stall = 0.0
            t0 = time.perf_counter()
            for _ in range(steps):
                s0 = time.perf_counter()
                batch, _prov = next(feeder)
                stall += time.perf_counter() - s0
                with feeder.last_handoff.activate(), \
                        telemetry.span("train_step"):
                    metrics = ctx["step"](batch)
            metrics["train_loss"].item()
            wall = time.perf_counter() - t0
        finally:
            feeder.close()
    finally:
        if own_tail is not None:
            flightrec.disable(own_tail)

    buckets = _attribution_buckets(tail, since)
    traced = sum(buckets.values())
    unexplained = max(0.0, wall - traced) / wall if wall > 0 else 0.0
    if unexplained > 0.5:
        # The harness's self-verification: if the spans the attribution
        # tool buckets stop covering this loop (a renamed span, a broken
        # handoff), the number is unattributable — fail loudly instead
        # of shipping it.
        raise RuntimeError(
            f"e2e wall time unexplained by trace attribution: "
            f"{unexplained:.0%} of {wall*1e3:.1f}ms has no span "
            f"(buckets: { {k: round(v*1e3, 1) for k, v in buckets.items()} } "
            "ms) — feeder/step spans or the step handoff broke"
        )
    return {
        "e2e_images_per_sec": _E2E_ROWS * steps / wall,
        "e2e_steps_per_sec": steps / wall,
        "feeder_stall_fraction": stall / wall if wall > 0 else 0.0,
        "e2e_unexplained_fraction": unexplained,
    }


register_scenario(Scenario(
    name="feeder_e2e",
    description="traced Feeder -> audited train step loop; wall "
    "time cross-checked against flight-recorder attribution buckets "
    "(fails on unexplained gap)",
    tier="slow",
    metrics=(
        Metric("e2e_images_per_sec", "images/sec", "higher",
               floor=0.6),
        Metric("e2e_steps_per_sec", "steps/sec", "higher", gate=False),
        Metric("feeder_stall_fraction", "fraction", "lower", gate=False),
        Metric("e2e_unexplained_fraction", "fraction", "lower",
               gate=False),
    ),
    setup=_feeder_setup,
    teardown=lambda ctx: shutil.rmtree(ctx["tmpdir"], ignore_errors=True),
    measure=_feeder_measure,
    repetitions=3,
    timeout_s=420.0,
    needs_world=True,
    entrypoint="train_step.classifier",
))


# -- group fit (grid-fused SARIMAX panel) -------------------------------------


def _group_panel(n_sku: int, weeks: int, seed: int = 0):
    """Synthetic demand panel at JAX's recipe (level + damped random walk
    + noise, weekly Monday dates), built vectorized so 10k-SKU setup is
    numpy-bound, not loop-bound; a pyarrow Table where JAX builds a
    pandas frame."""
    import numpy as np
    import pyarrow as pa

    from ..workloads.forecasting import add_exo_variables

    rng = np.random.default_rng(seed)
    level = rng.uniform(20, 80, (n_sku, 1))
    walk = np.cumsum(rng.normal(0, 1.0, (n_sku, weeks)), axis=1) * 0.5
    noise = rng.normal(0, 3.0, (n_sku, weeks))
    demand = np.maximum(level + walk + noise, 0.0)
    dates = (np.datetime64("2020-01-06", "D")
             + 7 * np.arange(weeks)).astype("datetime64[us]")
    skus = np.array([f"P{g % 5}_{g:05d}" for g in range(n_sku)])
    table = pa.table({
        "Product": pa.array(np.repeat([f"P{g % 5}" for g in range(n_sku)], weeks)),
        "SKU": pa.array(np.repeat(skus, weeks)),
        "Date": pa.array(np.tile(dates, n_sku)),
        "Demand": pa.array(demand.ravel()),
    })
    return add_exo_variables(table)


def _group_fit_setup(device, _world):
    from ..workloads.forecasting import (
        GROUP_FIT_BENCH_GROUPS,
        GROUP_FIT_BENCH_WEEKS,
    )

    # The operator's device: the one ``forecast --device`` runs on (JAX's
    # _group_mesh of every real device is one card here).
    return {
        "device": device,
        "panel": _group_panel(GROUP_FIT_BENCH_GROUPS,
                              GROUP_FIT_BENCH_WEEKS),
    }


def _finite_forecasts(out, what: str) -> None:
    import numpy as np

    if not np.isfinite(out.column("Demand_Fitted").to_numpy()).all():
        raise RuntimeError(f"{what} produced non-finite forecasts")


def _group_fit_measure(ctx) -> dict:
    from ..ops.sarimax import grid_orders
    from ..workloads.forecasting import (
        GROUP_FIT_BENCH_CFG,
        GROUP_FIT_BENCH_GROUPS,
        GROUP_FIT_BENCH_HORIZON,
        tune_and_forecast_panel,
    )

    g = GROUP_FIT_BENCH_GROUPS
    info: dict = {}
    t0 = time.perf_counter()
    out = tune_and_forecast_panel(
        ctx["panel"],
        forecast_horizon=GROUP_FIT_BENCH_HORIZON,
        device=ctx["device"],
        cfg=GROUP_FIT_BENCH_CFG,
        search="grid",
        chunk_size=g,
        stats=info,
    )
    wall = time.perf_counter() - t0
    _finite_forecasts(out, "group_fit")
    # The REAL launch count, reported by the grid driver itself: one
    # chunk at this geometry. Anything else means the fused launch
    # family broke apart.
    chunks = info["grid_chunks"]
    if chunks != 1:
        raise RuntimeError(
            f"group_fit expected ONE fused launch, driver reports "
            f"{chunks}"
        )
    k = len(grid_orders(GROUP_FIT_BENCH_CFG))
    return {
        "group_fit_skus_per_sec": g / wall,
        "group_fit_fits_per_sec": g * k / wall,
        "group_fit_launches_per_sec": chunks / wall,
    }


register_scenario(Scenario(
    name="group_fit",
    description="grid-fused SARIMAX group-fit panel (32 SKUs x 40 "
    "weeks x the full 8-order grid of the reduced bench bounds) "
    "through tune_and_forecast_panel on --device: ONE chunk fits and "
    "tunes every SKU in one batched sarimax_fit",
    tier="tier1",
    metrics=(
        Metric("group_fit_skus_per_sec", "skus/sec", "higher",
               floor=0.6),
        Metric("group_fit_fits_per_sec", "fits/sec", "higher",
               gate=False),
        Metric("group_fit_launches_per_sec", "launches/sec", "higher",
               gate=False),
    ),
    setup=_group_fit_setup,
    measure=_group_fit_measure,
    repetitions=3,
    timeout_s=420.0,
    # No entrypoint: the port's sarimax.batched_fit pin prices the audit's
    # cut program (4 groups x 12 weeks, 2 iterations), not this launch, so
    # it would misprice the gauge.
))


# 10k-SKU scale smoke: 10k+ SKUs per launch family. A liveness-scale fit
# config (shorter NM chains than the tier-1 gate) keeps the slow-tier wall
# in minutes; the scenario's claim is CHUNKED completion (bounded
# launches, no host-loop fallback), with throughput recorded for trend,
# not gated.
_10K_SKUS = 10_000
_10K_CHUNK = 1024


def _group_fit_10k_setup(device, _world):
    import dataclasses

    from ..workloads.forecasting import (
        GROUP_FIT_BENCH_CFG,
        GROUP_FIT_BENCH_WEEKS,
    )

    return {
        "device": device,
        "panel": _group_panel(_10K_SKUS, GROUP_FIT_BENCH_WEEKS),
        "cfg": dataclasses.replace(GROUP_FIT_BENCH_CFG, max_iter=16),
    }


def _group_fit_10k_measure(ctx) -> dict:
    from ..workloads.forecasting import (
        GROUP_FIT_BENCH_HORIZON,
        tune_and_forecast_panel,
    )

    info: dict = {}
    t0 = time.perf_counter()
    out = tune_and_forecast_panel(
        ctx["panel"],
        forecast_horizon=GROUP_FIT_BENCH_HORIZON,
        device=ctx["device"],
        cfg=ctx["cfg"],
        search="grid",
        chunk_size=_10K_CHUNK,
        stats=info,
    )
    wall = time.perf_counter() - t0
    _finite_forecasts(out, "group_fit_10k")
    groups = out.group_by(["Product", "SKU"]).aggregate([]).num_rows
    if groups != _10K_SKUS:
        raise RuntimeError(
            f"group_fit_10k fitted {groups} groups, wanted {_10K_SKUS}"
        )
    # Measured, not assumed: the driver's own launch count; a host loop
    # or a broken chunk bound would show up right here.
    return {
        "group_fit_10k_skus_per_sec": _10K_SKUS / wall,
        "group_fit_10k_chunks": info["grid_chunks"],
    }


register_scenario(Scenario(
    name="group_fit_10k",
    description="10k-SKU grid-fused panel through the bounded chunked "
    "launch family (1024 groups/launch, liveness fit config): proves "
    "10k-SKU scale completes with no host-loop fallback",
    tier="slow",
    metrics=(
        Metric("group_fit_10k_skus_per_sec", "skus/sec", "higher",
               gate=False),
        Metric("group_fit_10k_chunks", "launches", "lower", gate=False),
    ),
    setup=_group_fit_10k_setup,
    measure=_group_fit_10k_measure,
    repetitions=1,
    warmup=0,
    timeout_s=1800.0,
))


# -- recorder overhead --------------------------------------------------------

_EMIT_EVENTS = 1500


def _recorder_setup(_device, _world):
    return {"tmpdir": tempfile.mkdtemp(prefix="dsst_bench_rec_"), "rep": 0}


def _recorder_measure(ctx) -> dict:
    from ..telemetry import flightrec

    rec = flightrec.get_recorder()
    ctx["rep"] += 1
    # The scenario must OWN the recorder target for both halves of the
    # comparison: a live recorder (a tracked run, `bench profile`)
    # would otherwise absorb the ring loop's synthetic events into its
    # tail — measuring tail cost where ring cost was claimed — and the
    # scoped disable below would silently switch that recorder off.
    # Park the previous target and restore it on the way out.
    prev = rec.path
    if prev is not None:
        flightrec.disable(prev)

    def _event(i: int) -> dict:
        return {
            "ph": "X", "name": "train_step", "ts": time.time(),
            "dur": 0.001, "pid": os.getpid(), "tid": 1,
            "thread": "bench", "span": f"{i:08x}",
        }

    tail = os.path.join(ctx["tmpdir"], f"tail{ctx['rep']}.jsonl")
    try:
        t0 = time.perf_counter()
        for i in range(_EMIT_EVENTS):
            rec.emit(_event(i))
        ring_dt = time.perf_counter() - t0

        flightrec.enable(tail)
        try:
            t0 = time.perf_counter()
            for i in range(_EMIT_EVENTS):
                rec.emit(_event(i))
            tail_dt = time.perf_counter() - t0
        finally:
            flightrec.disable(tail)
    finally:
        if prev is not None:
            flightrec.enable(prev)
    tail_bytes = os.path.getsize(tail)
    return {
        "recorder_emit_ring_us": ring_dt / _EMIT_EVENTS * 1e6,
        "recorder_emit_tail_us": tail_dt / _EMIT_EVENTS * 1e6,
        "recorder_tail_bytes_per_event": tail_bytes / _EMIT_EVENTS,
    }


register_scenario(Scenario(
    name="recorder_overhead",
    description="flight-recorder emit cost: in-memory ring vs "
    "write-through JSONL tail, plus bytes per event",
    tier="tier1",
    metrics=(
        Metric("recorder_emit_ring_us", "us/event", "lower", gate=False),
        Metric("recorder_emit_tail_us", "us/event", "lower", gate=False),
        # Bytes/event is deterministic for a fixed event shape — the one
        # recorder metric a shared CI box can gate tightly: it catches
        # event-payload bloat before every tail on every run grows.
        Metric("recorder_tail_bytes_per_event", "bytes", "lower",
               floor=0.25),
    ),
    setup=_recorder_setup,
    teardown=lambda ctx: shutil.rmtree(ctx["tmpdir"], ignore_errors=True),
    measure=_recorder_measure,
    repetitions=5,
    timeout_s=120.0,
))


# -- sanitizer overhead -------------------------------------------------------

_ACQUIRES = 20_000


def _lock_loop(lock, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with lock:
            pass
    return time.perf_counter() - t0


def _sanitizer_measure(_ctx) -> dict:
    import threading

    from ..analysis.sanitize import sanitize_scope
    from ..analysis.sanitize.runtime import _REAL_LOCK

    # The plain side takes the interpreter's own lock factory, so a
    # session-wide sanitizer (the DSST_SANITIZE=1 pytest plugin) cannot
    # instrument it; the armed scope below nests in such a session scope
    # without resetting it.
    plain_dt = _lock_loop(_REAL_LOCK(), _ACQUIRES)
    with sanitize_scope():
        # Constructed INSIDE the armed scope: instrumentation covers
        # locks created while armed (the sanitize model).
        armed_dt = _lock_loop(threading.Lock(), _ACQUIRES)
    return {
        "sanitizer_plain_acquire_us": plain_dt / _ACQUIRES * 1e6,
        "sanitizer_armed_acquire_us": armed_dt / _ACQUIRES * 1e6,
        "sanitizer_overhead_ratio": (
            armed_dt / plain_dt if plain_dt > 0 else 0.0
        ),
    }


register_scenario(Scenario(
    name="sanitizer_overhead",
    description="sanitize interposition cost per uncontended lock "
    "acquire, armed vs plain",
    tier="tier1",
    metrics=(
        Metric("sanitizer_plain_acquire_us", "us/acquire", "lower",
               gate=False),
        Metric("sanitizer_armed_acquire_us", "us/acquire", "lower",
               gate=False),
        # The ratio cancels host speed; floor 1.5 tolerates scheduler
        # noise while catching an interposition cost blow-up.
        Metric("sanitizer_overhead_ratio", "x", "lower", floor=1.5),
    ),
    measure=_sanitizer_measure,
    repetitions=5,
    timeout_s=120.0,
))


# -- slo overhead -------------------------------------------------------------

_SLO_OBS = 20_000


def _slo_values(n: int) -> list[float]:
    """Deterministic observation values spanning the sketch's decades
    (a single constant would hit one bucket's cache line forever and
    understate the bisect cost)."""
    return [10.0 ** (-5 + (i % 83) / 11.0) for i in range(n)]


def _slo_overhead_measure(_ctx) -> dict:
    from ..telemetry.registry import MetricsRegistry
    from ..telemetry.windows import SlidingQuantile

    reg = MetricsRegistry()
    # dsst: ignore[telemetry-registry] private throwaway registry: a bench probe series, never rendered on /metrics
    hist = reg.histogram("slo_overhead_probe_hist")
    sketch = SlidingQuantile()
    vals = _slo_values(_SLO_OBS)
    # Warm both paths (allocate the first digest, touch the buckets).
    for v in vals[:64]:
        hist.observe(v)
        sketch.observe(v)
    t0 = time.perf_counter()
    for v in vals:
        hist.observe(v)
    hist_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    for v in vals:
        sketch.observe(v)
    sketch_dt = time.perf_counter() - t0
    sketch_us = sketch_dt / _SLO_OBS * 1e6
    # The acceptance bound, self-verified like feeder_e2e's attribution
    # cross-check: one windowed emit must cost under 1% of a 1 ms step
    # budget (i.e. <10 µs); a sketch that got expensive must fail the
    # scenario loudly, not ship a quietly slower hot path.
    frac = sketch_us / 1000.0
    if frac >= 0.01:
        raise RuntimeError(
            f"windowed-sketch emit costs {sketch_us:.2f}us — "
            f"{frac:.1%} of a 1ms step budget (>=1%); the sliding "
            "window stopped being histogram-cheap"
        )
    return {
        "slo_sketch_observe_us": sketch_us,
        "slo_hist_observe_us": hist_dt / _SLO_OBS * 1e6,
        "slo_overhead_ratio": (
            sketch_dt / hist_dt if hist_dt > 0 else 0.0
        ),
        "slo_emit_step_fraction": frac,
    }


register_scenario(Scenario(
    name="slo_overhead",
    description="windowed-sketch emit cost vs plain histogram observe "
    "(the live SLO plane's hot-path tax); self-verifies the sketch "
    "emit stays under 1% of a 1ms step budget",
    tier="tier1",
    metrics=(
        Metric("slo_sketch_observe_us", "us/observe", "lower",
               gate=False),
        Metric("slo_hist_observe_us", "us/observe", "lower", gate=False),
        # The ratio cancels host speed (the sanitizer_overhead idiom);
        # floor 1.5 tolerates scheduler noise while catching a sketch
        # cost blow-up vs the histogram it rides next to.
        Metric("slo_overhead_ratio", "x", "lower", floor=1.5),
        Metric("slo_emit_step_fraction", "fraction", "lower",
               gate=False),
    ),
    measure=_slo_overhead_measure,
    repetitions=5,
    timeout_s=120.0,
))


# -- serving loadgen ----------------------------------------------------------


def _scrape_slo(port: int) -> dict:
    """The stub server's /slo document (schema v1)."""
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/slo")
        resp = conn.getresponse()
        return json.loads(resp.read())
    finally:
        conn.close()


def _serving_setup(_device, _world):
    from . import loadgen

    proc, port = loadgen.spawn_stub_server(
        micro_batch=8, score_ms=5.0, batch_window_ms=5.0, queue_depth=64,
    )
    return {"proc": proc, "port": port}


def _serving_teardown(ctx) -> None:
    ctx["proc"].terminate()
    ctx["proc"].wait(15)


def _serving_measure(ctx) -> dict:
    from . import loadgen

    report = loadgen.run_load(
        "127.0.0.1", ctx["port"], b"0", threads=8, duration_s=1.2,
    )
    fill = report["server"]["batch_fill"]["mean"]
    # The live-vs-offline agreement check: the server's windowed p99
    # (the SLO plane's serving_latency_p99 value, fed by the same
    # requests the loadgen just timed) must agree with the loadgen's
    # offline p99: both route through telemetry.windows.quantile, so
    # the only legitimate gaps are the sketch's bounded bucket error
    # and the client's socket overhead. A wild disagreement means the
    # live plane is measuring something other than what clients see.
    status = _scrape_slo(ctx["port"])
    lat = next(
        (o for o in status.get("objectives", [])
         if o["name"] == "serving_latency_p99"), {},
    )
    live_p99 = lat.get("value")
    offline_p99 = report["latency_s"]["p99"]
    if (
        live_p99 and offline_p99
        and report["requests"] >= 100
        and not (0.2 <= live_p99 / offline_p99 <= 5.0)
    ):
        raise RuntimeError(
            f"live windowed p99 {live_p99 * 1e3:.1f}ms disagrees with "
            f"the loadgen's offline p99 {offline_p99 * 1e3:.1f}ms far "
            "beyond sketch error + client overhead — the live SLO "
            "plane is not measuring what clients experience"
        )
    return {
        "serving_throughput_rps": report["throughput_rps"],
        "serving_p50_ms": (report["latency_s"]["p50"] or 0.0) * 1e3,
        "serving_p99_ms": (offline_p99 or 0.0) * 1e3,
        "serving_batch_fill_mean": fill if fill is not None else 0.0,
        "serving_live_p99_ms": (live_p99 or 0.0) * 1e3,
        # The /slo snapshot rides the artifact so CI can gate on it
        # after the bench: `slo check --report <bench json>`.
        "_extra": {"loadgen": report, "slo": status},
    }


register_scenario(Scenario(
    name="serving",
    description="closed-loop loadgen vs the stub-scorer scheduler "
    "subprocess over real sockets (admission, decode pool, "
    "cross-request batching)",
    tier="tier1",
    metrics=(
        Metric("serving_throughput_rps", "req/sec", "higher",
               floor=0.6),
        Metric("serving_p50_ms", "ms", "lower", floor=0.6),
        Metric("serving_p99_ms", "ms", "lower", gate=False),
        Metric("serving_batch_fill_mean", "images", "higher", gate=False),
        Metric("serving_live_p99_ms", "ms", "lower", gate=False),
    ),
    setup=_serving_setup,
    teardown=_serving_teardown,
    measure=_serving_measure,
    repetitions=3,
    timeout_s=240.0,
))


# -- LM token serving ---------------------------------------------------------


def _lm_serving_setup(_device, _world):
    from . import loadgen

    # Deadline + inter-token budget armed: the /slo snapshot riding the
    # artifact must show ZERO firing objectives under this load (the
    # gate `slo check --strict --url` judges).
    proc, port = loadgen.spawn_stub_lm_server(
        slots=8, max_len=96, prefill_buckets="8,16", step_ms=3.0,
        queue_depth=32, deadline_ms=2000.0, inter_token_budget_ms=250.0,
    )
    return {"proc": proc, "port": port}


def _lm_serving_teardown(ctx) -> None:
    ctx["proc"].terminate()
    ctx["proc"].wait(15)


def _lm_serving_measure(ctx) -> dict:
    from . import loadgen

    prompt = [1, 2, 3, 4]
    # 8 concurrent streams vs ONE stream against the same engine: the
    # stub decoder's per-STEP cost is independent of active slots, so
    # the ratio isolates what continuous batching buys; the bar is >= 2x
    # at 8 streams.
    multi = loadgen.run_lm_load(
        "127.0.0.1", ctx["port"], prompt=prompt, max_new_tokens=16,
        streams=8, duration_s=1.2,
    )
    solo = loadgen.run_lm_load(
        "127.0.0.1", ctx["port"], prompt=prompt, max_new_tokens=16,
        streams=1, duration_s=0.8,
    )
    if multi["requests"] == 0 or solo["requests"] == 0:
        raise RuntimeError(
            f"lm loadgen starved: {multi['requests']} multi-stream / "
            f"{solo['requests']} solo requests completed"
        )
    if multi["trace_propagated"] != multi["requests"]:
        raise RuntimeError(
            "trace propagation broken on /generate: "
            f"{multi['trace_propagated']}/{multi['requests']} streams "
            "echoed the injected trace id"
        )
    speedup = (
        multi["tokens_per_sec"] / solo["tokens_per_sec"]
        if solo["tokens_per_sec"] else 0.0
    )
    status = _scrape_slo(ctx["port"])
    return {
        "lm_tokens_per_sec": multi["tokens_per_sec"],
        "lm_solo_tokens_per_sec": solo["tokens_per_sec"],
        "lm_batching_speedup": round(speedup, 3),
        "lm_ttft_p99_ms": (multi["ttft_s"]["p99"] or 0.0) * 1e3,
        "lm_inter_token_p99_ms": (
            multi["inter_token_s"]["p99"] or 0.0
        ) * 1e3,
        "_extra": {"loadgen": multi, "solo": solo, "slo": status},
    }


register_scenario(Scenario(
    name="lm_serving",
    description="closed-loop streamed-generation loadgen vs the "
    "stub-decoder continuous-batching engine subprocess (slot "
    "admission, bucketed prefill, chunked token streaming); gates "
    "tokens/sec and the >=2x batching speedup at 8 streams",
    tier="tier1",
    metrics=(
        Metric("lm_tokens_per_sec", "tokens/sec", "higher", floor=0.6),
        Metric("lm_solo_tokens_per_sec", "tokens/sec", "higher",
               gate=False),
        Metric("lm_batching_speedup", "x", "higher", floor=0.6),
        Metric("lm_ttft_p99_ms", "ms", "lower", gate=False),
        Metric("lm_inter_token_p99_ms", "ms", "lower", gate=False),
    ),
    setup=_lm_serving_setup,
    teardown=_lm_serving_teardown,
    measure=_lm_serving_measure,
    repetitions=3,
    timeout_s=240.0,
))
