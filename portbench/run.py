"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A new process for every run. Set-up builds the port's training step as
``train`` builds it (``ClassifierTask`` around
``config/checkpoints.py::build_classifier_model``), loads weights drawn on
the card from the seed, draws the traffic's batches on the card, and
warms every shape the window uses with three steps (the port's kernels
load from ``build/kernels/`` in the checkout, built there by the first
run). Then the window: a closed loop of ``train_step`` calls, dispatched
back to back with no host sync, from a synchronised start to the
``.item()`` of the last step's loss, for ``--seconds`` seconds. With
``--trace 1`` a short slice of steady steps is then profiled and the
cell's per-layer metrics are read from it. Once the memory peak is read,
the same task is put back to the drawn state in place and takes three
more steps through the window's own call and feed, so the readings the
check compares come from whatever path the window ran. Then the port's
state is freed and the float32 reference follows the same three steps
(:mod:`portbench.check`).

The last line of standard output is the result (one JSON object); the last
lines of standard error are the numbers compared, each beside its limit.
A run exits non-zero and prints no result when the card or the cell's
chips are missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import check, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dss_ml_at_scale_tpu")
CHECK_STEPS = 3


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    trace: object  # the slice with the host's operators
    timeline: object  # the slice of the device's activity alone
    images_per_s: float
    train_flops_per_image: float
    fused_calls: list


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_program(cell: spec.Cell, seed: int, device, dtype=None):
    """The port's ``ClassifierTask``, its model loaded with the weights
    drawn from ``seed``."""
    import torch

    from dss_ml_at_scale_tpu_torch.parallel.trainer import ClassifierTask, _deterministic_kernels

    models = spec.load_module("models", cell.config_name)
    # What Trainer.fit sets for train: cuDNN deterministic, no autotuning.
    _deterministic_kernels(torch.device(device))
    model = models.build_port(cell.config, cell.traffic, device, dtype=dtype)
    task = ClassifierTask(model=model, learning_rate=float(cell.config["learning_rate"]))
    load_drawn_state(task, cell, seed, device)
    return task


def load_drawn_state(task, cell: spec.Cell, seed: int, device) -> dict:
    """Put ``task`` back to the state drawn from ``seed`` in place, the same
    tensors kept: weights and buffers loaded, Adam's moments and step
    counts zeroed as a fresh Adam has them, no update taken. Returns the
    drawn state."""
    import torch

    from .weights import draw

    reference = spec.load_module("reference", cell.config_name)
    weights = draw(reference.weight_specs(cell.config, int(cell.traffic["crop"])), seed, device)
    task.model.load_state_dict(weights, strict=True)
    with torch.no_grad():
        for state in task.optimizer.state.values():
            for value in state.values():  # Adam's step, exp_avg, exp_avg_sq
                value.zero_()
    task.optimizer.zero_grad(set_to_none=True)
    task.step = 0
    return weights


def warm_up(task, pool: list[dict]) -> None:
    """Set-up's steps, which build and warm every shape the window uses."""
    for i in range(CHECK_STEPS):
        task.train_step(pool[i])


def program_readings(task, cell: spec.Cell, seed: int, pool: list[dict],
                     device) -> check.Readings:
    """``task`` put back to the drawn state, three steps through its own
    call and feed, and what the check compares of them."""
    import torch

    start = load_drawn_state(task, cell, seed, device)
    params = dict(task.model.named_parameters())
    beta1 = task.optimizer.param_groups[0]["betas"][0]
    losses, first = [], None
    for i in range(CHECK_STEPS):
        metrics = task.train_step(pool[i])
        losses.append(metrics["train_loss"].detach().float())
        if i == 0:
            # The first gradient as the optimizer got it: Adam's first
            # moment after one step is (1 - beta1) * g.
            norms = []
            for p in params.values():
                m = task.optimizer.state.get(p, {}).get("exp_avg")
                norms.append(torch.linalg.vector_norm(m.float()) / (1 - beta1) if m is not None
                             else torch.zeros((), device=p.device))
            first = torch.stack(norms)
    with torch.no_grad():
        change = torch.stack([torch.linalg.vector_norm(p.float() - start[n])
                              for n, p in params.items()])
        buffers = dict(task.model.named_buffers())
        stats = [torch.linalg.vector_norm(b.float() - start[n]) for n, b in buffers.items()]
        stats = torch.stack(stats) if stats else torch.zeros(0, device=change.device)
    return check.Readings(losses=torch.stack(losses).tolist(),
                          grad=dict(zip(params, first.tolist())),
                          change=dict(zip(params, change.tolist())),
                          stats=dict(zip(buffers, stats.tolist())))


def reference_readings(cell: spec.Cell, seed: int, pool: list[dict], device,
                       precision: str | None = None) -> check.Readings:
    """The reference (or, with ``precision="float8"``, the control) over the
    same three batches from the same drawn weights."""
    from .reference._plain import exact_float32, train_readings
    from .weights import draw

    reference = spec.load_module("reference", cell.config_name)
    crop = int(cell.traffic["crop"])
    model = reference.Reference(cell.config, crop, precision=precision, device=device)
    model.load_state_dict(draw(reference.weight_specs(cell.config, crop), seed, device),
                          strict=True)
    with exact_float32():
        return train_readings(model, pool[:CHECK_STEPS], float(cell.config["learning_rate"]))


def _window(task, pool: list[dict], seconds: float, device) -> dict:
    """The measured window: steps dispatched back to back from a
    synchronised start, each followed by a CUDA event on its stream, until
    ``seconds`` have passed on the host's clock; it closes on the
    ``.item()`` of the last step's loss."""
    import torch

    cuda = torch.device(device).type == "cuda"
    events = [torch.cuda.Event(enable_timing=True) for _ in range(1025)] if cuda else []
    losses, ends = [], []
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        events[0].record()
    t0 = time.perf_counter()
    i = 0
    while True:
        if time.perf_counter() - t0 >= seconds and i:
            break
        metrics = task.train_step(pool[(CHECK_STEPS + i) % len(pool)])
        i += 1
        if cuda:
            if i >= len(events):
                events.append(torch.cuda.Event(enable_timing=True))
            events[i].record()
        ends.append(time.perf_counter())
        losses.append(metrics["train_loss"])
    last_loss = metrics["train_loss"].item()
    t1 = time.perf_counter()
    if cuda:
        intervals = [events[j - 1].elapsed_time(events[j]) for j in range(1, i + 1)]
        peak = torch.cuda.max_memory_allocated(device)
    else:  # the CPU run of the tests: host intervals, no device numbers
        intervals = [1e3 * (e - s) for s, e in zip([t0] + ends[:-1], ends)]
        peak = 0
    nonfinite = int((~torch.isfinite(torch.stack(losses).float())).sum())
    return {"t0": t0, "seconds": t1 - t0, "steps": i, "intervals_ms": intervals,
            "peak_bytes": peak, "nonfinite": nonfinite, "last_loss": last_loss}


def p95(values: list[float]) -> float:
    """The 95th percentile (the inclusive method of ``statistics``)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             plant=None, log=print) -> tuple[dict, list[str]]:
    """``(result, check lines)`` of one run of ``cell``. ``plant(task)``
    breaks the timed path underneath (the tests' faults)."""
    import torch

    from .traffic import make_pool

    cuda = torch.device(device).type == "cuda"
    models = spec.load_module("models", cell.config_name)
    # Set-up's phases, on standard error: where its time goes.
    marks = [("imports", time.perf_counter())]
    torch.empty(1, device=device)
    _sync(device)
    marks.append(("card", time.perf_counter()))
    task = build_program(cell, seed, device)
    if plant is not None:
        plant(task)
    _sync(device)
    marks.append(("model", time.perf_counter()))
    pool = make_pool(cell.traffic, int(cell.config["num_classes"]), seed, device)
    _sync(device)
    marks.append(("traffic", time.perf_counter()))
    warm_up(task, pool)
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = time.perf_counter() - _T0
    starts = [_T0] + [t for _, t in marks]
    log("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (name, b), a in zip(marks, starts)),
        file=sys.stderr)

    w = _window(task, pool, seconds, device)
    log(f"window: {w['steps']} steps in {w['seconds']:.3f} s", file=sys.stderr)
    images_per_s = w["steps"] * int(cell.traffic["batch"]) / w["seconds"]
    values = {"images_per_s": images_per_s, "step_ms_p95": p95(w["intervals_ms"]),
              "peak_mem_gib": w["peak_bytes"] / 2 ** 30, "setup_s": setup_s}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": max(setup_peak, w["peak_bytes"])}
    result: dict = {"correct": False, "attempted": w["steps"], "failed": w["nonfinite"]}
    if trace:
        from .trace import profile_slice

        steps = int(cell.settings["trace_steps"])
        at = [CHECK_STEPS + w["steps"]]

        def run_steps(n):
            for _ in range(n):
                task.train_step(pool[at[0] % len(pool)])
                at[0] += 1

        timeline = profile_slice(run_steps, steps, device, host_ops=False)
        tr = profile_slice(run_steps, steps, device, host_ops=True)
        ctx = Context(trace=tr, timeline=timeline, images_per_s=images_per_s,
                      train_flops_per_image=models.train_flops_per_image(
                          cell.config, int(cell.traffic["crop"])),
                      fused_calls=models.fused_calls(cell.config, cell.traffic))
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(ctx)
            if value is None:
                log(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=timeline.busy_s(), window_s=timeline.window_s)
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": timeline.breakdown()["device_ops"],
                               "idle_gaps": tr.breakdown()["idle_gaps"]}
        del run_steps, ctx, tr, timeline
    else:
        result["metrics"] = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"the harness computes no end-to-end metric {m['name']!r}")
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["device"] = device_info

    # The check: the window's own task back at the drawn state for three
    # steps; then the port's state freed, so the reference sets no peak
    # that the run reports.
    got = program_readings(task, cell, seed, pool, device)
    del task, w
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, pool, device)
    ok, table = check.judge(check.numbers(got, ref), cell.settings["check"])
    ok = ok and result["failed"] == 0
    result["correct"] = ok
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in table.items()}
    result["check"]["failed_steps"] = {"value": result["failed"], "limit": 0}
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r} ({v['at']})"
             for k, v in table.items()]
    lines.append(f"check failed_steps: {result['failed']} limit 0")
    lines.append(f"correct: {ok}")
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
