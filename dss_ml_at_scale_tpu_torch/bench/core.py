"""Performance-observability framework: scenario registry, baseline, runner.

Port of ``dss_ml_at_scale_tpu/bench/core.py``. The port guards correctness
three ways (``lint`` / ``audit`` / ``sanitize``: committed baselines,
expire semantics, exit 0/1/2); this module is the fourth tier, built on
the same idioms:

- **Scenario registry** (:class:`Scenario`, mirroring the audit
  entrypoint registry): each scenario declares its measure function, a
  metric schema with direction (higher/lower-is-better) and per-metric
  noise floors, repetitions/warmup, and a tier (``tier1`` fast CI /
  ``slow`` / ``cuda`` only-on-the-card). The ``bench-registry`` lint rule
  reconciles declarations against
  ``telemetry.catalog.KNOWN_BENCH_METRICS`` in both directions.
- **Noise-aware measurement** (:mod:`.stats`): warmup discard, N
  repetitions, median + MAD, and a verdict whose tolerance derives from
  the measured dispersion.
- **Committed baseline** (``analysis/baselines/bench.json``): summaries
  keyed by an *environment fingerprint* (platform, the card's name and
  power limit, device count, torch, CUDA, driver, python, host cores):
  numbers from another card or another power limit never gate this one.
  ``--update-baseline --reason`` records entries; a baselined scenario
  that left the registry (or a metric that left its schema) is *stale*
  and FAILS the run, as in the other three tiers.
- **Child isolation + durable salvage**: each scenario runs in its own
  subprocess (a hung card or an OOM kills one scenario, not the harness)
  on ``--device``, and checkpoints per-repetition partials through
  :func:`~dss_ml_at_scale_tpu_torch.resilience.durability.durable_write_json`.

Where JAX gives an audited scenario the 8-device abstract mesh
(``needs_mesh``), a port scenario declares ``needs_world``: its setup,
repetitions and teardown run inside the audit's fake 8-rank process group
(:func:`..analysis.audit.core.audit_world`), the world ``audit`` builds
the same programs on. Each record also carries the hand-written kernels'
launch counts over the scenario (K1-K4), so a caller can tell which
kernels a scenario ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

from . import stats

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_BENCH_BASELINE = (Path(__file__).resolve().parents[1] / "analysis"
                          / "baselines" / "bench.json")
BENCH_SCHEMA_VERSION = 1

# JAX's accelerator-only tier ``tpu`` is the card's ``cuda`` here.
TIERS = ("tier1", "slow", "cuda")


class BenchUsageError(Exception):
    """Bad invocation (unknown scenario/tier, missing --reason): exit 2."""


@dataclasses.dataclass(frozen=True)
class Metric:
    """One declared output series of a scenario.

    ``direction`` declares which way is better; ``gate=False`` records
    the metric in artifacts/baselines without ever judging it (signed
    overhead fractions, occupancy gauges: diagnostics, not SLOs);
    ``floor`` is the minimum relative tolerance the verdict allows
    (dispersion can widen the band, never narrow it below this).
    """

    name: str
    unit: str
    direction: str = "higher"
    gate: bool = True
    floor: float = stats.DEFAULT_REL_FLOOR

    def __post_init__(self):
        if self.direction not in ("higher", "lower"):
            raise ValueError(
                f"metric {self.name!r}: direction must be 'higher' or "
                f"'lower', got {self.direction!r}"
            )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered measurement.

    ``setup(device, world)`` builds state once per process (models,
    stub servers) on ``device``; ``world`` is the audit's fake process
    group when ``needs_world`` is set, else None. ``measure(ctx)``
    performs ONE repetition and returns ``{metric_name: value}`` (plus an
    optional ``"_extra"`` dict of non-gated detail carried into the report
    verbatim); ``teardown(ctx)`` releases what setup built. The framework
    owns the warmup/repetition loop and the per-repetition durable
    partial. ``entrypoint``/``steps_metric`` opt the scenario into the
    achieved-FLOPs/s gauges: the named metric is steps/sec of the named
    audited entrypoint, priced against its audit-pinned cost budget and
    the card's peak (:mod:`.mfu`).
    """

    name: str
    description: str
    tier: str
    metrics: tuple[Metric, ...]
    measure: Callable[[Any], dict]
    setup: Callable[[str, Any], Any] | None = None
    teardown: Callable[[Any], None] | None = None
    repetitions: int = 5
    warmup: int = 1
    timeout_s: float = 240.0
    needs_world: bool = False
    entrypoint: str | None = None
    steps_metric: str | None = None

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(
                f"scenario {self.name!r}: tier must be one of {TIERS}, "
                f"got {self.tier!r}"
            )
        if self.steps_metric and self.steps_metric not in {
            m.name for m in self.metrics
        }:
            raise ValueError(
                f"scenario {self.name!r}: steps_metric "
                f"{self.steps_metric!r} is not in the metric schema"
            )

    def metric(self, name: str) -> Metric:
        for m in self.metrics:
            if m.name == name:
                return m
        raise KeyError(name)


_SCENARIOS: dict[str, Scenario] = {}


def register_scenario(sc: Scenario) -> Scenario:
    if sc.name in _SCENARIOS:
        raise ValueError(f"duplicate scenario name {sc.name!r}")
    _SCENARIOS[sc.name] = sc
    return sc


def _load_scenarios() -> None:
    # Import for side effect: the module registers its Scenario objects.
    from . import scenarios  # noqa: F401


def scenario_names() -> list[str]:
    _load_scenarios()
    return sorted(_SCENARIOS)


def scenario_catalog() -> list[tuple[str, str, str]]:
    """(name, tier, description) for --list-scenarios and the README."""
    _load_scenarios()
    return [
        (n, _SCENARIOS[n].tier, _SCENARIOS[n].description)
        for n in sorted(_SCENARIOS)
    ]


def get_scenario(name: str) -> Scenario:
    _load_scenarios()
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise BenchUsageError(
            f"unknown scenario {name!r}; known: "
            f"{', '.join(sorted(_SCENARIOS))}"
        ) from None


# -- environment fingerprint --------------------------------------------------


def _card_query(index: int) -> tuple[str, str, str, int]:
    """(name, power limit, driver, card count) from ``nvidia-smi``, run as a
    child under a timeout: the parent reads the card without starting a
    CUDA context before it spawns the scenario children."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise BenchUsageError(f"cannot fingerprint the card: nvidia-smi: {e}") from None
    rows = [[f.strip() for f in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]
    if not 0 <= index < len(rows) or len(rows[index]) != 3:
        raise BenchUsageError(f"cannot fingerprint card {index}: nvidia-smi printed {out!r}")
    name, power, driver = rows[index]
    return name, power, driver, len(rows)


def environment_fingerprint(device: str = "cuda") -> dict:
    """The identity a baseline entry is keyed by: numbers measured on
    another platform, card, power limit, device count or torch/CUDA build
    must never gate this run."""
    import torch

    dev = torch.device(device)
    env: dict = {
        "platform": dev.type,
        "device": "cpu",
        "power_limit": None,
        "device_count": 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "driver": None,
    }
    if dev.type == "cuda":
        name, power, driver, count = _card_query(dev.index or 0)
        env.update(device=name, power_limit=power, driver=driver,
                   device_count=count)
    env["cpus"] = os.cpu_count() or 1
    env["python"] = f"{sys.version_info.major}.{sys.version_info.minor}"
    return env


def fingerprint_key(env: Mapping[str, Any]) -> str:
    def part(key: str) -> str:
        return str(env.get(key, "?")).replace(" ", "_")

    return ":".join((
        part("platform"), part("device"), part("power_limit"),
        f"{env.get('device_count', '?')}dev",
        f"torch{env.get('torch', '?')}",
        f"cuda{env.get('cuda', '?')}",
        f"drv{env.get('driver', '?')}",
        f"py{env.get('python', '?')}",
        f"{env.get('cpus', '?')}cpu",
    ))


# -- baseline -----------------------------------------------------------------


def load_bench_baseline(path: Path) -> dict:
    """``{"entries": {fp_key: {"env": .., "scenarios": {..}}}}``."""
    if not path.exists():
        return {"entries": {}}
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        raise BenchUsageError(f"baseline {path} is not valid JSON: {e}")
    if not isinstance(data, dict) or not isinstance(
        data.get("entries", {}), dict
    ):
        raise BenchUsageError(
            f"baseline {path}: top level and 'entries' must be objects"
        )
    return {"entries": data.get("entries", {})}


def write_bench_baseline(path: Path, result: "BenchResult", old: dict,
                         new_reason: str | None) -> int:
    """Rewrite the current fingerprint's entries to this run's
    summaries. Other fingerprints' entries are preserved verbatim
    (another card's truth); under the current fingerprint, scenarios
    outside this run's selection keep their entries (a subset update
    must not wipe what it never re-measured) and stale entries
    (scenarios that left the registry, metrics that left their schema)
    don't survive. New scenario entries need ``new_reason``."""
    from ..resilience.durability import durable_write_text

    _load_scenarios()
    broken = sorted({
        f["scenario"] for f in result.findings
        if f["kind"] in ("error", "timeout", "no-samples")
    })
    if broken:
        raise BenchUsageError(
            "refusing --update-baseline: scenario(s) "
            f"{', '.join(broken)} measured nothing this run; their "
            "entries would be dropped or pinned on garbage; fix first"
        )
    # A salvaged record (watchdog-killed child, partial repetitions) is
    # fine to REPORT but must never become the committed truth: a
    # median-of-one from a wedged host would silently weaken the gate.
    salvaged = sorted(
        n for n, r in result.results.items() if r.get("salvaged")
    )
    if salvaged:
        raise BenchUsageError(
            "refusing --update-baseline: scenario(s) "
            f"{', '.join(salvaged)} were salvaged from a killed child; "
            "a degraded run's partial medians must not be pinned; rerun "
            "on a healthy host"
        )
    entries: dict = {k: v for k, v in old.get("entries", {}).items()}
    fp = entries.setdefault(
        result.fingerprint_key, {"env": result.env, "scenarios": {}}
    )
    fp["env"] = result.env
    scen_map = fp.setdefault("scenarios", {})
    # Expire stale ballast under this fingerprint.
    for name in list(scen_map):
        sc = _SCENARIOS.get(name)
        if sc is None:
            del scen_map[name]
            continue
        declared = {m.name for m in sc.metrics}
        mets = scen_map[name].get("metrics", {})
        scen_map[name]["metrics"] = {
            k: v for k, v in mets.items() if k in declared
        }
    added = 0
    for name, res in sorted(result.results.items()):
        summaries = res.get("metrics", {})
        if not summaries:
            continue
        prev = scen_map.get(name, {})
        if str(prev.get("reason", "")).strip():
            reason = prev["reason"]
        else:
            if not (new_reason and new_reason.strip()):
                raise BenchUsageError(
                    f"new baseline entry for scenario {name!r} needs "
                    "--reason TEXT (what run produced these numbers?)"
                )
            reason = new_reason.strip()
            added += 1
        scen_map[name] = {
            "reason": reason,
            "tier": res.get("tier"),
            "recorded": time.strftime("%Y-%m-%d", time.gmtime()),
            "metrics": {
                m: {
                    "median": s["summary"]["median"],
                    "mad": s["summary"]["mad"],
                    "n": s["summary"]["n"],
                    "unit": s.get("unit"),
                    "direction": s.get("direction"),
                }
                for m, s in sorted(summaries.items())
            },
        }
    payload = {
        "_comment": (
            "bench baseline of the port: per-environment-fingerprint robust "
            "summaries (median/MAD/n) of every registered scenario's "
            "metrics. Regenerate with `python -m "
            "dss_ml_at_scale_tpu_torch.config.cli bench --update-baseline "
            "--reason '...'`; a committed scenario that left the registry "
            "(or a metric that left its schema) goes stale and FAILS the "
            "bench until re-baselined. Entries under a different "
            "fingerprint (another card, power limit or build) never gate "
            "this host."
        ),
        "version": BENCH_SCHEMA_VERSION,
        "entries": entries,
    }
    durable_write_text(path, json.dumps(payload, indent=2, sort_keys=True) + "\n",
                       kind="baseline")
    return added


# -- measurement (runs inside the isolated child, or inline) ------------------


def kernel_launches() -> dict[str, int]:
    """The hand-written kernels' launch counters of this process (K1-K3:
    the fused BN-ReLU-matmul, bf16 and f32 variants together; K4: flash
    attention)."""
    from ..ops import flash_attention
    from ..ops import fused_matmul as fm

    return {"K1": fm.bn_relu_matmul_fwd.launches,
            "K2": fm.bn_relu_matmul_bwd_da.launches,
            "K3": fm.bn_relu_matmul_bwd_dw.launches,
            "K4": flash_attention.launches}


def measure_scenario(sc: Scenario, *, repetitions: int | None = None,
                     warmup: int | None = None,
                     partial_path: str | os.PathLike | None = None,
                     env: Mapping[str, Any] | None = None,
                     device: str = "cuda") -> dict:
    """The framework-owned repetition loop for ONE scenario on ``device``.

    Runs ``setup``, ``warmup + repetitions`` calls of ``measure``,
    discards the warmup, and, after every kept repetition, durably
    checkpoints the partial record so a watchdog kill salvages every
    completed repetition. A ``needs_world`` scenario runs all of it inside
    the audit's fake process group. Returns ``{"scenario", "env",
    "samples", "extra", "completed", "launches", "seconds"}``; ``seconds``
    holds the setup's and the repetitions' wall time.
    """
    from ..resilience.durability import durable_write_json

    reps = sc.repetitions if repetitions is None else repetitions
    if reps < 1:
        raise BenchUsageError("repetitions must be >= 1")
    n_warm = sc.warmup if warmup is None else warmup
    declared = {m.name for m in sc.metrics}
    record: dict = {
        "scenario": sc.name,
        "env": dict(env) if env is not None else environment_fingerprint(device),
        "samples": {m.name: [] for m in sc.metrics},
        "extra": {},
        "completed": 0,
        "launches": {},
        "seconds": {},
    }
    before = kernel_launches()
    if sc.needs_world:
        from ..analysis.audit.core import audit_world

        world_cm = audit_world()
    else:
        world_cm = contextlib.nullcontext()
    with world_cm as world:
        t0 = time.perf_counter()
        ctx = sc.setup(device, world) if sc.setup is not None else None
        t1 = time.perf_counter()
        try:
            raw: list[dict] = []
            for _ in range(n_warm + reps):
                out = dict(sc.measure(ctx))
                extra = out.pop("_extra", None)
                unknown = sorted(set(out) - declared)
                if unknown:
                    raise BenchUsageError(
                        f"scenario {sc.name!r} emitted undeclared metric(s) "
                        f"{', '.join(unknown)}; declare them in the schema "
                        "(and telemetry.catalog.KNOWN_BENCH_METRICS)"
                    )
                raw.append(out)
                kept = stats.discard_warmup(raw, n_warm)
                if not kept:
                    continue  # still inside the warmup window
                if isinstance(extra, dict):
                    record["extra"].update(extra)
                record["samples"] = {
                    name: [float(r[name]) for r in kept if name in r]
                    for name in declared
                }
                record["completed"] = len(kept)
                after = kernel_launches()
                record["launches"] = {k: after[k] - before[k] for k in after}
                record["seconds"] = {"setup": round(t1 - t0, 3),
                                     "repetitions": round(time.perf_counter() - t1, 3)}
                if partial_path is not None:
                    durable_write_json(partial_path, record, kind="bench")
        finally:
            if sc.teardown is not None:
                sc.teardown(ctx)
    return record


# -- the runner ---------------------------------------------------------------


@dataclasses.dataclass
class BenchResult:
    scenarios: list[str]                  # selected
    env: dict
    fingerprint_key: str
    results: dict[str, dict]              # name -> per-scenario report
    findings: list[dict]                  # regression/stale/error/...
    mfu: dict[str, dict]                  # entrypoint -> utilization block

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def render_text(self) -> str:
        lines = []
        for name in self.scenarios:
            res = self.results.get(name)
            if res is None:
                continue
            note = f"  [{res['note']}]" if res.get("note") else ""
            lines.append(f"{name} ({res.get('tier')}){note}")
            for m, s in sorted(res.get("metrics", {}).items()):
                summ = s["summary"]
                v = s.get("verdict", "?")
                extra = ""
                if "rel_change" in s:
                    extra = (f"  {s['rel_change']:+.1%} vs baseline "
                             f"(tol ±{s['tolerance']:.1%})")
                lines.append(
                    f"  {m:<36} {summ['median']:>12.4g} {s.get('unit', ''):<12}"
                    f" ±{summ['mad']:.3g} (n={summ['n']})  {v}{extra}"
                )
        for ent, block in sorted(self.mfu.items()):
            util = block.get("utilization")
            lines.append(
                f"mfu {ent}: {block['achieved_flops_per_sec']:.4g} FLOP/s "
                f"achieved (pinned {block['flops_per_step']:.4g}/step)"
                + (f", {util:.2%} of the {block['arithmetic']} peak"
                   if util is not None else "")
            )
        for f in self.findings:
            lines.append(
                f"FINDING [{f['kind']}] {f['scenario']}"
                + (f".{f['metric']}" if f.get("metric") else "")
                + f": {f['message']}"
            )
        lines.append(
            f"{len(self.findings)} finding(s) over "
            f"{len(self.results)} scenario(s) "
            f"[fingerprint {self.fingerprint_key}]"
        )
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "version": BENCH_SCHEMA_VERSION,
            "fingerprint": {"key": self.fingerprint_key, **self.env},
            "scenarios": self.scenarios,
            "results": self.results,
            "mfu": self.mfu,
            "findings": self.findings,
            "counts": {
                "scenarios": len(self.results),
                "regressions": sum(
                    1 for f in self.findings if f["kind"] == "regression"
                ),
                "stale": sum(
                    1 for f in self.findings if f["kind"] == "stale"
                ),
                "errors": sum(
                    1 for f in self.findings
                    if f["kind"] in ("error", "timeout", "no-samples",
                                     "no-baseline")
                ),
            },
            "ok": self.ok,
        }, indent=2)


def resolve_selection(scenarios: Sequence[str] | None,
                      tier: str | None) -> list[str]:
    """Explicit names win; else a tier filter; else everything but the
    card-only tier (the same default an operator box can run)."""
    _load_scenarios()
    if scenarios:
        unknown = sorted(set(scenarios) - set(_SCENARIOS))
        if unknown:
            raise BenchUsageError(
                f"unknown scenario(s) {', '.join(unknown)}; known: "
                f"{', '.join(sorted(_SCENARIOS))}"
            )
        return list(scenarios)
    if tier is not None:
        if tier == "tpu":
            raise BenchUsageError(
                "tier 'tpu' is the JAX package's accelerator-only tier; "
                "the port's is 'cuda'"
            )
        if tier not in TIERS:
            raise BenchUsageError(
                f"unknown tier {tier!r}; known: {', '.join(TIERS)}"
            )
        names = [n for n, sc in sorted(_SCENARIOS.items())
                 if sc.tier == tier]
        if not names:
            raise BenchUsageError(f"no scenarios registered in tier {tier!r}")
        return names
    return [n for n, sc in sorted(_SCENARIOS.items()) if sc.tier != "cuda"]


def _child_cmd(sc: Scenario, repetitions: int | None,
               partial: str, device: str) -> list[str]:
    cmd = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.bench",
           "--scenario", sc.name, "--partial", partial, "--device", device]
    if repetitions is not None:
        cmd += ["--repetitions", str(repetitions)]
    return cmd


def _run_child(sc: Scenario, repetitions: int | None, scratch: Path,
               device: str) -> tuple[dict | None, str | None]:
    """(record, note): ``record`` is None only when nothing at all was
    measured (the note then carries the diagnosis). The child's process
    start and its first touch of the card count against ``timeout_s``."""
    partial = scratch / f"{sc.name}.partial.json"
    try:
        proc = subprocess.run(
            _child_cmd(sc, repetitions, str(partial), device),
            cwd=str(REPO_ROOT), timeout=sc.timeout_s,
            capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired:
        rec = _salvage_partial(partial)
        if rec is not None:
            rec["salvaged"] = True
            return rec, (f"timed out after {sc.timeout_s:.0f}s; salvaged "
                         f"{rec.get('completed', 0)} completed repetition(s)")
        return None, f"timed out after {sc.timeout_s:.0f}s, no partial"
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(parsed, dict) or "scenario" not in parsed:
            continue
        if parsed.get("failed"):
            return None, f"child failed: {str(parsed.get('error', ''))[-400:]}"
        return parsed, None
    rec = _salvage_partial(partial)
    if rec is not None:
        rec["salvaged"] = True
        return rec, (f"child died (rc={proc.returncode}); salvaged "
                     f"{rec.get('completed', 0)} completed repetition(s)")
    tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-3:]
    return None, (f"rc={proc.returncode}, no JSON line, no partial; "
                  f"tail: {' | '.join(tail)}")


def _salvage_partial(partial: Path) -> dict | None:
    try:
        rec = json.loads(partial.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None
    return rec if rec.get("completed", 0) >= 1 else None


def run_bench(
    scenarios: Sequence[str] | None = None,
    *,
    tier: str | None = None,
    repetitions: int | None = None,
    baseline_path: Path | None = None,
    isolation: bool = True,
    require_baseline: bool = False,
    device: str = "cuda",
) -> BenchResult:
    """Run the selection on ``device``; the single entry point the CLI and
    the tests share. ``isolation=False`` measures inline (tests, ``bench
    profile``); everything else is identical, including the verdicts.
    ``require_baseline`` turns a gated metric with no committed entry
    under the current fingerprint into a failing finding: the strict
    preflight mode for hosts that must never run ungated.
    """
    from .. import telemetry
    from . import mfu

    if repetitions is not None and repetitions < 1:
        raise BenchUsageError("repetitions must be >= 1")
    names = resolve_selection(scenarios, tier)
    env = environment_fingerprint(device)
    fp_key = fingerprint_key(env)
    bl_path = (
        DEFAULT_BENCH_BASELINE if baseline_path is None else baseline_path
    )
    baseline = load_bench_baseline(bl_path)
    fp_entry = baseline["entries"].get(fp_key, {})
    bl_scenarios = fp_entry.get("scenarios", {})

    results: dict[str, dict] = {}
    findings: list[dict] = []
    mfu_blocks: dict[str, dict] = {}
    scratch = Path(tempfile.mkdtemp(prefix="dsst_bench_"))
    try:
        for name in names:
            sc = _SCENARIOS[name]
            t0 = time.perf_counter()
            if isolation:
                record, note = _run_child(sc, repetitions, scratch, device)
            else:
                try:
                    record, note = measure_scenario(
                        sc, repetitions=repetitions, env=env, device=device,
                        partial_path=scratch / f"{name}.partial.json",
                    ), None
                except Exception as e:  # noqa: BLE001 - reported as finding
                    # Includes BenchUsageError from inside a scenario (an
                    # undeclared emitted metric): in child mode that
                    # surfaces as an error finding, and the in-process
                    # verdicts must stay identical; only pre-run
                    # selection/flag errors are exit-2 usage.
                    record, note = None, f"{type(e).__name__}: {e}"
            if record is None:
                findings.append({
                    "kind": "timeout" if "timed out" in (note or "")
                    else "error",
                    "scenario": name, "message": note or "measured nothing",
                })
                continue
            res = _judge_scenario(sc, record, bl_scenarios.get(name),
                                  findings)
            # The scenario's wall time, a child's start and its first touch
            # of the card included: what its timeout_s is spent on.
            res["seconds"] = {**record.get("seconds", {}),
                              "wall": round(time.perf_counter() - t0, 3)}
            if note:
                res["note"] = note
            if record.get("salvaged"):
                res["salvaged"] = True
            results[name] = res
            if sc.entrypoint and sc.steps_metric:
                summ = res["metrics"].get(sc.steps_metric, {}).get("summary")
                if summ and summ["n"]:
                    block = mfu.publish_achieved(
                        sc.entrypoint, summ["median"],
                        device_kind=env.get("device"), device=env["platform"],
                    )
                    if block is not None:
                        mfu_blocks[sc.entrypoint] = block
    finally:
        import shutil

        shutil.rmtree(scratch, ignore_errors=True)

    findings.extend(_stale_findings(fp_entry))
    if require_baseline:
        for name, res in sorted(results.items()):
            sc = _SCENARIOS[name]
            for mname, m in sorted(res.get("metrics", {}).items()):
                if sc.metric(mname).gate and m.get("verdict") == \
                        "no-baseline":
                    findings.append({
                        "kind": "no-baseline", "scenario": name,
                        "metric": mname,
                        "message": "gated metric has no committed "
                        f"baseline under {fp_key}; record one "
                        "(bench --update-baseline --reason) "
                        "before gating this host",
                    })
    telemetry.counter(
        "bench_scenarios_total", "scenarios measured by bench"
    ).inc(len(results))
    telemetry.counter(
        "bench_regressions_total",
        "regression verdicts reported by bench",
    ).inc(sum(1 for f in findings if f["kind"] == "regression"))
    return BenchResult(
        scenarios=names,
        env=env,
        fingerprint_key=fp_key,
        results=results,
        findings=findings,
        mfu=mfu_blocks,
    )


def _judge_scenario(sc: Scenario, record: dict, bl_entry: dict | None,
                    findings: list[dict]) -> dict:
    res: dict = {
        "tier": sc.tier,
        "completed": record.get("completed", 0),
        "metrics": {},
        "launches": record.get("launches", {}),
    }
    if record.get("extra"):
        res["extra"] = record["extra"]
    bl_metrics = (bl_entry or {}).get("metrics", {})
    for m in sc.metrics:
        samples = record.get("samples", {}).get(m.name, [])
        if not samples:
            findings.append({
                "kind": "no-samples", "scenario": sc.name, "metric": m.name,
                "message": "declared metric produced no samples; the "
                "measure function and the schema disagree",
            })
            continue
        summ = stats.summarize(samples)
        bl = bl_metrics.get(m.name)
        bl_summary = (
            stats.Summary(median=float(bl["median"]),
                          mad=float(bl.get("mad", 0.0)),
                          n=int(bl.get("n", 0)))
            if isinstance(bl, dict) else None
        )
        verdict = stats.classify(
            m.direction, summ, bl_summary, gate=m.gate, floor=m.floor,
        )
        entry = {
            "unit": m.unit,
            "direction": m.direction,
            "summary": summ.to_json(),
            **verdict,
        }
        if bl_summary is not None:
            entry["baseline_median"] = bl_summary.median
        res["metrics"][m.name] = entry
        if verdict["verdict"] == "regression":
            findings.append({
                "kind": "regression", "scenario": sc.name, "metric": m.name,
                "message": (
                    f"{summ.median:.6g} {m.unit} vs baseline "
                    f"{bl_summary.median:.6g} "
                    f"({verdict['rel_change']:+.1%}, tolerance "
                    f"±{verdict['tolerance']:.1%}, "
                    f"{m.direction}-is-better)"
                ),
            })
    return res


def _stale_findings(fp_entry: dict) -> list[dict]:
    """Baseline ballast under the CURRENT fingerprint: a scenario that
    left the registry, or a committed metric that left its scenario's
    schema. Registry membership is static knowledge, so staleness is
    judged on every run regardless of the selection, as the other three
    tiers expire theirs."""
    out: list[dict] = []
    for name, entry in sorted(fp_entry.get("scenarios", {}).items()):
        sc = _SCENARIOS.get(name)
        if sc is None:
            out.append({
                "kind": "stale", "scenario": name,
                "message": "baselined scenario is no longer registered; "
                "remove the entry (bench --update-baseline)",
            })
            continue
        declared = {m.name for m in sc.metrics}
        for mname in sorted(entry.get("metrics", {})):
            if mname not in declared:
                out.append({
                    "kind": "stale", "scenario": name, "metric": mname,
                    "message": "baselined metric left the scenario's "
                    "schema; re-baseline to shed it",
                })
    return out
