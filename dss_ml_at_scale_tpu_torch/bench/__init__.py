"""Performance-observability subsystem of the port: ``bench``.

Port of ``dss_ml_at_scale_tpu/bench/``. The fourth analysis tier: a
scenario registry with noise-aware measurements (median/MAD over
isolated-child repetitions on ``--device``), a committed
environment-fingerprinted baseline (``analysis/baselines/bench.json``)
with the same add/expire/reopen semantics as the lint, audit and sanitize
baselines, achieved-FLOPs/s gauges priced against the audit-pinned cost
budgets and the card's peaks, and a profile mode that merges the
flight-recorder host spans with a ``torch.profiler`` trace (CPU and CUDA
activities) into one Perfetto timeline.
"""

from .core import (
    BENCH_SCHEMA_VERSION,
    DEFAULT_BENCH_BASELINE,
    BenchResult,
    BenchUsageError,
    Metric,
    Scenario,
    environment_fingerprint,
    fingerprint_key,
    get_scenario,
    load_bench_baseline,
    measure_scenario,
    register_scenario,
    resolve_selection,
    run_bench,
    scenario_catalog,
    scenario_names,
    write_bench_baseline,
)

__all__ = [
    "BENCH_SCHEMA_VERSION",
    "BenchResult",
    "BenchUsageError",
    "DEFAULT_BENCH_BASELINE",
    "Metric",
    "Scenario",
    "environment_fingerprint",
    "fingerprint_key",
    "get_scenario",
    "load_bench_baseline",
    "measure_scenario",
    "register_scenario",
    "resolve_selection",
    "run_bench",
    "scenario_catalog",
    "scenario_names",
    "write_bench_baseline",
]
