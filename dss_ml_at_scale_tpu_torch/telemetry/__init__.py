"""Telemetry of the port: metrics registry, spans, flight recorder, device
stats, SLOs, exports and the fleet merge.

Port copy of ``dss_ml_at_scale_tpu/telemetry`` (the JAX package's
``telemetry`` imports JAX through its device monitor, so the port keeps its
own copy; :mod:`.device` reads ``torch.cuda`` instead). One process-local
place where training (step time, throughput, data wait, compile events),
HPO (per-trial spans and outcomes), the input pipeline (feeder depth, stall
time) and serving (request latency, error counts) meter themselves,
renderable as Prometheus text for a ``GET /metrics`` scrape, archivable as
JSON into a run's :class:`~dss_ml_at_scale_tpu_torch.tracking.RunStore`,
and exportable as a Chrome/Perfetto trace of the whole run.

Module-level helpers (``counter``/``gauge``/``histogram``/``span``) hit the
process-default registry and span log, so instrumentation points never
thread a registry object through APIs; tests and embedders that need
isolation construct their own :class:`MetricsRegistry`/:class:`SpanLog`.
"""

from __future__ import annotations

from .device import CompileTracker, DeviceMonitor, device_memory_stats
from .export import collect_remote_snapshots, rpc_handlers, write_exports
from .registry import (
    DEFAULT_BUCKETS,
    MetricFamily,
    MetricsRegistry,
    SampledObserver,
    log_buckets,
)
from .spans import SpanLog, export_perfetto, to_perfetto
from . import federation, flightrec, slo, tracecontext, windows
from .tracecontext import Handoff, TraceContext
from .windows import SlidingQuantile, WindowedCounter, quantile

__all__ = [
    "CompileTracker",
    "DEFAULT_BUCKETS",
    "DeviceMonitor",
    "Handoff",
    "MetricFamily",
    "MetricsRegistry",
    "SampledObserver",
    "SlidingQuantile",
    "SpanLog",
    "TraceContext",
    "WindowedCounter",
    "collect_remote_snapshots",
    "counter",
    "device_memory_stats",
    "export_perfetto",
    "federation",
    "flightrec",
    "gauge",
    "get_registry",
    "get_span_log",
    "histogram",
    "log_buckets",
    "quantile",
    "render_prometheus",
    "reset",
    "rpc_handlers",
    "slo",
    "snapshot",
    "span",
    "to_perfetto",
    "tracecontext",
    "window",
    "windows",
    "write_exports",
]

_registry = MetricsRegistry()
_span_log = SpanLog()


def get_registry() -> MetricsRegistry:
    """The process-default registry every helper below writes to."""
    return _registry


def get_span_log() -> SpanLog:
    """The process-default span log."""
    return _span_log


def counter(name: str, help: str = "", labels=()) -> MetricFamily:
    return _registry.counter(name, help, labels)


def gauge(name: str, help: str = "", labels=()) -> MetricFamily:
    return _registry.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels=(),
              buckets=None) -> MetricFamily:
    return _registry.histogram(name, help, labels, buckets)


def window(name: str, help: str = "", labels=(), window_s=None,
           quantiles=None) -> MetricFamily:
    """A sliding-window quantile series on the default registry (live
    p50/p99/rate/max over the last ``window_s`` seconds)."""
    return _registry.window(name, help, labels, window_s, quantiles)


def span(name: str, **args):
    """``with telemetry.span("train_step"): ...`` on the default span log."""
    return _span_log.span(name, **args)


def snapshot() -> dict:
    return _registry.snapshot()


def render_prometheus() -> str:
    return _registry.render_prometheus()


def reset() -> None:
    """Zero every default-registry series, clear the span log, and
    reset the SLO engine's windows/alert states.

    Test isolation and epoch-boundary resets; registrations survive.
    """
    _registry.reset()
    _span_log.clear()
    slo.reset()
