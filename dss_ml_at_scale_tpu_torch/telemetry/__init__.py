"""Telemetry of the port: metrics registry, spans, trace ids, SLOs.

Port copy of what the LM serving path calls from
``dss_ml_at_scale_tpu/telemetry`` (the JAX package's ``telemetry``
imports JAX through its device monitor, so the port keeps its own copy).
Module-level helpers hit the process-default registry and span log, so
instrumentation points never thread a registry object through APIs.
"""

from __future__ import annotations

from . import slo, tracecontext, windows
from .export import rpc_handlers
from .registry import DEFAULT_BUCKETS, MetricFamily, MetricsRegistry, log_buckets
from .spans import SpanLog
from .tracecontext import Handoff, TraceContext
from .windows import SlidingQuantile

__all__ = [
    "DEFAULT_BUCKETS",
    "Handoff",
    "MetricFamily",
    "MetricsRegistry",
    "SlidingQuantile",
    "SpanLog",
    "TraceContext",
    "counter",
    "gauge",
    "get_registry",
    "get_span_log",
    "histogram",
    "log_buckets",
    "render_prometheus",
    "rpc_handlers",
    "slo",
    "snapshot",
    "span",
    "tracecontext",
    "window",
    "windows",
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
    """A sliding-window quantile series on the default registry."""
    return _registry.window(name, help, labels, window_s, quantiles)


def span(name: str, **args):
    """``with telemetry.span("lm.step"): ...`` on the default span log."""
    return _span_log.span(name, **args)


def snapshot() -> dict:
    return _registry.snapshot()


def render_prometheus() -> str:
    return _registry.render_prometheus()

