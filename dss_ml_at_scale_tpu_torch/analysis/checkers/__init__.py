"""Checker plugins. Importing this package registers every rule: nine
whose meaning is the JAX package's, reconciled against the port's own
registries, and three JAX rules retargeted to torch (``host-sync``,
``trace-safety``, ``retrace-hazard``).
"""

from . import (  # noqa: F401
    bare_except,
    bench_registry,
    durable_write,
    fault_sites,
    host_sync,
    lock_discipline,
    no_print,
    retrace_hazard,
    slo_registry,
    span_discipline,
    telemetry_registry,
    trace_safety,
)
