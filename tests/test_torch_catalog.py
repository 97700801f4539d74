"""The port's telemetry catalog against its call sites, both ways.

Every literal name at a ``counter()``/``gauge()``/``histogram()``/
``window()`` call site of the port is declared in
``telemetry/catalog.py::KNOWN_METRICS`` with that kind, every literal name
at a ``span()`` or ``SpanLog.record()`` call site is in ``KNOWN_SPANS``,
and every declared name still has a call site: the port's stand-in for the
JAX package's ``telemetry-registry`` and ``span-discipline`` lint rules.
The SLO objectives and the attribution buckets are held to the catalog
too.
"""

from __future__ import annotations

import ast
from pathlib import Path

from dss_ml_at_scale_tpu.telemetry import catalog as jax_catalog
from dss_ml_at_scale_tpu_torch.telemetry import catalog, slo

PACKAGE = Path(__file__).resolve().parents[1] / "dss_ml_at_scale_tpu_torch"
METRIC_KINDS = ("counter", "gauge", "histogram", "window")


def _call_sites() -> tuple[dict[str, set[str]], set[str]]:
    metrics: dict[str, set[str]] = {}
    spans: set[str] = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            func = node.func
            called = (func.attr if isinstance(func, ast.Attribute)
                      else func.id if isinstance(func, ast.Name) else None)
            if called in METRIC_KINDS:
                metrics.setdefault(node.args[0].value, set()).add(called)
            elif called in ("span", "record"):
                spans.add(node.args[0].value)
    return metrics, spans


def test_every_metric_call_site_is_declared_with_its_kind_and_back():
    metrics, _ = _call_sites()
    undeclared = {m: k for m, k in metrics.items() if m not in catalog.KNOWN_METRICS}
    assert not undeclared, f"metric call sites missing from KNOWN_METRICS: {undeclared}"
    wrong = {m: (k, catalog.KNOWN_METRICS[m]) for m, k in metrics.items()
             if k != {catalog.KNOWN_METRICS[m]}}
    assert not wrong, f"kind mismatch (call site, catalog): {wrong}"
    stale = sorted(set(catalog.KNOWN_METRICS) - set(metrics))
    assert not stale, f"KNOWN_METRICS entries without a call site: {stale}"


def test_every_span_call_site_is_declared_and_back():
    _, spans = _call_sites()
    assert not spans - set(catalog.KNOWN_SPANS), spans - set(catalog.KNOWN_SPANS)
    assert not set(catalog.KNOWN_SPANS) - spans, set(catalog.KNOWN_SPANS) - spans


def test_slos_and_attribution_are_held_to_the_catalog():
    assert [o.name for o in slo.default_objectives()] == list(catalog.KNOWN_SLOS)
    assert set(catalog.SPAN_ATTRIBUTION) <= set(catalog.KNOWN_SPANS)
    assert set(catalog.SPAN_ATTRIBUTION.values()) <= {"data_wait", "transfer", "compute",
                                                     "host"}
    # Where both packages name a metric or a span bucket, they agree.
    shared = set(catalog.KNOWN_METRICS) & set(jax_catalog.KNOWN_METRICS)
    assert {m: catalog.KNOWN_METRICS[m] for m in shared} == \
        {m: jax_catalog.KNOWN_METRICS[m] for m in shared}
    shared = set(catalog.SPAN_ATTRIBUTION) & set(jax_catalog.SPAN_ATTRIBUTION)
    assert {s: catalog.SPAN_ATTRIBUTION[s] for s in shared} == \
        {s: jax_catalog.SPAN_ATTRIBUTION[s] for s in shared}
    assert catalog.KNOWN_SLOS == jax_catalog.KNOWN_SLOS
