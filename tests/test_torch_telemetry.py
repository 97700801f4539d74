"""The port's telemetry copies against the JAX package's, on the same inputs.

The port keeps its own cut of ``telemetry/`` (the JAX package's imports
JAX through its device monitor). Same operations in, same renderings,
quantiles, alert transitions and trace parsing out.
"""

import numpy as np
import pytest

from dss_ml_at_scale_tpu.telemetry import registry as jax_registry
from dss_ml_at_scale_tpu.telemetry import slo as jax_slo
from dss_ml_at_scale_tpu.telemetry import tracecontext as jax_tc
from dss_ml_at_scale_tpu.telemetry import windows as jax_windows
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.telemetry import registry, slo, tracecontext, windows


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _drive(reg):
    reg.counter("tokens_total", "tokens").inc(3)
    reg.gauge("depth", "queue depth").set(7)
    h = reg.histogram("lat_seconds", "latency", labels=("path",))
    for v in (0.001, 0.02, 0.3, 4.0):
        h.labels(path="/generate").observe(v)
    reg.counter("errors_total", "errors", labels=("code",)).labels(code="429").inc()


def test_prometheus_rendering_matches_jax():
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    _drive(ours)
    _drive(theirs)
    assert ours.render_prometheus() == theirs.render_prometheus()
    a, b = ours.wire_snapshot(), theirs.wire_snapshot()
    assert a["metrics"] == b["metrics"] and a["version"] == b["version"]


def test_registry_refuses_kind_and_label_clashes():
    reg = registry.MetricsRegistry()
    reg.counter("x", labels=("a",))
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="labels"):
        reg.counter("x", labels=("b",))


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_sliding_quantile_matches_jax(q):
    rng = np.random.default_rng(0)
    samples = rng.lognormal(-4, 1.0, 500)
    clock = _Clock()
    ours = windows.SlidingQuantile(window_s=60, clock=clock)
    theirs = jax_windows.SlidingQuantile(window_s=60, clock=clock)
    for i, v in enumerate(samples):
        clock.t += 0.05
        ours.observe(v, trace=f"t{i}")
        theirs.observe(v, trace=f"t{i}")
    assert ours.quantile(q) == theirs.quantile(q)
    assert ours.to_wire() == theirs.to_wire()
    assert ours.snapshot() == theirs.snapshot()


def test_ttft_alert_walks_the_same_states_as_jax():
    clock = _Clock()
    ours = slo.SloEngine(clock=clock)
    theirs = jax_slo.SloEngine(clock=clock)
    for eng in (ours, theirs):
        eng.set_target("ttft_p99", 0.01)
    seen = {"ours": [], "theirs": []}
    for step in range(40):
        clock.t += 1.0
        for name, eng in (("ours", ours), ("theirs", theirs)):
            eng.note_ttft(0.5, trace_id="feedc0de12345678")
            row = next(o for o in eng.render_status()["objectives"]
                       if o["name"] == "ttft_p99")
            seen[name].append(row["state"])
    assert seen["ours"] == seen["theirs"]
    assert "pending" in seen["ours"] and seen["ours"][-1] == "firing"
    doc = ours.render_status()
    row = next(o for o in doc["objectives"] if o["name"] == "ttft_p99")
    want = next(o for o in theirs.render_status()["objectives"]
                if o["name"] == "ttft_p99")
    assert {k: row[k] for k in ("value", "budget", "state", "samples")} == \
        {k: want[k] for k in ("value", "budget", "state", "samples")}


@pytest.mark.parametrize("header", [
    "dsst1-feedc0de12345678-abcd1234-request",
    "dsst1-FEEDC0DE12345678-abcd1234-request",
    "dsst2-feedc0de12345678-abcd1234-request",
    "dsst1-feedc0de-abcd1234-request",
    "x" * 100,
    None,
])
def test_trace_header_parsing_matches_jax(header):
    ours = tracecontext.Handoff.from_header(header).ctx
    theirs = jax_tc.Handoff.from_header(header).ctx
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert (ours.trace_id, ours.span_id, ours.kind) == \
            (theirs.trace_id, theirs.span_id, theirs.kind)


def test_spans_carry_the_active_trace():
    with tracecontext.trace(kind="request", trace_id="0123456789abcdef") as ctx:
        with telemetry.span("serve.generate", route="/generate"):
            with telemetry.span("lm.prefill"):
                pass
    events = [e for e in telemetry.get_span_log().events()
              if e.get("trace") == "0123456789abcdef"]
    inner = next(e for e in events if e["name"] == "lm.prefill")
    outer = next(e for e in events if e["name"] == "serve.generate")
    assert outer["parent"] == ctx.span_id
    assert inner["parent"] == outer["span"]
    assert outer["args"] == {"route": "/generate"} and outer["dur"] >= 0
