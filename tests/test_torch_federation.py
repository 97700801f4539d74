"""The port's fleet plane against the JAX package's.

- The wire merges: window sketches and counters, every registry kind, and
  the SLO engine's sources, folded from the same wire documents into a
  JAX and a port receiver, give the same snapshots and the same ``/slo``
  document (equal as JSON); geometry mismatches refuse loudly in both.
- ``FleetAggregator`` over two CPU port servers (``serve-lm --stub``
  processes) plus a dead and a hung endpoint: the partial view inside the
  scrape budget, the self-metering, the journal.
- ``slo check|status --fleet`` and ``top --fleet --once`` (JAX's
  ``tests/test_federation.py`` fleet cases), and the port's and JAX's
  ``slo status --fleet --json`` judging one fleet alike.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dss_ml_at_scale_tpu.config.cli import main as jax_main
from dss_ml_at_scale_tpu.telemetry import federation as jax_federation
from dss_ml_at_scale_tpu.telemetry import slo as jax_slo
from dss_ml_at_scale_tpu.telemetry import windows as jax_windows
from dss_ml_at_scale_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.telemetry import federation, slo, windows
from dss_ml_at_scale_tpu_torch.telemetry.registry import MetricsRegistry

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 60  # seconds, each server start


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _snap(registry) -> list:
    """A registry's snapshot without the windows' rates (per second of the
    reader's wall clock)."""
    return [{k: v for k, v in m.items() if k != "rate"}
            for m in registry.snapshot()["metrics"]]


def test_window_wire_merges_equal_jax():
    clock = FakeClock()
    shards = []
    for k in range(3):
        sk = windows.SlidingQuantile(window_s=60.0, clock=clock)
        for i in range(200):
            sk.observe(0.001 * (1 + (i * 7 + k) % 97), trace=f"{k}{i:015x}")
        shards.append(sk.to_wire())
    port = windows.SlidingQuantile(window_s=60.0, clock=clock)
    ref = jax_windows.SlidingQuantile(window_s=60.0, clock=clock)
    for w in shards:
        port.merge_wire(w)
        ref.merge_wire(w)
    assert port.snapshot() == ref.snapshot() and port.to_wire() == ref.to_wire()
    assert port.worst_trace() == ref.worst_trace()
    assert windows.quantile_of_wire(port.to_wire(), 0.99) == \
        jax_windows.quantile_of_wire(port.to_wire(), 0.99)
    a = windows.WindowedCounter(30.0, clock=clock)
    a.add(3.0)
    b, jb = windows.WindowedCounter(30.0, clock=clock), jax_windows.WindowedCounter(30.0,
                                                                                    clock=clock)
    b.merge_wire(a.to_wire())
    jb.merge_wire(a.to_wire())
    assert b.to_wire() == jb.to_wire() and b.total() == 3.0
    other = windows.SlidingQuantile(window_s=30.0, clock=clock)
    other.observe(1.0)
    for receiver in (port, ref):
        with pytest.raises(ValueError, match="geometry"):
            receiver.merge_wire(other.to_wire())
        with pytest.raises(ValueError, match="version"):
            receiver.merge_wire({**shards[0], "v": 99})


def test_registry_wire_merge_of_every_kind_equals_jax():
    src = MetricsRegistry()
    src.counter("c_total").inc(3)
    src.gauge("g").set(2.5)
    src.counter("lc_total", labels=("k",)).labels(k="a").inc(2)
    h = src.histogram("h_seconds")
    for v in (1e-4, 1e-3, 0.5):
        h.observe(v)
    w = src.window("w_seconds")
    for i in range(100):
        w.observe(0.001 * (i + 1))
    wire = json.loads(json.dumps(src.wire_snapshot()))
    port, ref = MetricsRegistry(), JaxRegistry()
    for _ in range(2):  # two replicas with the same series: additive
        assert port.merge_wire_snapshot(wire) == ref.merge_wire_snapshot(wire) == 5
    assert _snap(port) == _snap(ref)
    assert port.counter("c_total")._children[()].value == 6
    assert port.gauge("g")._children[()].value == 5.0  # gauges sum across a fleet
    assert port.window("w_seconds")._children[()]._sketch.count() == 200
    bad = MetricsRegistry()
    bad.histogram("h_seconds", buckets=(0.1, 1.0))
    with pytest.raises(ValueError, match="buckets"):
        bad.merge_wire_snapshot(wire)
    with pytest.raises(ValueError, match="version"):
        port.merge_wire_snapshot({"version": 99, "metrics": []})


def test_slo_wire_sources_merge_equals_jax():
    clock = FakeClock()
    a, b = slo.SloEngine(clock=clock), slo.SloEngine(clock=clock)
    for _ in range(30):
        a.note_request(0.010, 200)
        b.note_request(0.010, 503)
    a.note_feeder_wait(0.5)
    b.note_train_step(0.3, "cd" * 8)
    a.set_latency_budget(0.5)
    port, ref = slo.SloEngine(clock=clock), jax_slo.SloEngine(clock=clock)
    for doc in (a.wire_sources(), b.wire_sources()):
        doc = json.loads(json.dumps(doc))
        assert port.merge_wire_sources(doc) == ref.merge_wire_sources(doc)
    got, want = port.render_status(), ref.render_status()
    got.pop("ts")
    want.pop("ts")
    assert got == want
    err = next(o for o in got["objectives"] if o["name"] == "serving_error_rate")
    assert err["samples"] == 60 and err["value"] == pytest.approx(0.5)
    assert port.latency_budget == 0.5  # the strictest budget seen
    port.reset_sources()
    assert port.render_status()["objectives"][0]["samples"] == 0
    with pytest.raises(ValueError, match="version"):
        port.merge_wire_sources({**a.wire_sources(), "version": 99})


def test_burning_and_fleet_journal_equal_jax(tmp_path):
    doc = {"firing": ["a"], "objectives": [
        {"name": "a", "burn_fast": 0, "burn_slow": 0, "burn_threshold": 6.0},
        {"name": "b", "burn_fast": 50.0, "burn_slow": 50.0, "burn_threshold": 6.0},
        {"name": "c", "burn_fast": 50.0, "burn_slow": 0.0, "burn_threshold": 6.0}]}
    assert federation.burning(doc) == jax_federation.burning(doc) == ["a", "b"]
    p = tmp_path / "fleet.jsonl"
    p.write_text(json.dumps({"kind": "fleet_scrape", "ts": 1.0, "up": 2}) + "\n"
                 + json.dumps({"kind": "other"}) + "\n" + '{"kind": "fleet_scr')
    assert federation.read_fleet_journal(p) == jax_federation.read_fleet_journal(p)
    assert len(federation.read_fleet_journal(p)) == 1
    assert federation.parse_endpoint("http://h:81/") == ("h", 81)
    with pytest.raises(ValueError):
        federation.parse_endpoint("https://h:81")


# -- a live fleet of CPU port servers -----------------------------------------


def _generate(port: int, n: int) -> None:
    for _ in range(n):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/generate",
                     json.dumps({"tokens": [1, 2], "max_new_tokens": 3}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        conn.close()
        assert resp.status == 200


@pytest.fixture(scope="module")
def port_fleet():
    """Two ``serve-lm --stub --device cpu`` processes of the port, each
    having answered a few generations."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs, endpoints = [], []
    try:
        for _ in range(2):
            proc = subprocess.Popen(
                [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "serve-lm",
                 "--stub", "--device", "cpu", "--port", "0", "--slots", "2", "--max-len",
                 "32", "--prefill-buckets", "8", "--step-ms", "1", "--no-tracking"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env)
            procs.append(proc)
            boot = json.loads(proc.stdout.readline())
            _generate(boot["port"], 4)
            endpoints.append(f"127.0.0.1:{boot['port']}")
        yield endpoints
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=LIMIT)


def _run(entry, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = entry(argv)
    return rc, out.getvalue()


def test_aggregator_merges_live_replicas_and_journals(port_fleet, tmp_path):
    journal = tmp_path / "fleet.jsonl"
    agg = federation.FleetAggregator(port_fleet, journal_path=journal)
    view = agg.scrape()
    assert view.up == 2 and all(r.outcome == "ok" for r in view.replicas)
    assert view.merged_series > 0
    tokens = view.registry.counter("lm_tokens_total")._children[()].value
    assert tokens == 2 * 4 * 3  # counters federate exactly
    assert view.slo["ok"] is True
    cycles = federation.read_fleet_journal(journal)
    assert cycles and cycles[-1]["up"] == 2 and cycles[-1]["ok"] is True


def test_fleet_survives_dead_and_hung_endpoints(port_fleet):
    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(1)  # accepts (the kernel's backlog) and never answers
    hung_ep = f"127.0.0.1:{hung.getsockname()[1]}"
    try:
        agg = federation.FleetAggregator([port_fleet[0], "127.0.0.1:9", hung_ep],
                                         timeout_s=0.5)
        t0 = time.monotonic()
        view = agg.scrape()
        assert time.monotonic() - t0 < 3.0
        by = {r.endpoint: r for r in view.replicas}
        assert view.up == 1 and by[port_fleet[0]].outcome == "ok"
        assert by["127.0.0.1:9"].outcome == "down" and by[hung_ep].up is False
        assert telemetry.get_registry().gauge("fleet_replicas_up")._children[()].value == 1.0
        assert view.registry.counter("lm_tokens_total")._children[()].value == 12
    finally:
        hung.close()


def test_fleet_cli_check_status_and_top(port_fleet, tmp_path):
    journal = tmp_path / "cli_fleet.jsonl"
    rc, out = _run(main, ["slo", "check", "--fleet", *port_fleet,
                          "--fleet-journal", str(journal), "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] is True and doc["up"] == 2 and len(doc["replicas"]) == 2
    assert federation.read_fleet_journal(journal)
    rc, out = _run(main, ["top", "--fleet", *port_fleet, "--once"])
    assert rc == 0 and "REPLICA" in out and "2 up" in out and "lm_ttft_window_seconds" in out
    rc, out = _run(main, ["slo", "status", "--fleet", *port_fleet, "127.0.0.1:9"])
    assert rc == 0 and "ttft_p99" in out and "down" in out
    assert _run(main, ["slo", "check", "--fleet", "127.0.0.1:9"])[0] == 2


def _volatile_free(doc: dict) -> dict:
    doc = {k: v for k, v in doc.items() if k != "ts"}
    doc["replicas"] = [{k: v for k, v in r.items() if k not in ("elapsed_ms", "staleness_s")}
                       for r in doc["replicas"]]
    doc["slo"] = {k: v for k, v in doc["slo"].items() if k != "ts"}
    return doc


def test_fleet_status_json_equals_jax(port_fleet):
    argv = ["slo", "status", "--fleet", *port_fleet, "127.0.0.1:9", "--json"]
    # A first scrape registers the servers' series for the /telemetry route
    # itself; the two compared scrapes then read the same series.
    _run(main, argv)
    rc, out = _run(main, argv)
    jax_rc, jax_out = _run(jax_main, argv)
    assert rc == jax_rc == 0
    assert _volatile_free(json.loads(out)) == _volatile_free(json.loads(jax_out))


def test_file_exports_and_remote_snapshots_equal_jax(tmp_path):
    from dss_ml_at_scale_tpu.telemetry import export as jax_export
    from dss_ml_at_scale_tpu_torch.parallel.trials import serve_trial_worker
    from dss_ml_at_scale_tpu_torch.telemetry import export
    from dss_ml_at_scale_tpu_torch.telemetry.spans import SpanLog

    registry, log = MetricsRegistry(), SpanLog()
    registry.counter("c_total").inc(2)
    registry.histogram("h_seconds").observe(0.01)
    with log.span("trial"):
        pass
    got = export.write_exports(tmp_path / "port", registry=registry, span_log=log)
    want = jax_export.write_exports(tmp_path / "jax", registry=registry, span_log=log,
                                    coordinator_only=False)
    assert [p.name for p in got] == [p.name for p in want] == [
        "telemetry.json", "metrics.prom", "spans.jsonl", "trace.json"]
    port_snap, jax_snap = (json.loads(p[0].read_text()) for p in (got, want))
    assert {**port_snap, "ts": 0} == {**jax_snap, "ts": 0}  # the snapshot's own clock
    for a, b in zip(got[1:], want[1:]):
        assert a.read_text() == b.read_text()
    # A coordinator pulls a trial worker's snapshot over RPC; a dead worker
    # costs its own entry only.
    server = serve_trial_worker(block=False)
    try:
        addr = f"{server.address[0]}:{server.address[1]}"
        snaps = export.collect_remote_snapshots([addr, "127.0.0.1:9"], timeout=10.0)
    finally:
        server.shutdown()
    assert "metrics" in snaps[addr]
    assert "error" in snaps["127.0.0.1:9"]
