"""The port's image serving: ``Predictor``, the scheduler, the HTTP server and
the inference commands, against the contracts of ``tests/test_serving.py``
and ``tests/test_serving_scheduler.py``.

- A real server over a tiny ``--pallas-fused`` ``tiny-bottleneck``
  checkpoint with a label vocabulary: healthz/readyz, raw and JSON
  predict (pad and chunk, each row as it scores alone), 400/404/413, the
  ``/metrics`` series, ``X-DSST-Trace`` and the access log, the 500 of a
  non-finite score on real rows only, and every served prediction equal to
  ``predict``'s row for the same image.
- The scheduler through the HTTP layer with a Predictor-shaped stub:
  cross-request coalescing, the batch window, 429 + ``Retry-After``, the
  deadline 503 that is never scored, the graceful drain, direct submits.
- The serving SLO objectives: ``classify_request`` and the events
  objectives' burn rates against the JAX package's engine.
- ``restore_state``: best by the metric, the fallback past a corrupt
  step, a pinned corrupt step raising.
- The port's ``make_scorer`` against JAX's ``make_scorer`` on the same
  converted weights: ``tiny-bottleneck`` at the level the JAX resolver
  gives a pallas checkpoint (``fused_bn=bool("pallas")``) and ``vit-tiny``,
  both in bf16: ``pred_prob`` within 2e-2, ``pred_index`` equal wherever
  the top-2 margin exceeds that.
- The CLIs: ``export`` read by JAX's ``load_pretrained_resnet`` with the
  same forward; ``serve`` as a subprocess: the boot line, a request, SIGINT
  drains with rc 0.
"""

import base64
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.config import checkpoints as jax_checkpoints
from dss_ml_at_scale_tpu.models import pretrained as jax_pretrained
from dss_ml_at_scale_tpu.parallel import ClassifierTask as JaxTask
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.config import checkpoints, cli
from dss_ml_at_scale_tpu_torch.models import resnet_state_from_flax, vit_state_from_flax
from dss_ml_at_scale_tpu_torch.parallel import restore_state
from dss_ml_at_scale_tpu_torch.serving import (
    AdmissionController,
    NotAccepting,
    QueueFull,
    SchedulerConfig,
    ServerHandle,
    ServingScheduler,
)
from dss_ml_at_scale_tpu_torch.workloads.serving import (
    NonFiniteScoreError,
    Predictor,
    make_server,
    serve_in_thread,
)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = {"cat": 0, "dog": 1, "fox": 2, "owl": 3}


def _quiet(argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny pallas-fused checkpoint over real JPEGs, with a vocabulary."""
    from dss_ml_at_scale_tpu_torch.data import DeltaTable
    from dss_ml_at_scale_tpu_torch.datagen.images import write_image_delta

    root = tmp_path_factory.mktemp("serve")
    data = root / "images"
    write_image_delta(str(data), 24, classes=4, size=48, seed=0, max_rows_per_file=8)
    (data / "labels.json").write_text(json.dumps(VOCAB))
    ckpt = root / "ckpt"
    rc, out = _quiet(["train", "--data", str(data), "--val-data", str(data),
                      "--model", "tiny-bottleneck", "--pallas-fused", "--num-classes", "4",
                      "--crop", "32", "--batch-size", "8", "--epochs", "2",
                      "--limit-val-batches", "1", "--checkpoint-dir", str(ckpt),
                      "--device", "cpu", "--no-tracking", "--workers", "1",
                      "--learning-rate", "1e-3"])
    assert rc == 0, out
    import pyarrow.parquet as pq

    table = DeltaTable(str(data))
    jpegs = [c for uri in table.file_uris()
             for c in pq.read_table(uri, columns=["content"]).column("content").to_pylist()]
    return ckpt, data, jpegs


@pytest.fixture(scope="module")
def server(trained):
    ckpt, _, jpegs = trained
    predictor = Predictor(str(ckpt), micro_batch=4, device="cpu")
    handle = serve_in_thread(predictor, access_log=str(ckpt.parent / "access.jsonl"))
    yield handle, jpegs, predictor
    handle.close()


def _request(port, method, path, body=None, content_type=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    hdrs = dict(headers or {})
    if content_type:
        hdrs["Content-Type"] = content_type
    conn.request(method, path, body=body, headers=hdrs)
    resp = conn.getresponse()
    raw = resp.read()
    out_headers = dict(resp.getheaders())
    conn.close()
    try:
        payload = json.loads(raw)
    except ValueError:
        payload = raw.decode()
    return resp.status, payload, out_headers


def _predict_raw(port, jpeg):
    return _request(port, "POST", "/predict", body=jpeg, content_type="image/jpeg")


def test_healthz_and_readyz(server):
    handle, _, predictor = server
    status, payload, _ = _request(handle.port, "GET", "/healthz")
    assert status == 200 and payload["status"] == "ok" and payload["state"] == "ready"
    assert payload["model"] == "tiny-bottleneck" and payload["crop"] == 32
    assert payload["checkpoint_step"] == predictor.step
    status, payload, _ = _request(handle.port, "GET", "/readyz")
    assert status == 200 and payload["ready"] is True


def test_predict_raw_jpeg(server):
    handle, jpegs, _ = server
    status, payload, headers = _predict_raw(handle.port, jpegs[0])
    assert status == 200
    (pred,) = payload["predictions"]
    assert 0 <= pred["pred_index"] < 4 and 0.0 < pred["pred_prob"] <= 1.0
    assert pred["pred_label"] == list(VOCAB)[pred["pred_index"]]
    assert headers["X-DSST-Trace"]


def test_predict_json_batch_pads_and_chunks(server):
    handle, jpegs, _ = server
    # 7 instances through a micro-batch of 4: one full chunk and one
    # padded one, in order; each row as the image scores alone.
    body = json.dumps({"instances": [base64.b64encode(j).decode() for j in jpegs[:7]]})
    status, payload, _ = _request(handle.port, "POST", "/predict", body=body,
                                  content_type="application/json")
    assert status == 200 and len(payload["predictions"]) == 7
    for i in (0, 4, 6):
        status, single, _ = _predict_raw(handle.port, jpegs[i])
        assert single["predictions"][0]["pred_index"] == payload["predictions"][i]["pred_index"]
        assert single["predictions"][0]["pred_prob"] == pytest.approx(
            payload["predictions"][i]["pred_prob"], rel=1e-5)


def test_malformed_input_is_400_and_unknown_route_404(server):
    handle, _, _ = server
    port = handle.port
    status, payload, _ = _request(port, "POST", "/predict", body=b"{not json",
                                  content_type="application/json")
    assert status == 400 and "error" in payload
    status, _, _ = _request(port, "POST", "/predict", body=json.dumps({"instances": []}),
                            content_type="application/json")
    assert status == 400
    status, _, _ = _predict_raw(port, b"not a jpeg")
    assert status == 400
    assert _request(port, "GET", "/nope")[0] == 404
    assert _request(port, "POST", "/nope")[0] == 404
    assert _request(port, "GET", "/healthz")[0] == 200  # still serving


def test_metrics_scrape_has_the_serving_series(server):
    handle, jpegs, _ = server
    assert _predict_raw(handle.port, jpegs[1])[0] == 200
    status, text, headers = _request(handle.port, "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    for line in ("# TYPE serving_request_seconds histogram",
                 'serving_request_seconds_bucket{path="/predict",le="+Inf"}',
                 "# TYPE predict_batch_seconds histogram", "predict_batch_seconds_count",
                 "predict_images_total", "predict_errors_total",
                 "# TYPE serving_batch_fill histogram", "serving_batch_fill_count",
                 "# TYPE serving_queue_depth gauge",
                 "# TYPE serving_time_in_queue_seconds histogram",
                 "serving_admission_rejected_total", "serving_deadline_expired_total",
                 "serving_batches_total", "# TYPE serving_request_window_seconds summary"):
        assert line in text, line
    status, slo, _ = _request(handle.port, "GET", "/slo")
    names = {o["name"]: o for o in slo["objectives"]}
    assert status == 200 and names["serving_error_rate"]["samples"] >= 1


def test_access_log_rows_carry_the_trace(server, trained):
    handle, jpegs, _ = server
    inbound = "dsst1-0123456789abcdef-01234567-request"
    status, _, headers = _request(handle.port, "POST", "/predict", body=jpegs[2],
                                  content_type="image/jpeg", headers={"X-DSST-Trace": inbound})
    assert status == 200 and headers["X-DSST-Trace"] == "0123456789abcdef"
    rows = [json.loads(line) for line in
            (trained[0].parent / "access.jsonl").read_text().splitlines()]
    row = next(r for r in rows if r["request_id"] == "0123456789abcdef")
    assert row["trace_inherited"] is True and row["status"] == 200 and row["images"] == 1
    assert row["batch_fill"] >= 1 and row["queue_ms"] >= 0 and row["slo"] == "ok"
    # The request's trace follows it onto the decode and batcher threads.
    spans = {e["name"] for e in telemetry.get_span_log().events()
             if e.get("trace") == "0123456789abcdef"}
    assert {"serve.request", "serve.decode", "serve.score"} <= spans


def test_nonfinite_scores_on_real_rows_are_500(server):
    handle, jpegs, predictor = server
    real = predictor._score

    def nan_in_padding(images):  # the padding rows may score anything
        idx, prob = real(images)
        prob = prob.clone()
        prob[1:] = float("nan")
        return idx, prob

    predictor._score = nan_in_padding
    try:
        assert _predict_raw(handle.port, jpegs[0])[0] == 200  # 1 real row of 4
        images = predictor.decode(jpegs[:2])
        with pytest.raises(NonFiniteScoreError):
            predictor.score(images)
        status, payload, _ = _request(
            handle.port, "POST", "/predict", content_type="application/json",
            body=json.dumps({"instances": [base64.b64encode(j).decode() for j in jpegs[:2]]}))
        assert status == 500 and "non-finite" in payload["error"]
    finally:
        predictor._score = real


def test_serving_matches_predict(server, trained, tmp_path):
    """Every served prediction is ``predict``'s row for the same image."""
    import pyarrow.parquet as pq

    from dss_ml_at_scale_tpu_torch.data import DeltaTable

    handle, jpegs, _ = server
    ckpt, data, _ = trained
    rc, out = _quiet(["predict", "--data", str(data), "--checkpoint-dir", str(ckpt),
                      "--out", str(tmp_path / "preds"), "--batch-size", "5",
                      "--device", "cpu"])
    assert rc == 0, out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["rows"] == len(jpegs) == 24
    table = DeltaTable(str(tmp_path / "preds"))
    rows = {}
    for uri in table.file_uris():
        for r in pq.read_table(uri).to_pylist():
            rows[r["row"]] = r
    assert sorted(rows) == list(range(24))
    body = json.dumps({"instances": [base64.b64encode(j).decode() for j in jpegs]})
    status, payload, _ = _request(handle.port, "POST", "/predict", body=body,
                                  content_type="application/json")
    assert status == 200
    for i, served in enumerate(payload["predictions"]):
        assert served["pred_index"] == rows[i]["pred_index"], i
        assert served["pred_prob"] == pytest.approx(rows[i]["pred_prob"], rel=1e-5)
        assert served["pred_label"] == rows[i]["pred_label"]


# -- the scheduler, through the HTTP layer, with a stub --------------------


class _Scorer:
    """Predictor-shaped stub: decode parses the payload's integer, score
    echoes it back as pred_index."""

    meta = {"model": "stub"}
    step = 0
    crop = 4

    def __init__(self, micro_batch=8, score_delay_s=0.0):
        self.micro_batch = micro_batch
        self.score_delay_s = score_delay_s
        self.batches = []
        self._lock = threading.Lock()

    def decode(self, jpegs):
        return np.array([[float(int(j))] for j in jpegs])

    def score(self, images):
        if self.score_delay_s:
            time.sleep(self.score_delay_s)
        with self._lock:
            self.batches.append(len(images))
        return [{"pred_index": int(v[0]), "pred_prob": 1.0} for v in images]

    @property
    def images_scored(self):
        with self._lock:
            return sum(self.batches)


def _metric(name):
    for m in telemetry.snapshot()["metrics"]:
        if m["name"] == name and not m.get("labels"):
            return m
    return None


def _count_sum(name):
    m = _metric(name)
    return (m["count"], m["sum"]) if m else (0, 0.0)


def _value(name):
    m = _metric(name)
    return m["value"] if m else 0.0


def _concurrently(n, fn):
    barrier = threading.Barrier(n)
    results = {}

    def client(i):
        barrier.wait()
        results[i] = fn(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return results


def test_concurrent_singles_coalesce_into_micro_batches():
    stub = _Scorer(micro_batch=8, score_delay_s=0.05)
    handle = serve_in_thread(stub, config=SchedulerConfig(queue_depth=64,
                                                          batch_window_ms=250.0))
    try:
        count0, sum0 = _count_sum("serving_batch_fill")
        results = _concurrently(16, lambda i: _predict_raw(handle.port, str(i).encode()))
        for i, (status, payload, _) in results.items():
            assert status == 200 and payload["predictions"][0]["pred_index"] == i
        assert stub.images_scored == 16
        assert stub.images_scored / len(stub.batches) > 4, stub.batches
        count, total = _count_sum("serving_batch_fill")
        assert count - count0 == len(stub.batches) and (total - sum0) / (count - count0) > 4
    finally:
        handle.close()


def test_single_request_pays_at_most_the_window():
    stub = _Scorer(micro_batch=8)
    handle = serve_in_thread(stub, config=SchedulerConfig(batch_window_ms=20.0))
    try:
        t0 = time.monotonic()
        status, payload, _ = _predict_raw(handle.port, b"3")
        assert status == 200 and payload["predictions"][0]["pred_index"] == 3
        assert stub.batches == [1] and time.monotonic() - t0 < 5.0
    finally:
        handle.close()


def test_json_batch_order_and_width_limits():
    stub = _Scorer(micro_batch=4)
    handle = serve_in_thread(stub, config=SchedulerConfig(queue_depth=4,
                                                          batch_window_ms=5.0))
    try:
        def post(values):
            body = json.dumps({"instances": [base64.b64encode(str(v).encode()).decode()
                                             for v in values]})
            return _request(handle.port, "POST", "/predict", body=body,
                            content_type="application/json")

        status, payload, _ = post([5, 9, 2])
        assert status == 200 and [p["pred_index"] for p in payload["predictions"]] == [5, 9, 2]
        status, payload, _ = post(range(5))  # wider than the whole queue: never 429
        assert status == 400 and "queue depth" in payload["error"]
        status, payload, _ = _predict_raw(handle.port, b"not-an-int")
        assert status == 400
        assert _predict_raw(handle.port, b"11")[1]["predictions"][0]["pred_index"] == 11
    finally:
        handle.close()


def test_oversized_body_is_413_and_closes_the_connection():
    server = make_server(_Scorer(), port=0, max_body_bytes=16,
                         config=SchedulerConfig(batch_window_ms=1.0))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    handle = ServerHandle(server, thread)
    try:
        status, payload, headers = _predict_raw(handle.port, b"x" * 64)
        assert status == 413 and "exceeds" in payload["error"]
        assert headers.get("Connection", "").lower() == "close"
        assert _predict_raw(handle.port, b"4")[1]["predictions"][0]["pred_index"] == 4
    finally:
        handle.close()


def test_full_queue_returns_429_with_retry_after():
    stub = _Scorer(micro_batch=1, score_delay_s=0.2)
    handle = serve_in_thread(stub, config=SchedulerConfig(queue_depth=2, batch_window_ms=1.0,
                                                          decode_workers=1))
    try:
        rejected0 = _value("serving_admission_rejected_total")
        results = _concurrently(10, lambda i: _predict_raw(handle.port, str(i).encode()))
        statuses = [results[i][0] for i in range(10)]
        assert 429 in statuses and statuses.count(200) >= 1 and set(statuses) <= {200, 429}
        for status, payload, headers in results.values():
            if status == 429:
                assert int(headers["Retry-After"]) >= 1 and "full" in payload["error"]
        assert _value("serving_admission_rejected_total") - rejected0 == statuses.count(429)
        for _ in range(100):  # transient: the drained queue admits again
            status, payload, _ = _predict_raw(handle.port, b"7")
            if status == 200:
                break
            time.sleep(0.05)
        assert status == 200 and payload["predictions"][0]["pred_index"] == 7
    finally:
        handle.close()


def test_deadline_expired_is_503_and_never_scored():
    stub = _Scorer(micro_batch=1, score_delay_s=0.4)
    handle = serve_in_thread(stub, config=SchedulerConfig(
        queue_depth=64, batch_window_ms=1.0, deadline_ms=120.0, decode_workers=1))
    expired0 = _value("serving_deadline_expired_total")
    first = {}
    occupant = threading.Thread(target=lambda: first.update(r=_predict_raw(handle.port, b"1")))
    try:
        occupant.start()
        time.sleep(0.1)  # the occupant is scoring
        t0 = time.monotonic()
        status, payload, _ = _predict_raw(handle.port, b"2")
        assert status == 503 and "deadline" in payload["error"]
        assert time.monotonic() - t0 < 0.35  # at the deadline, not after the score
        occupant.join(10)
        assert first["r"][0] == 503  # scored late: still a 503
    finally:
        handle.close()
    assert stub.images_scored == 1, stub.batches
    assert _value("serving_deadline_expired_total") - expired0 == 2


def test_graceful_drain_finishes_queued_work_then_closes():
    stub = _Scorer(micro_batch=2, score_delay_s=0.3)
    handle = serve_in_thread(stub, config=SchedulerConfig(queue_depth=64, batch_window_ms=1.0))
    port = handle.port
    slow = {}
    client = threading.Thread(target=lambda: slow.update(r=_predict_raw(port, b"5")))
    client.start()
    time.sleep(0.05)
    closer = threading.Thread(target=handle.close)
    closer.start()
    time.sleep(0.05)
    status, payload, _ = _request(port, "GET", "/readyz")
    assert status == 503 and payload["state"] == "draining"
    status, payload, _ = _request(port, "GET", "/healthz")
    assert status == 200 and payload["state"] == "draining"
    status, payload, _ = _predict_raw(port, b"9")
    assert status == 503 and "not accepting" in payload["error"]
    closer.join(15)
    client.join(15)
    assert slow["r"][0] == 200 and slow["r"][1]["predictions"][0]["pred_index"] == 5
    with pytest.raises(OSError):
        _request(port, "GET", "/healthz")
    handle.close()  # idempotent


def test_scheduler_direct_submit_stop_and_readiness():
    sched = ServingScheduler(_Scorer(micro_batch=4),
                             SchedulerConfig(queue_depth=8, batch_window_ms=5.0)).start()
    with pytest.raises(NotAccepting):
        sched.submit([b"1"])  # still STARTING
    sched.lifecycle.mark_ready()
    try:
        assert [r["pred_index"] for r in sched.submit([b"3", b"7"])] == [3, 7]
        with pytest.raises(ValueError):
            sched.submit([])
        with pytest.raises(ValueError):
            sched.submit([b"1"] * 9)
    finally:
        sched.stop()
    assert sched.pending == 0
    with pytest.raises(NotAccepting):
        sched.submit([b"1"])


def test_admission_controller_bounds_and_retry_after():
    ac = AdmissionController(2)
    ac.admit(2)
    with pytest.raises(QueueFull) as e:
        ac.admit(1)
    assert e.value.retry_after >= 1 and ac.pending == 2
    assert ac.est_queue_wait_s == pytest.approx(2 * ac.service_rate_ewma)
    ac.release(2)
    ac.admit(1)
    with pytest.raises(QueueFull):
        ac.admit(2)  # all or nothing
    ac.note_service_rate(0.01)
    assert ac.service_rate_ewma == pytest.approx(0.7 * 0.05 + 0.3 * 0.01)


# -- the serving SLO objectives against JAX's --------------------------------


@pytest.mark.parametrize("status", [200, 400, 404, 413, 429, 500, 503])
@pytest.mark.parametrize("dur_s", [0.5, 3.0])
def test_classify_request_matches_jax(status, dur_s):
    from dss_ml_at_scale_tpu.telemetry import slo as jax_slo

    assert telemetry.slo.classify_request(status, dur_s, 2.0) == jax_slo.classify_request(
        status, dur_s, 2.0)


def test_serving_objectives_burn_as_jax():
    from dss_ml_at_scale_tpu.telemetry import slo as jax_slo

    engines, now = [], [0.0]
    for mod in (telemetry.slo, jax_slo):
        engines.append(mod.SloEngine(clock=lambda: now[0]))
        engines[-1].set_latency_budget(2.0)
    for i in range(30):
        for e in engines:
            e.note_request(0.5 if i % 3 else 3.0, 200 if i % 5 else 503, trace_id=f"t{i}")
        now[0] += 0.5
    port, ref = ({o["name"]: o for o in e.render_status()["objectives"]} for e in engines)
    for name in ("serving_latency_p99", "serving_error_rate"):
        for key in ("value", "budget", "burn_fast", "burn_slow", "samples", "state"):
            assert port[name][key] == ref[name][key], (name, key)
    assert port["serving_error_rate"]["state"] == "pending"


# -- restore_state ----------------------------------------------------------


def test_restore_state_best_fallback_and_pinned(trained, tmp_path):
    import shutil

    ckpt, _, _ = trained
    steps = sorted(int(p.name) for p in ckpt.iterdir() if p.name.isdigit())
    assert len(steps) == 2
    metric = {s: json.loads((ckpt / str(s) / "metrics.json").read_text())["val_acc"]
              for s in steps}
    best = max(steps, key=lambda s: (metric[s], s))
    _, _, _, task = checkpoints.resolve_checkpoint(ckpt, device="cpu")
    assert restore_state(task, ckpt) == best
    state = torch.load(ckpt / str(best) / "state.pt", weights_only=True)["model"]
    for name, value in task.model.state_dict().items():
        assert torch.equal(value, state[name]), name
    assert restore_state(task, ckpt, prefer="latest") == steps[-1]
    copy = tmp_path / "ck"
    shutil.copytree(ckpt, copy)
    (copy / str(best) / "state.pt").write_bytes(b"torn")
    other = [s for s in steps if s != best][0]
    assert restore_state(task, copy) == other  # past the corrupt best
    with pytest.raises(ValueError, match="integrity"):
        restore_state(task, copy, step=best)
    with pytest.raises(FileNotFoundError):
        restore_state(task, copy, step=999)
    with pytest.raises(ValueError, match="prefer"):
        restore_state(task, copy, prefer="newest")


def test_resolver_pins_a_vit_crop_and_diagnoses_meta(tmp_path):
    (tmp_path / "dsst_model.json").write_text(json.dumps(
        {"model": "vit-tiny", "num_classes": 4, "crop": 32}))
    with pytest.raises(ValueError, match="training crop"):
        checkpoints.resolve_checkpoint(tmp_path, 64, device="cpu")
    meta, crop, model, _ = checkpoints.resolve_checkpoint(tmp_path, device="cpu")
    assert crop == 32 and model.pos_embed.shape == (1, 17, 32)
    with pytest.raises(FileNotFoundError, match="dsst_model.json"):
        checkpoints.resolve_checkpoint(tmp_path / "none", device="cpu")
    (tmp_path / "dsst_model.json").write_text("{")
    rc, out = _quiet(["predict", "--data", str(tmp_path), "--checkpoint-dir", str(tmp_path),
                      "--out", str(tmp_path / "p"), "--device", "cpu"])
    assert rc == 1 and "unreadable model metadata" in out


# -- the scorer against JAX's ----------------------------------------------


def _jax_variables(jm, crop, seed):
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(seed), jnp.zeros((1, crop, crop, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if "var" in str(path[-1]):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (leaf + rng.normal(0.0, 0.3, leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("name,crop", [("tiny-bottleneck", 32), ("vit-tiny", 32)])
def test_scorer_matches_jax_make_scorer(name, crop):
    meta_level = "pallas" if name == "tiny-bottleneck" else False
    jm = jax_checkpoints.build_classifier_model(name, num_classes=4, torch_padding=False,
                                                fused_bn=bool(meta_level))
    variables = _jax_variables(jm, crop, seed=3)
    jax_score = jax_checkpoints.make_scorer(JaxTask(model=jm), variables)
    model = checkpoints.build_classifier_model(name, num_classes=4, torch_padding=False,
                                               fused_bn=bool(meta_level), device="cpu",
                                               crop=crop)
    state = (resnet_state_from_flax(variables) if name.startswith("tiny")
             else vit_state_from_flax(variables))
    model.load_state_dict(state)
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

    score = checkpoints.make_scorer(ClassifierTask(model=model))
    images = np.random.default_rng(0).normal(size=(16, crop, crop, 3)).astype(np.float32)
    j_idx, j_prob = (np.asarray(a) for a in jax_score(jnp.asarray(images)))
    t_idx, t_prob = (a.numpy() for a in score(torch.from_numpy(images)))
    tol = 2e-2
    np.testing.assert_allclose(t_prob, j_prob, atol=tol)
    with torch.no_grad():
        probs = torch.softmax(model.eval()(torch.from_numpy(images)).double(), -1).numpy()
    top2 = np.sort(probs, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    assert clear.sum() >= 8  # the comparison has teeth
    np.testing.assert_array_equal(t_idx[clear], j_idx[clear])


# -- the CLIs ----------------------------------------------------------------


def test_export_cli_loads_into_jax_with_the_same_forward(trained, tmp_path):
    from dss_ml_at_scale_tpu.models.resnet import BottleneckBlock as JaxBottleneck
    from dss_ml_at_scale_tpu.models.resnet import ResNet as JaxResNet
    from dss_ml_at_scale_tpu_torch.models import ResNet
    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock

    ckpt, _, _ = trained
    rc, out = _quiet(["export", "--checkpoint-dir", str(ckpt), "--out",
                      str(tmp_path / "w.npz"), "--device", "cpu"])
    assert rc == 0, out
    step = json.loads(out.strip().splitlines()[-1])["checkpoint_step"]
    jm = JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck, num_filters=8, num_classes=4,
                   dtype=jnp.float32)
    variables = jax_pretrained.load_pretrained_resnet(tmp_path / "w.npz", jm, image_size=32)
    tm = ResNet(stage_sizes=[1, 1], block_cls=BottleneckBlock, num_filters=8, num_classes=4,
                dtype=torch.float32, fused_bn=True).eval()
    tm.load_state_dict(torch.load(ckpt / str(step) / "state.pt", weights_only=True)["model"])
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, rtol=1e-4,
                                   atol=5e-4)
    with pytest.raises(SystemExit, match=".npz"):
        cli.main(["export", "--checkpoint-dir", str(ckpt), "--out", str(tmp_path / "w.pt")])


@pytest.mark.parametrize("argv", [
    ["predict", "--data", "x", "--checkpoint-dir", "ck", "--out", "y"],
    ["export", "--checkpoint-dir", "ck", "--out", "w.npz"],
    ["serve", "--checkpoint-dir", "ck", "--port", "0"],
], ids=["predict", "export", "serve"])
def test_inference_commands_default_to_the_card(argv, monkeypatch):
    # No --device: the command asks for the card, and without one says so.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _quiet(argv)
    assert rc == 1
    assert "no CUDA device" in json.loads(out.strip().splitlines()[-1])["error"]


def test_serve_cli_boots_scores_and_drains_on_sigint(trained):
    ckpt, _, jpegs = trained
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "serve",
         "--checkpoint-dir", str(ckpt), "--port", "0", "--device", "cpu",
         "--micro-batch", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        boot = json.loads(proc.stdout.readline())
        assert boot["model"] == "tiny-bottleneck" and boot["micro_batch"] == 4
        assert boot["deadline_ms"] == 2000.0 and boot["queue_depth"] == 64
        status, payload, _ = _predict_raw(boot["port"], jpegs[3])
        assert status == 200 and payload["predictions"][0]["pred_label"] in VOCAB
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert json.loads(out.strip().splitlines()[-1])["draining"] is True
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
