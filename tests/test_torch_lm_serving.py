"""The port's LM token serving (serving/lm/, `serve-lm`), on the CPU.

Ports the stub-engine and HTTP tests of ``tests/test_lm_serving.py`` to
``dss_ml_at_scale_tpu_torch``, and adds the status codes and control
plane of the HTTP front end. The contract, layer by layer:

- slot arena: alloc/free/reuse churn, double-free refusal;
- engine semantics over the stub decoder: deterministic streams under
  churn, capacity AND sampling-param refusals BEFORE a slot is touched
  (a bad top_k/NaN temperature must 400 at the door, never reach the
  shared engine thread), a poisoned generation settles with an error
  event instead of killing the loop, settlement is exactly-once even
  when drain races retirement, deadline retirement (both the in-slot
  and the never-slotted flavors), drain = finish in-flight then
  refuse;
- numerics: a churned engine over the real TransformerDecoder (on the
  CPU) streams exactly the same tokens as solo decoding and as the
  port's ``generate`` — and as the JAX package's ``generate`` on the
  same weights;
- HTTP: the streamed done-line's trace id matches the access-log row,
  oversized or malformed requests are 400, a full queue 429 with
  Retry-After, a draining server 503; the CLI boots and drains.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dss_ml_at_scale_tpu_torch.serving.admission import (
    DeadlineExceeded,
    NotAccepting,
    QueueFull,
)
from dss_ml_at_scale_tpu_torch.serving.lm import (
    LMConfig,
    LMEngine,
    PromptTooLong,
    SlotAllocator,
    StubLMDecoder,
)


def _collect(gen, timeout=30.0):
    """Drain one generation's event stream: (tokens, terminal_event)."""
    tokens = []
    while True:
        event = gen.next_event(timeout=timeout)
        if event[0] == "token":
            tokens.append(event[1])
        else:
            return tokens, event


def _stub_expected(decoder, prompt, n_tokens):
    """The stub's closed-form greedy stream for ``prompt``."""
    out = []
    tok, pos = prompt[-1], len(prompt) - 1
    for _ in range(n_tokens):
        tok = decoder._next(tok, pos)
        out.append(tok)
        pos += 1
    return out


# -- slot arena ------------------------------------------------------------


def test_slot_allocator_churn():
    alloc = SlotAllocator(3)
    assert [alloc.alloc() for _ in range(3)] == [0, 1, 2]
    assert alloc.alloc() is None
    alloc.free(1)
    assert alloc.n_free == 1 and alloc.n_used == 2
    # Freed slot is reused, lowest-first.
    assert alloc.alloc() == 1
    alloc.free(0)
    alloc.free(2)
    with pytest.raises(ValueError):
        alloc.free(2)  # double free
    with pytest.raises(ValueError):
        alloc.free(7)  # never allocated


# -- engine over the stub decoder ------------------------------------------


@pytest.fixture
def stub_engine():
    cfg = LMConfig(slots=3, max_len=48, prefill_buckets=(8, 16),
                   queue_depth=16)
    engine = LMEngine(
        StubLMDecoder(vocab_size=97, step_ms=1.0, slots=3, max_len=48,
                      buckets=(8, 16)),
        cfg,
    ).start()
    yield engine
    engine.drain(5.0)


def test_streams_deterministic_under_slot_churn(stub_engine):
    """8 generations over 3 slots: every stream matches the stub's
    closed form even though slots free and refill mid-flight."""
    prompts = [[(3 * i + j) % 97 for j in range(2 + i % 7)]
               for i in range(8)]
    gens = [stub_engine.submit(p, 6, seed=i)
            for i, p in enumerate(prompts)]
    for prompt, gen in zip(prompts, gens):
        tokens, terminal = _collect(gen)
        assert terminal == ("done", "max_tokens")
        assert tokens == _stub_expected(stub_engine.decoder, prompt, 6)
    # Every slot returned to the arena.
    assert stub_engine._alloc.n_used == 0
    assert stub_engine.pending == 0


def test_eos_retires_early(stub_engine):
    prompt = [5, 9]
    expected = _stub_expected(stub_engine.decoder, prompt, 8)
    eos = expected[3]
    gen = stub_engine.submit(prompt, 8, eos_id=eos)
    tokens, terminal = _collect(gen)
    assert terminal == ("done", "eos")
    assert tokens == expected[:4]  # eos token itself is streamed


def test_capacity_refusals_before_any_slot(stub_engine):
    with pytest.raises(PromptTooLong, match="largest prefill bucket"):
        stub_engine.submit(list(range(17)), 4)
    with pytest.raises(PromptTooLong, match="preallocated KV slot"):
        stub_engine.submit([1, 2, 3], 46)
    with pytest.raises(ValueError, match="at least one token"):
        stub_engine.submit([], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        stub_engine.submit([1], 0)
    with pytest.raises(ValueError, match="lie in"):
        stub_engine.submit([97], 4)
    # Nothing was admitted by any refusal.
    assert stub_engine.pending == 0


def test_bad_sampling_params_rejected_at_the_door(stub_engine):
    """top_k > vocab / NaN temperature / negative seed used to reach
    Generation.sample (or default_rng) INSIDE the engine thread and
    kill the shared decode loop; they must 400 before admission."""
    with pytest.raises(ValueError, match="top_k"):
        stub_engine.submit([1], 4, top_k=999)  # vocab is 97
    with pytest.raises(ValueError, match="top_k"):
        stub_engine.submit([1], 4, top_k=0)
    with pytest.raises(ValueError, match="temperature"):
        stub_engine.submit([1], 4, temperature=float("nan"))
    with pytest.raises(ValueError, match="temperature"):
        stub_engine.submit([1], 4, temperature=float("inf"))
    with pytest.raises(ValueError, match="seed"):
        stub_engine.submit([1], 4, seed=-1)
    # No refusal leaked an admission ticket.
    assert stub_engine.pending == 0
    # The decode loop never saw any of it: a valid request streams.
    tokens, terminal = _collect(stub_engine.submit([1], 3))
    assert terminal == ("done", "max_tokens") and len(tokens) == 3


def test_engine_survives_poisoned_generation():
    """Defense in depth behind the door validation: a generation whose
    per-token work raises inside the engine thread settles with an
    error event and frees its slot — the loop keeps serving others."""
    cfg = LMConfig(slots=2, max_len=48, prefill_buckets=(8,))
    engine = LMEngine(
        StubLMDecoder(vocab_size=97, step_ms=1.0, slots=2, max_len=48,
                      buckets=(8,)),
        cfg,
    )
    bad = engine.submit([1, 2], 4)
    good_prompt = [3, 4]
    good = engine.submit(good_prompt, 4)

    def _boom(_row):
        raise RuntimeError("poisoned sampling state")

    bad.sample = _boom  # corrupt AFTER validation, pre-start
    engine.start()
    try:
        tokens, terminal = _collect(bad)
        assert tokens == []
        assert terminal[0] == "error"
        assert "poisoned" in str(terminal[1])
        gtokens, gterminal = _collect(good)
        assert gterminal == ("done", "max_tokens")
        assert gtokens == _stub_expected(engine.decoder, good_prompt, 4)
        # The poisoned slot was freed and its ticket released.
        assert engine._alloc.n_used == 0
        assert engine.pending == 0
    finally:
        engine.drain(5.0)


def test_settlement_is_idempotent():
    """The drain-timeout race: the sweep settles a generation a wedged
    engine thread later retires. The second settlement must be a no-op
    — one terminal event, one admission release, pending never goes
    negative."""
    cfg = LMConfig(slots=1, max_len=48, prefill_buckets=(8,))
    engine = LMEngine(
        StubLMDecoder(slots=1, max_len=48, buckets=(8,)), cfg
    )  # never started: both settlements are ours
    gen = engine.submit([1], 1)
    assert engine.pending == 1
    engine._settle(gen, "drain")
    engine._settle(gen, "done")  # the racing late retirement
    assert gen.next_event(timeout=1.0) == ("done", "drain")
    with pytest.raises(queue.Empty):
        gen.next_event(timeout=0.1)
    assert engine.pending == 0


def test_decoder_with_more_slots_than_config():
    """A decoder arena larger than cfg.slots is legal: step arrays are
    sized to the decoder, allocation to the config — this used to
    IndexError on the first step and kill the engine thread."""
    cfg = LMConfig(slots=2, max_len=48, prefill_buckets=(8,))
    engine = LMEngine(
        StubLMDecoder(vocab_size=97, step_ms=1.0, slots=4, max_len=48,
                      buckets=(8,)),
        cfg,
    ).start()
    try:
        prompts = [[i + 1, i + 2] for i in range(4)]
        gens = [engine.submit(p, 5, seed=i)
                for i, p in enumerate(prompts)]
        for prompt, gen in zip(prompts, gens):
            tokens, terminal = _collect(gen)
            assert terminal == ("done", "max_tokens")
            assert tokens == _stub_expected(engine.decoder, prompt, 5)
        assert engine._alloc.n_used == 0
    finally:
        engine.drain(5.0)


def test_deadline_retires_slot_and_frees_it():
    cfg = LMConfig(slots=1, max_len=64, prefill_buckets=(8,),
                   deadline_ms=150.0)
    engine = LMEngine(
        StubLMDecoder(step_ms=30.0, slots=1, max_len=64, buckets=(8,)),
        cfg,
    ).start()
    try:
        gen = engine.submit([1, 2], 60)
        tokens, terminal = _collect(gen)
        assert terminal == ("done", "deadline")
        assert 0 < len(tokens) < 60
        # The slot is free again: a request that fits the budget runs.
        gen2 = engine.submit([1, 2], 2)
        tokens2, terminal2 = _collect(gen2)
        assert terminal2 == ("done", "max_tokens")
        assert len(tokens2) == 2
        assert engine._alloc.n_used == 0
    finally:
        engine.drain(5.0)


def test_deadline_expires_while_waiting_for_a_slot():
    """A request whose deadline passes before a slot ever frees gets
    the queue-jump error event, not a truncated stream."""
    cfg = LMConfig(slots=1, max_len=64, prefill_buckets=(8,),
                   deadline_ms=120.0)
    engine = LMEngine(
        StubLMDecoder(step_ms=25.0, slots=1, max_len=64, buckets=(8,)),
        cfg,
    ).start()
    try:
        hog = engine.submit([1], 60)  # occupies the only slot past 120ms
        starved = engine.submit([2], 4)
        tokens, terminal = _collect(starved)
        assert tokens == []
        assert terminal[0] == "error"
        assert isinstance(terminal[1], DeadlineExceeded)
        _collect(hog)  # hog itself retires on ITS deadline
    finally:
        engine.drain(5.0)


def test_drain_finishes_inflight_then_refuses(stub_engine):
    gen = stub_engine.submit([1, 2, 3], 12)
    got = {}

    def _reader():
        got["tokens"], got["terminal"] = _collect(gen)

    reader = threading.Thread(target=_reader)
    reader.start()
    assert stub_engine.drain(10.0) is True
    reader.join(10.0)
    # The in-flight stream COMPLETED during drain — not truncated.
    assert got["terminal"] == ("done", "max_tokens")
    assert len(got["tokens"]) == 12
    with pytest.raises(NotAccepting):
        stub_engine.submit([1], 1)


# -- numerics: churned engine == solo == generate() ------------------------


def test_parity_churn_vs_solo_vs_generate():
    """Continuous batching is a scheduling change, not a numerics change:
    tokens from a churned multi-slot engine == solo decoding == the
    port's ``generate`` == the JAX package's ``generate`` on the same
    weights (f32 on the CPU)."""
    import jax
    import jax.numpy as jnp
    import torch

    from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
    from dss_ml_at_scale_tpu.models.transformer import generate as jax_generate
    from dss_ml_at_scale_tpu_torch.models import TransformerLM, lm_state_from_flax
    from dss_ml_at_scale_tpu_torch.models.transformer import generate
    from dss_ml_at_scale_tpu_torch.serving.lm import TransformerDecoder

    kw = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=64)
    jm = JaxLM(dtype=jnp.float32, attention="reference", **kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = TransformerLM(dtype=torch.float32, attention="flash", device="cpu", **kw)
    model.load_state_dict(lm_state_from_flax(variables))
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(1, 64, int(n))) for n in (3, 7, 11, 5, 14)]
    n_new = 6

    expected = []
    for prompt in prompts:
        out = generate(model, torch.tensor([prompt]), n_new)
        expected.append([int(t) for t in out[0, len(prompt):]])
        jax_out = jax_generate(jm, variables, jnp.asarray([prompt], jnp.int32), n_new)
        assert expected[-1] == [int(t) for t in np.asarray(jax_out)[0, len(prompt):]]

    # Solo: one generation at a time through a 1-slot engine.
    solo = LMEngine(
        TransformerDecoder(model, slots=1, max_len=48, buckets=(8, 16)),
        LMConfig(slots=1, max_len=48, prefill_buckets=(8, 16)),
    ).start()
    try:
        for prompt, want in zip(prompts, expected):
            tokens, terminal = _collect(solo.submit(prompt, n_new))
            assert terminal == ("done", "max_tokens")
            assert tokens == want
    finally:
        solo.drain(10.0)

    # Churned: 5 staggered generations over 3 slots — admissions land
    # BETWEEN other streams' decode steps, slots free and refill.
    churn = LMEngine(
        TransformerDecoder(model, slots=3, max_len=48, buckets=(8, 16)),
        LMConfig(slots=3, max_len=48, prefill_buckets=(8, 16)),
    ).start()
    try:
        gens = []
        for prompt in prompts:
            gens.append(churn.submit(prompt, n_new))
            time.sleep(0.02)
        for want, gen in zip(expected, gens):
            tokens, terminal = _collect(gen, timeout=60.0)
            assert terminal == ("done", "max_tokens")
            assert tokens == want
    finally:
        churn.drain(10.0)


# -- HTTP streaming --------------------------------------------------------


@pytest.fixture
def lm_server(tmp_path):
    from dss_ml_at_scale_tpu_torch.workloads.serving import serve_lm_in_thread

    cfg = LMConfig(slots=2, max_len=48, prefill_buckets=(8,),
                   queue_depth=8)
    engine = LMEngine(
        StubLMDecoder(step_ms=1.0, slots=2, max_len=48, buckets=(8,)),
        cfg,
    ).start()
    log = tmp_path / "access.jsonl"
    handle = serve_lm_in_thread(engine, access_log=log)
    yield handle, log
    handle.close()


def _stream(port, payload, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/generate", json.dumps(payload).encode(),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    if resp.status != 200:
        body = json.loads(resp.read())
        conn.close()
        return resp.status, resp.getheader("X-DSST-Trace"), [], body
    lines = []
    for raw in iter(resp.readline, b""):
        lines.append(json.loads(raw))
        if "done" in lines[-1]:
            break
    resp.read()
    trace = resp.getheader("X-DSST-Trace")
    conn.close()
    return resp.status, trace, lines[:-1], lines[-1]


def _poll_access_row(log, request_id, timeout_s=5.0):
    """The access-log row of ``request_id``, polled until a deadline."""
    deadline = time.monotonic() + timeout_s
    while True:
        text = log.read_text() if log.exists() else ""
        # Whole lines only: the writer may be mid-line.
        rows = [json.loads(l) for l in text.split("\n")[:-1] if l.strip()]
        row = next((r for r in rows if r["request_id"] == request_id), None)
        if row is not None or time.monotonic() > deadline:
            assert row is not None, f"no access-log row for {request_id} within {timeout_s}s"
            return row
        time.sleep(0.02)


def test_streamed_trace_matches_access_log(lm_server):
    """The cross-process observability hop: an injected trace id comes
    back on the response header AND the done-line AND the access-log
    row — one trace across client, stream, and log."""
    handle, log = lm_server
    injected = "feedc0de12345678"
    header = f"dsst1-{injected}-abcd1234-request"
    status, trace, tokens, done = _stream(
        handle.port, {"tokens": [1, 2, 3], "max_new_tokens": 4},
        headers={"X-DSST-Trace": header},
    )
    assert status == 200
    assert trace == injected
    assert done["done"] == "max_tokens"
    assert done["trace"] == injected
    assert len(tokens) == 4
    # The server writes the row after the terminal chunk has gone out (its
    # latency covers the send), so the client may read the log first.
    row = _poll_access_row(log, injected)
    assert row["trace_inherited"] is True
    assert row["status"] == 200
    assert row["tokens"] == 4
    assert row["reason"] == "max_tokens"
    assert row["ttft_ms"] >= 0


def test_oversized_request_is_400_not_a_scatter(lm_server):
    handle, _ = lm_server
    status, _, _, body = _stream(
        handle.port, {"tokens": list(range(1, 10)), "max_new_tokens": 4})
    assert status == 400
    assert "bucket" in body["error"]
    status, _, _, body = _stream(
        handle.port, {"tokens": [1, 2], "max_new_tokens": 47})
    assert status == 400
    assert "max_len" in body["error"]
    # The server is still healthy after both refusals.
    status, _, tokens, done = _stream(
        handle.port, {"tokens": [1, 2], "max_new_tokens": 3})
    assert status == 200 and len(tokens) == 3


def test_bad_sampling_params_400_over_http(lm_server):
    """POST /generate with top_k > vocab (or NaN
    temperature, which json.loads happily parses) used to crash the
    decode thread and hang every later request. Now: 400 at the door,
    engine stays alive."""
    handle, _ = lm_server
    status, _, _, body = _stream(
        handle.port,
        {"tokens": [1, 2], "max_new_tokens": 4, "top_k": 999})
    assert status == 400
    assert "top_k" in body["error"]
    status, _, _, body = _stream(
        handle.port,
        {"tokens": [1, 2], "max_new_tokens": 4,
         "temperature": float("nan")})
    assert status == 400
    assert "temperature" in body["error"]
    # The decode loop survived both: a valid request still streams.
    status, _, tokens, done = _stream(
        handle.port, {"tokens": [1, 2], "max_new_tokens": 3})
    assert status == 200 and len(tokens) == 3
    assert done["done"] == "max_tokens"


def test_full_queue_is_429_with_retry_after(tmp_path):
    from dss_ml_at_scale_tpu_torch.workloads.serving import serve_lm_in_thread

    cfg = LMConfig(slots=1, max_len=64, prefill_buckets=(8,), queue_depth=1)
    engine = LMEngine(
        StubLMDecoder(step_ms=20.0, slots=1, max_len=64, buckets=(8,)), cfg
    ).start()
    handle = serve_lm_in_thread(engine)
    try:
        hog = engine.submit([1, 2], 40)  # holds the only admission ticket
        conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=30)
        conn.request("POST", "/generate",
                     json.dumps({"tokens": [1], "max_new_tokens": 2}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 429
        assert int(resp.getheader("Retry-After")) >= 1
        assert "queue full" in body["error"]
        with pytest.raises(QueueFull):
            engine.submit([1], 1)
        _collect(hog)
    finally:
        handle.close()


def test_draining_server_is_503(lm_server):
    handle, _ = lm_server
    handle.lifecycle.start_drain()
    status, _, _, body = _stream(
        handle.port, {"tokens": [1, 2], "max_new_tokens": 3})
    assert status == 503
    assert "draining" in body["error"]


@pytest.mark.parametrize("payload", [
    b"not json", b'{"max_new_tokens": 3}', b'{"tokens": 7}',
    b'{"tokens": [1], "max_new_tokens": 0}',
])
def test_malformed_generate_is_400(lm_server, payload):
    handle, _ = lm_server
    conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=30)
    conn.request("POST", "/generate", payload,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    json.loads(resp.read())
    conn.close()
    assert resp.status == 400


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def test_control_plane_routes(lm_server):
    handle, _ = lm_server
    _stream(handle.port, {"tokens": [1, 2], "max_new_tokens": 2})
    status, body = _get(handle.port, "/healthz")
    health = json.loads(body)
    assert status == 200 and health["workload"] == "lm"
    assert health["decoder"] == "StubLMDecoder" and health["slots"] == 2
    status, body = _get(handle.port, "/readyz")
    assert status == 200 and json.loads(body)["ready"] is True
    status, body = _get(handle.port, "/metrics")
    assert status == 200
    text = body.decode()
    assert "# TYPE lm_tokens_total counter" in text
    assert "# TYPE lm_ttft_window_seconds summary" in text
    status, body = _get(handle.port, "/slo")
    names = {o["name"] for o in json.loads(body)["objectives"]}
    assert status == 200 and names == {"serving_latency_p99", "serving_error_rate",
                                       "ttft_p99", "inter_token_p99"}
    status, body = _get(handle.port, "/telemetry")
    doc = json.loads(body)
    assert status == 200 and "ttft_p99" in doc["slo_sources"]["sources"]
    assert any(m["name"] == "lm_tokens_total" for m in doc["metrics"])
    assert _get(handle.port, "/nope")[0] == 404


def test_cli_serve_lm_stub_boots_streams_and_drains():
    """`python -m dss_ml_at_scale_tpu_torch.config.cli serve-lm --stub`:
    boot line, one streamed generation, SIGINT drains and exits 0."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[1]), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli",
         "serve-lm", "--stub", "--port", "0", "--slots", "2",
         "--max-len", "32", "--prefill-buckets", "8", "--step-ms", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        boot = json.loads(proc.stdout.readline())
        assert boot["decoder"] == "StubLMDecoder"
        status, _, tokens, done = _stream(
            boot["port"], {"tokens": [1, 2], "max_new_tokens": 5})
        assert status == 200 and len(tokens) == 5
        assert done["done"] == "max_tokens"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
        assert json.loads(proc.stdout.readline())["draining"] is True
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_cli_refuses_cuda_without_a_card(monkeypatch, capsys):
    import torch

    from dss_ml_at_scale_tpu_torch.config.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["serve-lm", "--device", "cuda", "--max-len", "32",
                 "--prefill-buckets", "8"]) == 1
    assert "no CUDA device" in capsys.readouterr().out
