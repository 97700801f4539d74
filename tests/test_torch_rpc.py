"""The port's RPC control plane, worker pool and trials over RPC
(``runtime/rpc.py``, ``resilience/workers.py``, ``parallel/trials.py``'s
``HostTrials`` and ``serve_trial_worker``).

Twins of ``tests/test_rpc.py`` and of the RPC and worker-pool tests of
``tests/test_resilience.py``: the wire (8-byte length prefix, pickle, the
mutual HMAC handshake before any unpickling), the refusal of a bind other
than loopback without a secret, a secret mismatch that fails fast naming
auth, object references, the HostTrials failure semantics (isolation, a
requeue onto a live worker, retries used up, all workers dead, a wrong
secret, re-admission by heartbeat, a ref refused before any trial), the
``rpc.send.<method>`` fault site, and a ``trial-worker`` process of the
port's CLI. The wire is the JAX package's: a JAX client calls a port
server and the other way round.
"""

import pickle
import threading
import time

import numpy as np
import pytest

from dss_ml_at_scale_tpu.runtime import rpc as jax_rpc
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.hpo import STATUS_FAIL, STATUS_OK, Trials, fmin, hp
from dss_ml_at_scale_tpu_torch.parallel import HostTrials, objective_ref, serve_trial_worker
from dss_ml_at_scale_tpu_torch.parallel.trials import resolve_objective
from dss_ml_at_scale_tpu_torch.resilience import faults
from dss_ml_at_scale_tpu_torch.resilience.faults import FaultPlan, InjectedFault
from dss_ml_at_scale_tpu_torch.resilience.retry import RetryPolicy, is_transient
from dss_ml_at_scale_tpu_torch.resilience.workers import WorkerPool
from dss_ml_at_scale_tpu_torch.runtime.rpc import (
    RpcAuthError,
    RpcConnectTimeout,
    RpcHandshakeTimeout,
    RpcRemoteError,
    RpcServer,
    rpc_call,
)
from torch_workers import start_worker, stop

OBJ = "dss_ml_at_scale_tpu_torch.hpo.objectives"


def _counter(name, **labels):
    for m in telemetry.snapshot()["metrics"]:
        if m["name"] == name and (m.get("labels") or {}) == labels:
            return m["value"]
    return 0.0


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    faults.clear()


# -- the transport -------------------------------------------------------------

def test_rpc_roundtrip_and_remote_error():
    server = RpcServer({"echo": lambda p: p, "boom": lambda p: 1 / 0}).serve_background()
    try:
        addr = f"{server.address[0]}:{server.address[1]}"
        assert rpc_call(addr, "echo", {"x": [1, 2, 3]}) == {"x": [1, 2, 3]}
        assert rpc_call(server.address, "echo", "tuple-addr ok") == "tuple-addr ok"
        with pytest.raises(RpcRemoteError, match="ZeroDivisionError"):
            rpc_call(addr, "boom")
        with pytest.raises(RpcRemoteError, match="KeyError"):
            rpc_call(addr, "no-such-method")
    finally:
        server.shutdown()


def test_rpc_large_payload():
    server = RpcServer({"size": lambda p: len(p)}).serve_background()
    try:
        blob = b"x" * (5 << 20)  # 5 MiB crosses several receive chunks
        assert rpc_call(server.address, "size", blob) == len(blob)
    finally:
        server.shutdown()


def test_rpc_hmac_handshake():
    server = RpcServer({"echo": lambda p: p}, secret=b"team-secret",
                       recv_timeout=2.0).serve_background()
    try:
        assert rpc_call(server.address, "echo", 42, secret=b"team-secret") == 42
        with pytest.raises((RpcAuthError, ConnectionError)):
            rpc_call(server.address, "echo", 42, secret=b"wrong", timeout=2.0)
        # No secret: the server speaks challenge frames, not pickle, and the
        # request is never dispatched.
        with pytest.raises((ConnectionError, EOFError, OSError, pickle.UnpicklingError)):
            rpc_call(server.address, "echo", 42, timeout=2.0)
        assert rpc_call(server.address, "echo", "ok", secret="team-secret") == "ok"
    finally:
        server.shutdown()


def test_the_wire_is_the_jax_packages():
    """Length prefix, pickle and handshake are JAX's, byte for byte: each
    package's client calls the other's server, with and without a secret."""
    for secret in (None, b"s3"):
        port = RpcServer({"echo": lambda p: ("port", p)}, secret=secret).serve_background()
        jax = jax_rpc.RpcServer({"echo": lambda p: ("jax", p)}, secret=secret).serve_background()
        try:
            assert jax_rpc.rpc_call(port.address, "echo", 1, secret=secret) == ("port", 1)
            assert rpc_call(jax.address, "echo", 2, secret=secret) == ("jax", 2)
        finally:
            port.shutdown()
            jax.shutdown()


def test_rpc_refuses_nonloopback_bind_without_secret():
    with pytest.raises(ValueError, match="shared secret"):
        RpcServer({"echo": lambda p: p}, host="0.0.0.0")
    with pytest.raises(ValueError, match="shared secret"):  # "" is INADDR_ANY
        RpcServer({"echo": lambda p: p}, host="")
    with pytest.raises(ValueError, match="non-empty"):
        RpcServer({"echo": lambda p: p}, host="0.0.0.0", secret=b"")
    RpcServer({"echo": lambda p: p}, host="0.0.0.0", secret=b"s").shutdown()
    RpcServer({"echo": lambda p: p}, host="0.0.0.0", allow_insecure=True).shutdown()


def test_rpc_secret_mismatch_fails_fast_with_auth_error():
    server = RpcServer({"echo": lambda p: p}, recv_timeout=30.0).serve_background()
    try:
        t0 = time.monotonic()
        with pytest.raises(RpcHandshakeTimeout, match="handshake"):
            rpc_call(server.address, "echo", 1, secret=b"s", timeout=1.0)
        assert time.monotonic() - t0 < 15.0
    finally:
        server.shutdown()


def test_transient_classifier():
    assert is_transient(ConnectionRefusedError("x"))
    assert is_transient(TimeoutError("x"))
    assert is_transient(InjectedFault("x"))
    assert is_transient(RpcHandshakeTimeout("stalled"))
    assert is_transient(RpcConnectTimeout("connect timed out"))
    assert not isinstance(RpcConnectTimeout("x"), TimeoutError)
    assert not is_transient(RpcRemoteError("traceback"))
    assert not is_transient(RpcAuthError("bad secret"))
    assert not is_transient(ValueError("semantic"))


def test_rpc_send_fault_site_and_retry():
    server = RpcServer({"echo": lambda p: p}).serve_background()
    plan = faults.install(FaultPlan.parse("rpc.send.echo=2"))
    before = _counter("retry_total", site="rpc.send.echo")
    try:
        with pytest.raises(InjectedFault):
            rpc_call(server.address, "echo", 1)
        assert rpc_call(server.address, "echo", 42,
                        retry=RetryPolicy(max_retries=2, base_delay=0.01)) == 42
        with pytest.raises(RpcRemoteError):  # never retried
            rpc_call(server.address, "missing", None,
                     retry=RetryPolicy(max_retries=2, base_delay=0.01))
    finally:
        server.shutdown()
    assert plan.stats()["rpc.send.echo"]["fired"] == 2
    assert _counter("retry_total", site="rpc.send.echo") - before == 1


# -- object references ---------------------------------------------------------

def test_objective_ref_roundtrip():
    from dss_ml_at_scale_tpu_torch.hpo import objectives

    ref = objective_ref(objectives.quadratic)
    assert ref == f"{OBJ}:quadratic"
    assert resolve_objective(ref) is objectives.quadratic
    assert objective_ref(ref) == ref
    with pytest.raises(ValueError, match="not importable"):
        objective_ref(lambda a: 0.0)


def test_fmin_rejects_string_objective_on_local_executors():
    with pytest.raises(TypeError, match="string ref"):
        fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -1, 1)}, max_evals=2, trials=Trials())


# -- the worker pool -----------------------------------------------------------

def test_worker_pool_drop_wakes_waiters_promptly():
    pool = WorkerPool(["a", "b"], probe=None, dead_grace=0.2)
    a, b = pool.get(1.0), pool.get(1.0)
    out = []

    def waiter():
        t0 = time.monotonic()
        out.append((pool.get(10.0), time.monotonic() - t0))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.15)
    pool.drop(a)
    pool.drop(b)  # the last live worker goes mid-wait
    t.join(5.0)
    pool.close()
    got, waited = out[0]
    assert got is None and waited < 2.0


def test_worker_pool_readmits_on_heartbeat_and_wakes_waiters():
    before = _counter("worker_readmitted_total")
    pool = WorkerPool(["w"], probe=lambda w: None, heartbeat_interval=0.05, dead_grace=5.0)
    pool.drop(pool.get(1.0))
    t0 = time.monotonic()
    got = pool.get(10.0)
    waited = time.monotonic() - t0
    pool.close()
    assert got == "w" and waited < 2.0
    assert _counter("worker_readmitted_total") - before == 1


def test_worker_pool_put_wakes_waiter_and_cooldown_delays_probe():
    pool = WorkerPool(["w"], probe=None)
    w = pool.get(1.0)
    out = []
    t = threading.Thread(target=lambda: out.append(pool.get(10.0)))
    t.start()
    time.sleep(0.1)
    pool.put(w)
    t.join(2.0)
    pool.close()
    assert out == ["w"]
    probes = []
    pool = WorkerPool(["w"], probe=probes.append, heartbeat_interval=0.02, dead_grace=5.0)
    pool.drop(pool.get(1.0), cooldown=0.5)
    time.sleep(0.25)
    assert probes == [] and pool.probing_count == 1
    assert pool.get(5.0) == "w" and probes == ["w"]
    pool.close()


# -- HostTrials over in-process workers -----------------------------------------

@pytest.fixture()
def two_workers():
    servers = [serve_trial_worker(block=False) for _ in range(2)]
    yield [f"{s.address[0]}:{s.address[1]}" for s in servers]
    for s in servers:
        s.shutdown()


def test_host_trials_sweep(two_workers):
    trials = HostTrials(two_workers)
    best = fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=25,
                trials=trials, rstate=np.random.default_rng(0))
    assert len(trials.trials) == 25
    assert abs(best["x"] - 3.0) < 2.0
    assert all(t["result"]["status"] == STATUS_OK for t in trials.trials)


def test_host_trials_at_parallelism_1_equal_local_trials(two_workers):
    """One trial in flight: the remote sweep is the local one, trial for trial."""
    space = {"x": hp.uniform("x", -10, 10)}
    remote = HostTrials(two_workers[:1], parallelism=1)
    fmin(f"{OBJ}:quadratic", space, max_evals=12, trials=remote, rstate=np.random.default_rng(7))
    from dss_ml_at_scale_tpu_torch.hpo import objectives

    local = Trials()
    fmin(objectives.quadratic, space, max_evals=12, trials=local, rstate=np.random.default_rng(7))
    assert [t["point"] for t in remote.trials] == [t["point"] for t in local.trials]
    assert [t["result"]["loss"] for t in remote.trials] == [t["result"]["loss"]
                                                             for t in local.trials]


def test_host_trials_failure_isolation(two_workers):
    trials = HostTrials(two_workers)
    best = fmin(f"{OBJ}:brittle_quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=20,
                trials=trials, rstate=np.random.default_rng(1))
    assert {t["result"]["status"] for t in trials.trials} == {STATUS_OK, STATUS_FAIL}
    assert best["x"] >= 0
    failed = [t for t in trials.trials if t["result"]["status"] == STATUS_FAIL]
    assert all("blew up" in t["result"]["error"] for t in failed)


def test_host_trials_unreachable_worker_retries_onto_live_one(two_workers):
    trials = HostTrials([two_workers[0], "127.0.0.1:1"], rpc_timeout=2.0)
    fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=10, trials=trials,
         rstate=np.random.default_rng(2), return_argmin=False)
    assert len(trials.trials) == 10
    assert all(t["result"]["status"] == STATUS_OK for t in trials.trials)


def test_host_trials_transport_retries_exhausted_fail_the_trial(two_workers):
    trials = HostTrials([two_workers[0], "127.0.0.1:1"], rpc_timeout=2.0, max_retries=0)
    fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=10, trials=trials,
         rstate=np.random.default_rng(2), return_argmin=False)
    ok = [t for t in trials.trials if t["result"]["status"] == STATUS_OK]
    failed = [t for t in trials.trials if t["result"]["status"] == STATUS_FAIL]
    assert len(ok) + len(failed) == 10 and ok and failed
    assert all("worker" in t["result"]["error"] for t in failed)


def test_host_trials_all_workers_dead_fails_fast():
    trials = HostTrials(["127.0.0.1:1", "127.0.0.1:2"], parallelism=2, rpc_timeout=30.0)
    t0 = time.monotonic()
    fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=12, trials=trials,
         rstate=np.random.default_rng(4), return_argmin=False)
    assert len(trials.trials) == 12
    assert all(t["result"]["status"] == STATUS_FAIL for t in trials.trials)
    assert time.monotonic() - t0 < 25.0


def test_host_trials_authenticated_worker():
    server = serve_trial_worker(block=False, secret=b"hmac-secret")
    try:
        trials = HostTrials([f"{server.address[0]}:{server.address[1]}"], secret=b"hmac-secret")
        best = fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=6,
                    trials=trials, rstate=np.random.default_rng(5))
        assert all(t["result"]["status"] == STATUS_OK for t in trials.trials)
        assert "x" in best
    finally:
        server.shutdown()


def test_host_trials_wrong_secret_fails_fast_naming_auth():
    server = serve_trial_worker(block=False, secret=b"right-secret")
    trials = HostTrials([f"{server.address[0]}:{server.address[1]}"], secret=b"wrong-secret",
                        rpc_timeout=10.0)
    t0 = time.monotonic()
    try:
        fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=4, trials=trials,
             rstate=np.random.default_rng(3), return_argmin=False)
    finally:
        server.shutdown()
    assert time.monotonic() - t0 < 20.0
    assert all(t["result"]["status"] == "fail" and "auth failure" in t["result"]["error"]
               for t in trials.trials)


def test_host_trials_validates_ref_before_any_trial(two_workers):
    with pytest.raises(ValueError, match="does not resolve"):
        fmin(f"{OBJ}:no_such_function", {"x": hp.uniform("x", -1, 1)}, max_evals=2,
             trials=HostTrials(two_workers))


def test_objective_faults_stay_permanent_fails():
    server = serve_trial_worker(block=False)
    plan = faults.install(FaultPlan.parse("trial.evaluate=2"))
    retries_before = _counter("retry_total", site="trial.evaluate")
    trials = HostTrials([f"{server.address[0]}:{server.address[1]}"])
    try:
        fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -10, 10)}, max_evals=6, trials=trials,
             rstate=np.random.default_rng(1), return_argmin=False)
    finally:
        server.shutdown()
    assert plan.stats()["trial.evaluate"]["fired"] == 2
    assert sum(t["result"]["status"] == STATUS_FAIL for t in trials.trials) == 2
    assert _counter("retry_total", site="trial.evaluate") == retries_before


def test_chaos_sweep_completes_with_faults_and_worker_death():
    """Two injected transport faults and a worker dead at the start that
    comes back on its address: every eval ends ok, the faulted trials were
    retried onto live workers, the dead worker was re-admitted."""
    servers = [serve_trial_worker(block=False) for _ in range(2)]
    addrs = [f"{s.address[0]}:{s.address[1]}" for s in servers]
    dead_port = servers[1].address[1]
    servers[1].shutdown()

    def resurrect():
        time.sleep(0.6)
        servers[1] = serve_trial_worker(bind=f"127.0.0.1:{dead_port}", block=False)

    threading.Thread(target=resurrect, daemon=True).start()
    plan = faults.install(FaultPlan.parse("rpc.send.evaluate=2"))
    readmitted = _counter("worker_readmitted_total")
    retries = _counter("retry_total", site="trial.evaluate")
    trials = HostTrials(addrs, parallelism=2, rpc_timeout=15.0, max_retries=3,
                        heartbeat_interval=0.1, dead_grace=2.0)
    try:
        fmin(f"{OBJ}:paced_quadratic",
             {"x": hp.uniform("x", -10, 10), "delay": hp.choice("delay", [0.15])},
             max_evals=12, trials=trials, rstate=np.random.default_rng(0))
    finally:
        for s in servers:
            s.shutdown()
    assert len(trials.trials) == 12
    assert all(t["result"]["status"] == STATUS_OK for t in trials.trials)
    assert plan.stats()["rpc.send.evaluate"]["fired"] == 2
    assert _counter("retry_total", site="trial.evaluate") - retries >= 2
    assert _counter("worker_readmitted_total") - readmitted >= 1


def test_worker_serves_its_telemetry(two_workers):
    trials = HostTrials(two_workers[:1])
    fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -1, 1)}, max_evals=2, trials=trials,
         rstate=np.random.default_rng(0))
    snap = rpc_call(two_workers[0], "telemetry_snapshot")
    assert "metrics" in snap
    spans = rpc_call(two_workers[0], "telemetry_spans")
    assert any(e.get("name") == "trial" for e in spans)


# -- a worker process of the CLI -------------------------------------------------

def test_trial_worker_cli_subprocess():
    proc, addr = start_worker("--bind", "127.0.0.1:0")
    try:
        assert rpc_call(addr, "ping", timeout=10.0) == "pong"
        trials = HostTrials([addr], rpc_timeout=60.0)
        fmin(f"{OBJ}:quadratic", {"x": hp.uniform("x", -5, 8)}, max_evals=8, trials=trials,
             rstate=np.random.default_rng(3))
        assert len(trials.trials) == 8
        assert all(t["result"]["status"] == STATUS_OK for t in trials.trials)
    finally:
        stop(proc)
