"""Device-pinned parallel trials executor: the SparkTrials replacement.

Port of ``dss_ml_at_scale_tpu/parallel/trials.py`` (``DeviceTrials`` and
its async main loop). The reference's ``SparkTrials(parallelism=N)``: the
coordinating process's TPE proposes trials, up to N evaluate at once on
executors, results stream back into the shared history, and a failing
trial does not kill the sweep.

One process drives the cards of its host: trials run on a thread pool,
each pinned to one card of the pool (``torch.cuda.device(i)`` over
``torch.cuda.device_count()`` cards). ``devices=[torch.device("cpu")]``
runs them on the CPU, when the caller asks. An objective that places its
own tensors (``pin_devices=False``) runs unpinned.

Async proposal semantics match SparkTrials: a proposal sees whatever
history has completed at submit time, so with ``parallelism > 1`` the
sweep is not bit-identical run to run (in the JAX package neither).

Across processes and hosts (the multi-host SparkTrials) trials travel over
the RPC control plane (:mod:`..runtime.rpc`): :func:`serve_trial_worker`
evaluates them, :class:`HostTrials` hands them out from the coordinating
process, and the objective crosses the wire as a ``module:qualname``
reference (:func:`objective_ref`), never as code.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import torch

from .. import telemetry
from ..hpo.fmin import Trials, _call_objective, _log_trial
from ..telemetry import tracecontext

log = logging.getLogger(__name__)


def local_devices() -> list[torch.device]:
    """Every card of this host, as JAX's ``jax.local_devices()``; an error
    without one (pass ``devices=`` to run trials elsewhere)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("DeviceTrials: no CUDA device is available "
                           "(pass devices=[torch.device('cpu')] to run trials on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def _on(device: torch.device):
    """Make ``device`` the current card of the calling thread (a CPU device
    changes nothing)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class DeviceTrials(Trials):
    """Run trials concurrently, each pinned to one device."""

    def __init__(self, parallelism: int | None = None, devices=None, pin_devices: bool = True):
        super().__init__()
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
        elif pin_devices:
            self.devices = local_devices()
        else:
            self.devices = []
        self.parallelism = parallelism or max(1, len(self.devices))
        self.pin_devices = pin_devices

    def run(self, objective, space, algo, max_evals, rng, tracker=None) -> None:
        # The pool is local to each run: a resumed sweep (fmin again with the
        # same trials object) must not duplicate device entries, or two
        # trials could pin the same card while another idles.
        device_pool: queue.SimpleQueue = queue.SimpleQueue()
        for d in self.devices:
            device_pool.put(d)

        def evaluate(tid: int, point: dict) -> tuple[int, dict, dict, float]:
            t0 = time.time()
            if self.pin_devices:
                device = device_pool.get()
                try:
                    with _on(device), telemetry.span("trial", tid=tid, device=str(device)):
                        result = _call_objective(objective, space, point)
                finally:
                    device_pool.put(device)
            else:
                with telemetry.span("trial", tid=tid):
                    result = _call_objective(objective, space, point)
            return tid, point, result, t0

        _run_async_pool(self, evaluate, algo, space, max_evals, rng, tracker, self.parallelism)


def _run_async_pool(trials, evaluate, algo, space, max_evals, rng, tracker, parallelism) -> None:
    """SparkTrials-style async main loop.

    Proposes from whatever history has completed, keeps up to
    ``parallelism`` evaluations in flight, records results as they land.
    Proposals and recording happen only on the calling thread;
    ``evaluate(tid, point) -> (tid, point, result, t0)`` runs on pool
    threads and must not touch the trial store.
    """
    outcomes = telemetry.counter("hpo_trials_total", "completed HPO trials by outcome",
                                 labels=("status",))

    def _traced(handoff: tracecontext.Handoff, tid: int, point: dict):
        # Worker-pool boundary: the trial's trace was minted on the proposing
        # thread at proposal time; the pool thread adopts it, so the trial
        # span joins the same timeline as trial.submit.
        with handoff.activate():
            return evaluate(tid, point)

    submitted = len(trials.trials)
    with ThreadPoolExecutor(max_workers=parallelism) as pool:
        pending = set()
        while submitted < max_evals or pending:
            while submitted < max_evals and len(pending) < parallelism:
                handoff = tracecontext.Handoff.root(kind="trial")
                with handoff.activate(), telemetry.span("trial.submit", tid=submitted):
                    point = algo(space, trials._history(), rng)
                pending.add(pool.submit(_traced, handoff, submitted, point))
                submitted += 1
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                tid, point, result, t0 = fut.result()
                trials._record(tid, point, result, t0)
                outcomes.labels(status=str(result.get("status", "unknown"))).inc()
                if tracker is not None:
                    _log_trial(tracker, tid, point, result)
    trials.trials.sort(key=lambda t: t["tid"])


# ---------------------------------------------------------------------------
# Trials across processes and hosts, over the RPC control plane
# ---------------------------------------------------------------------------

def objective_ref(fn) -> str:
    """The importable ``module:qualname`` reference of a trial objective.

    The wire carries a reference, not code: workers import the same package
    and resolve it. Closures and lambdas therefore cannot cross processes;
    module-level functions can (data ships by :mod:`..hpo.shipping`).
    """
    if isinstance(fn, str):
        return fn
    qualname = getattr(fn, "__qualname__", "")
    if not qualname or "<locals>" in qualname or "<lambda>" in qualname:
        raise ValueError(f"objective {fn!r} is not importable by reference; move it to "
                         "module level (data can ship via hpo.shipping)")
    return f"{fn.__module__}:{qualname}"


def resolve_objective(ref: str):
    """The object a ``module:qualname`` reference names."""
    import importlib

    module, _, qualname = ref.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def serve_trial_worker(bind: str = "127.0.0.1:0", block: bool = True,
                       secret: bytes | str | None = None, allow_insecure: bool = False,
                       announce=None):
    """Run a trial-evaluation worker (one per host, as a Spark executor).

    Serves ``evaluate({"objective": ref, "args": kwargs}) -> result``,
    ``ping``, and the telemetry pulls ``telemetry_snapshot`` and
    ``telemetry_spans`` (its counters, and a ``trial`` span per evaluation).
    Objectives run under the trial-result protocol, so a raising objective
    returns a ``fail`` result and the worker lives on. A bind other than
    loopback needs ``secret`` (the HMAC handshake) unless
    ``allow_insecure``. ``announce`` gets the ``host:port`` line (the CLI
    prints it); else it goes to the module's logger. With ``block=False``
    returns the serving :class:`..runtime.rpc.RpcServer`.
    """
    from ..hpo.fmin import call_with_protocol
    from ..runtime.rpc import RpcServer
    from ..telemetry.export import rpc_handlers

    host, _, port = bind.rpartition(":")

    def _evaluate(payload):
        fn = resolve_objective(payload["objective"])
        with telemetry.span("trial", objective=payload["objective"]):
            return call_with_protocol(fn, payload["args"])

    server = RpcServer({"evaluate": _evaluate, "ping": lambda _: "pong", **rpc_handlers()},
                       host or "127.0.0.1", int(port), secret=secret,
                       allow_insecure=allow_insecure)
    message = f"trial worker listening on {server.address[0]}:{server.address[1]}"
    if announce is not None:
        announce(message)
    else:
        log.info("%s", message)
    if block:
        server.serve_forever()
        return None
    return server.serve_background()


class HostTrials(Trials):
    """Trials spread over worker processes and hosts (the multi-host
    SparkTrials).

    ``workers`` are ``host:port`` addresses of :func:`serve_trial_worker`
    processes. The coordinating process's TPE proposes; up to
    ``parallelism`` trials evaluate at once, each call on one worker taken
    from a :class:`..resilience.workers.WorkerPool`.

    Failures:

    - An objective's exception (the worker answered; its handler raised)
      fails that trial only; a deterministic failure is not retried.
    - A transport failure (a dead peer, a timeout, a truncated stream) does
      not use up the eval: the worker is dropped from the pool and the trial
      requeued onto another, up to ``max_retries`` times with jittered
      backoff (``retry_total{site=trial.evaluate}``).
    - A dropped worker gets a heartbeat probe and is re-admitted when it
      recovers (``worker_readmitted_total``).
    - A rejected HMAC digest is a misconfiguration: the trial fails at once
      naming auth, and the worker stays pooled. A stalled handshake is
      taken as transport (drop and requeue).
    """

    accepts_objective_ref = True

    def __init__(self, workers, parallelism: int | None = None, rpc_timeout: float = 600.0,
                 secret: bytes | str | None = None, max_retries: int = 2,
                 heartbeat_interval: float = 0.5, dead_grace: float = 1.0):
        super().__init__()
        if not workers:
            raise ValueError("HostTrials needs at least one worker address")
        self.workers = list(workers)
        self.parallelism = parallelism or len(self.workers)
        self.rpc_timeout = rpc_timeout
        self.secret = secret
        self.max_retries = max_retries
        self.heartbeat_interval = heartbeat_interval
        self.dead_grace = dead_grace

    def run(self, objective, space, algo, max_evals, rng, tracker=None) -> None:
        from ..hpo.space import space_eval
        from ..resilience.retry import RetryPolicy, call_with_retry
        from ..resilience.workers import WorkerPool
        from ..runtime.rpc import RpcAuthError, RpcHandshakeTimeout, RpcRemoteError, rpc_call

        ref = objective_ref(objective)
        # Workers run the same package: a ref that does not resolve here
        # would fail every trial remotely, so raise once up front.
        try:
            resolve_objective(ref)
        except Exception as e:
            raise ValueError(f"objective ref {ref!r} does not resolve in the sweep's process: {e!r}") from e

        def probe(worker) -> None:
            # A plain ping on a heartbeat thread (its fault site rpc.send.ping).
            rpc_call(worker, "ping", timeout=min(5.0, self.rpc_timeout), secret=self.secret)

        # Local to each run: a resumed sweep must not duplicate workers or
        # inherit a previous run's dropped and probing state.
        pool = WorkerPool(self.workers, probe=probe, heartbeat_interval=self.heartbeat_interval,
                          dead_grace=self.dead_grace)
        policy = RetryPolicy(max_retries=self.max_retries, base_delay=0.1, max_delay=1.0)

        class _Requeue(ConnectionError):
            """A transport failure already handled (the worker dropped):
            the retry wrapper runs the attempt again on another worker."""

        def attempt(tid: int, point: dict) -> dict:
            worker = pool.get(timeout=self.rpc_timeout)
            if worker is None:
                # The pool is dead for good: every further attempt would see it.
                return {"status": "fail",
                        "error": "no live workers (all busy, dead, or timed out)"}
            try:
                # The whole round trip; the worker records its own span.
                with telemetry.span("trial", tid=tid, worker=str(worker)):
                    result = rpc_call(worker, "evaluate",
                                      {"objective": ref, "args": space_eval(space, point)},
                                      timeout=self.rpc_timeout, secret=self.secret)
            except RpcRemoteError as e:
                # The worker answered, so it is healthy; its handler raised.
                pool.put(worker)
                return {"status": "fail", "error": f"worker {worker}: {e}"}
            except RpcAuthError as e:
                if isinstance(e, RpcHandshakeTimeout):
                    # A stall is no proof of a wrong secret: a hung host that
                    # accepts looks the same. Transport: drop and requeue.
                    pool.drop(worker)
                    raise _Requeue(f"worker {worker} dropped: handshake stalled: {e}") from e
                # A rejected digest cannot succeed on retry or probe: fail
                # the trial naming auth, and keep the worker pooled.
                pool.put(worker)
                return {"status": "fail", "error": f"worker {worker} auth failure: {e}"}
            except Exception as e:
                # Transport: the worker is dead, or still computing the
                # evaluation we abandoned (a timeout). Drop it and requeue.
                # After a timeout mid-evaluation the probe waits a whole
                # rpc_timeout (its threaded server would answer a ping at
                # once); a connect timeout (RpcConnectTimeout, a
                # ConnectionError) delivered nothing, so probe at once.
                pool.drop(worker, cooldown=self.rpc_timeout if isinstance(e, TimeoutError)
                          else 0.0)
                raise _Requeue(f"worker {worker} dropped: {type(e).__name__}: {e}") from e
            pool.put(worker)
            return result

        def evaluate(tid: int, point: dict):
            t0 = time.time()
            try:
                result = call_with_retry(attempt, tid, point, policy=policy,
                                         retryable=lambda e: isinstance(e, _Requeue),
                                         site="trial.evaluate")
            except _Requeue as e:
                result = {"status": "fail", "error": f"{e} (transport retries exhausted)"}
            return tid, point, result, t0

        try:
            _run_async_pool(self, evaluate, algo, space, max_evals, rng, tracker,
                            self.parallelism)
        finally:
            pool.close()
