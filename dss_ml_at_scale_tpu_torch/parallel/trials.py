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
"""

from __future__ import annotations

import contextlib
import queue
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import torch

from .. import telemetry
from ..hpo.fmin import Trials, _call_objective, _log_trial
from ..telemetry import tracecontext


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
