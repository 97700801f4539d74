"""``fmin``'s main loop + ``Trials`` stores.

Port of ``dss_ml_at_scale_tpu/hpo/fmin.py``, the reference's surface:
``fmin(objective, space, algo=tpe.suggest, max_evals=N, trials=...,
rstate=np.random.default_rng(seed))`` returning the best point dict.
Objectives return either a bare loss or ``{'loss': x, 'status':
STATUS_OK, ...}``.

SparkTrials semantics kept: a raising objective marks its trial ``fail``
and the sweep goes on (per-trial failure isolation); concurrent execution
is a ``Trials`` subclass
(:class:`dss_ml_at_scale_tpu_torch.parallel.trials.DeviceTrials`) that
overlaps up to ``parallelism`` evaluations. A tracker (the port's
:class:`..tracking.RunStore`) journals every completed trial.
"""

from __future__ import annotations

import time
import traceback
from typing import Any, Callable, Mapping

import numpy as np

from .space import space_eval
from .tpe import tpe_suggest

STATUS_OK = "ok"
STATUS_FAIL = "fail"


class Trials:
    """Sequential trial store + executor (hyperopt's plain ``Trials``)."""

    def __init__(self):
        self.trials: list[dict] = []

    # -- store ------------------------------------------------------------

    @property
    def results(self) -> list[dict]:
        return [t["result"] for t in self.trials]

    @property
    def losses(self) -> list[float | None]:
        return [t["result"].get("loss") for t in self.trials]

    @property
    def best_trial(self) -> dict:
        # Finiteness guard on top of the status filter: NaN poisons
        # min() comparisons (every comparison is False, so whichever
        # trial happens to sit first "wins"), and results recorded by
        # stores that bypass call_with_protocol must not crown a
        # diverged trial.
        ok = [
            t for t in self.trials
            if t["result"].get("status") == STATUS_OK
            and _finite_loss(t["result"].get("loss"))
        ]
        if not ok:
            raise ValueError("no successful trials")
        return min(ok, key=lambda t: t["result"]["loss"])

    def argmin(self) -> dict:
        return dict(self.best_trial["point"])

    def _history(self) -> list[tuple[dict, float]]:
        # Same guard: a non-finite loss must not feed the TPE surrogate
        # (tpe.suggest filters too: defense in depth across stores).
        return [
            (t["point"], t["result"]["loss"])
            for t in self.trials
            if t["result"].get("status") == STATUS_OK
            and _finite_loss(t["result"].get("loss"))
        ]

    def _record(self, tid, point, result, t0) -> None:
        self.trials.append(
            {
                "tid": tid,
                "point": point,
                "result": result,
                "book_time": t0,
                "duration": time.time() - t0,
            }
        )

    # -- execution (overridden by distributed stores) ---------------------

    def run(self, objective, space, algo, max_evals, rng, tracker=None) -> None:
        for tid in range(len(self.trials), max_evals):
            point = algo(space, self._history(), rng)
            t0 = time.time()
            result = _call_objective(objective, space, point)
            self._record(tid, point, result, t0)
            if tracker is not None:
                _log_trial(tracker, tid, point, result)


def _finite_loss(loss) -> bool:
    try:
        return loss is not None and np.isfinite(loss)
    except TypeError:
        return False


def _call_objective(objective, space, point) -> dict:
    return call_with_protocol(objective, space_eval(space, point))


def call_with_protocol(objective, args) -> dict:
    """Invoke ``objective(args)`` under the trial-result protocol.

    Protocol violations (missing or non-numeric loss) fail the TRIAL, not
    the sweep: the same isolation as an objective that raises. Shared by
    the local executors (after ``space_eval``).
    """
    try:
        # Objective-side fault site: an injected fault here exercises the
        # permanent-fail path (objective failures are deterministic and
        # are not transport-retried).
        from ..resilience.faults import maybe_fail

        maybe_fail("trial.evaluate")
        out = objective(args)
        if isinstance(out, Mapping):
            result = dict(out)
            result.setdefault("status", STATUS_OK)
            if result["status"] == STATUS_OK:
                result["loss"] = float(result["loss"])
        else:
            result = {"loss": float(out), "status": STATUS_OK}
        # A diverged objective (NaN/inf loss) must not win argmin (NaN
        # poisons min() comparisons) nor feed the TPE surrogate.
        if result["status"] == STATUS_OK and not np.isfinite(result["loss"]):
            return {"status": STATUS_FAIL, "error": f"non-finite loss {result['loss']}"}
        return result
    except Exception:
        return {"status": STATUS_FAIL, "error": traceback.format_exc()}


def _log_trial(tracker, tid, point, result) -> None:
    metrics = {"trial": float(tid)}
    if result.get("loss") is not None:
        metrics["loss"] = result["loss"]
    tracker.log_metrics(metrics, step=tid)
    tracker.log_params({f"trial_{tid}": point})
    # Intent-log the completed trial (RunStore journals durably): the
    # journal holds exactly the trials that committed.
    journal = getattr(tracker, "journal_event", None)
    if journal is not None:
        journal(
            "trial", tid=int(tid), point=dict(point),
            loss=result.get("loss"), status=result.get("status"),
        )


def fmin(
    fn: Callable[[Any], Any],
    space,
    algo=tpe_suggest,
    max_evals: int = 100,
    trials: Trials | None = None,
    rstate: np.random.Generator | int | None = None,
    tracker=None,
    return_argmin: bool = True,
):
    """Minimize ``fn`` over ``space``. Returns the best point dict.

    ``fn`` must be the callable itself: the port's executors evaluate
    locally (a ``module:qualname`` string is for remote executors, which
    the port does not have yet).
    """
    trials = trials if trials is not None else Trials()
    if isinstance(fn, str) and not getattr(trials, "accepts_objective_ref", False):
        raise TypeError(
            f"objective given as string ref {fn!r}, but {type(trials).__name__} "
            "evaluates locally and needs the callable (string refs are for "
            "remote executors)"
        )
    rng = (
        rstate
        if isinstance(rstate, np.random.Generator)
        else np.random.default_rng(rstate)
    )
    trials.run(fn, space, algo, max_evals, rng, tracker=tracker)
    if return_argmin:
        return trials.argmin()
    return trials
