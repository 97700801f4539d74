"""The port's HPO layer (``hpo/``, ``parallel/trials.py``, ``batched_fmin``)
against the JAX package's.

- Seeded ``tpe_suggest`` / ``random_suggest`` streams over 30 steps equal
  JAX's exactly (the same numpy arithmetic and draws) for uniform,
  loguniform, quniform + ``scope.int``, choice, randint, normal and
  lognormal spaces, fed the same losses.
- Twins of ``tests/test_hpo.py``: sampling ranges, ``space_eval``,
  duplicate labels, seeded determinism, the quadratic, TPE beats random,
  failure and protocol isolation, non-finite losses; ``fmin`` traces
  equal JAX's trial for trial.
- ``DeviceTrials`` on the CPU device list (tids, failure isolation, the
  concurrency bound, resume), and ``DeviceTrials(parallelism=1)`` equal
  to ``Trials``; a run store journals every trial.
- ``batched_fmin``: twins of ``tests/test_group_apply.py``'s, and
  histories equal JAX's for scalar, ``Generator`` and list ``rstate``.
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu import hpo as jax_hpo
from dss_ml_at_scale_tpu.hpo.hp import scope as jax_scope
from dss_ml_at_scale_tpu_torch import hpo
from dss_ml_at_scale_tpu_torch.hpo import (
    STATUS_FAIL,
    STATUS_OK,
    Trials,
    fmin,
    hp,
    random_suggest,
    sample_space,
    space_eval,
    tpe_suggest,
)
from dss_ml_at_scale_tpu_torch.hpo.hp import scope
from dss_ml_at_scale_tpu_torch.parallel.group_apply import batched_fmin
from dss_ml_at_scale_tpu_torch.parallel.trials import DeviceTrials

CPU = [torch.device("cpu")]


def _spaces(h, sc):
    """The same spaces built from either package's ``hp`` and ``scope``."""
    return {
        "uniform": {"x": h.uniform("x", -10, 10)},
        "loguniform": {"lr": h.loguniform("lr", 1e-4, 1.0)},
        "quniform_int": {"p": sc.int(h.quniform("p", 0, 4, 1)),
                         "q": sc.int(h.quniform("q", 0, 4, 1))},
        "choice": {"k": h.choice("k", ["a", "b", "c", "d"])},
        "randint": {"r": h.randint("r", 5)},
        "normal": {"z": h.normal("z", 1.0, 2.0), "c": h.lognormal("c", 0.0, 1.0)},
        "mixed": {"x": h.uniform("x", -3, 3), "q": sc.int(h.quniform("q", 0, 2, 1)),
                  "k": h.choice("k", [1, 2, 3]), "lr": h.qloguniform("lr", 1, 100, 5)},
    }


def _loss(point):
    """A deterministic loss of any point (numbers only)."""
    return float(sum((float(v) - 0.7 * i) ** 2 for i, v in enumerate(point.values())))


@pytest.mark.parametrize("algo", ["tpe", "random"])
@pytest.mark.parametrize("name", list(_spaces(hp, scope)))
def test_suggest_streams_equal_jax_exactly(name, algo):
    mine, theirs = _spaces(hp, scope)[name], _spaces(jax_hpo.hp, jax_scope)[name]
    suggest = {"tpe": (tpe_suggest, jax_hpo.tpe_suggest),
               "random": (random_suggest, jax_hpo.random_suggest)}[algo]
    rng_a, rng_b = np.random.default_rng(11), np.random.default_rng(11)
    hist_a, hist_b = [], []
    for _ in range(30):
        a = suggest[0](mine, hist_a, rng_a)
        b = suggest[1](theirs, hist_b, rng_b)
        assert a == b and [type(v) for v in a.values()] == [type(v) for v in b.values()]
        hist_a.append((a, _loss(a)))
        hist_b.append((b, _loss(b)))
    assert rng_a.bit_generator.state == rng_b.bit_generator.state


def test_fmin_trials_equal_jax_trial_for_trial():
    def obj(p):
        return (p["x"] - 2.0) ** 2 + p["q"] + (p["k"] == 1)

    space = lambda h, sc: {"x": h.uniform("x", -5, 5),  # noqa: E731
                           "q": sc.int(h.quniform("q", 0, 3, 1)),
                           "k": h.choice("k", [0, 1])}
    mine = fmin(obj, space(hp, scope), max_evals=25, rstate=3, return_argmin=False)
    theirs = jax_hpo.fmin(obj, space(jax_hpo.hp, jax_scope), max_evals=25, rstate=3,
                          return_argmin=False)
    assert [t["point"] for t in mine.trials] == [t["point"] for t in theirs.trials]
    assert mine.losses == theirs.losses and mine.argmin() == theirs.argmin()


# -- twins of tests/test_hpo.py ------------------------------------------------


def test_space_sampling_ranges():
    rng = np.random.default_rng(0)
    space = {
        "u": hp.uniform("u", -1, 1),
        "lu": hp.loguniform("lu", 1e-3, 1e2),
        "ln": hp.lognormal("ln", 0, 1),
        "q": scope.int(hp.quniform("q", 0, 4, 1)),
        "c": hp.choice("c", ["a", "b", "c"]),
    }
    for _ in range(200):
        pt = sample_space(space, rng)
        assert -1 <= pt["u"] <= 1
        assert 1e-3 <= pt["lu"] <= 1e2
        assert pt["ln"] > 0
        assert pt["q"] in (0, 1, 2, 3, 4) and isinstance(pt["q"], int)
        assert pt["c"] in (0, 1, 2)


def test_space_eval_structure():
    space = {
        "order": (scope.int(hp.quniform("p", 0, 4, 1)), scope.int(hp.quniform("d", 0, 2, 1)),
                  scope.int(hp.quniform("q", 0, 4, 1))),
        "trend": hp.choice("trend", ["n", "c", "t"]),
        "fixed": 42,
    }
    out = space_eval(space, {"p": 2, "d": 1, "q": 3, "trend": 1})
    assert out == {"order": (2, 1, 3), "trend": "c", "fixed": 42}


def test_duplicate_labels_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        sample_space([hp.uniform("x", 0, 1), hp.uniform("x", 5, 6)], np.random.default_rng(0))


def test_seeded_sampling_deterministic():
    space = {"x": hp.uniform("x", 0, 1), "c": hp.choice("c", [1, 2, 3])}
    a = [sample_space(space, np.random.default_rng(42)) for _ in range(3)]
    assert a[0] == a[1] == a[2]


def test_loguniform_bounds_validated():
    with pytest.raises(ValueError, match="low > 0"):
        hp.loguniform("x", 0, 10)
    with pytest.raises(ValueError, match="low > 0"):
        hp.qloguniform("x", 0, 10, 1)


def test_randint_uniform_endpoints():
    rng = np.random.default_rng(0)
    draws = [sample_space({"k": hp.randint("k", 3)}, rng)["k"] for _ in range(3000)]
    counts = np.bincount(draws, minlength=3) / 3000
    assert np.all(np.abs(counts - 1 / 3) < 0.05), counts


def test_fmin_sequential_quadratic():
    best = fmin(lambda p: (p["x"] - 3.0) ** 2, {"x": hp.uniform("x", -10, 10)},
                max_evals=60, rstate=0)
    assert abs(best["x"] - 3.0) < 0.5


def test_fmin_reproducible_with_seed():
    space = {"x": hp.uniform("x", -5, 5)}
    obj = lambda p: (p["x"] + 1) ** 2  # noqa: E731
    assert fmin(obj, space, max_evals=25, rstate=7) == fmin(obj, space, max_evals=25, rstate=7)


def test_tpe_beats_random_on_quadratic():
    space = {"x": hp.uniform("x", -10, 10), "y": hp.uniform("y", -10, 10)}
    obj = lambda p: (p["x"] - 2) ** 2 + (p["y"] + 4) ** 2  # noqa: E731

    def best_loss(algo, seed):
        t = fmin(obj, space, algo=algo, max_evals=50, rstate=seed, return_argmin=False)
        return min(v for v in t.losses if v is not None)

    tpe = [best_loss(tpe_suggest, s) for s in range(5)]
    rnd = [best_loss(random_suggest, s) for s in range(5)]
    assert np.mean(tpe) < np.mean(rnd)


def test_failed_trials_are_isolated():
    calls = {"n": 0}

    def flaky(p):
        calls["n"] += 1
        if p["x"] < 0:
            raise RuntimeError("negative!")
        return p["x"] ** 2

    trials = fmin(flaky, {"x": hp.uniform("x", -1, 1)}, max_evals=30, rstate=3,
                  return_argmin=False)
    assert {t["result"]["status"] for t in trials.trials} == {STATUS_FAIL, STATUS_OK}
    assert len(trials.trials) == 30 and calls["n"] == 30
    assert trials.best_trial["result"]["loss"] >= 0
    fail = next(t for t in trials.trials if t["result"]["status"] == STATUS_FAIL)
    assert "negative!" in fail["result"]["error"]


def test_objective_dict_protocol_and_choice():
    trials = fmin(lambda p: {"loss": p["x"] ** 2, "status": STATUS_OK, "extra": "kept"},
                  {"x": hp.uniform("x", -2, 2)}, max_evals=12, rstate=0, return_argmin=False)
    assert trials.best_trial["result"]["extra"] == "kept"
    table = {"a": 3.0, "b": 0.5, "c": 2.0}
    best = fmin(lambda p: table[p["kernel"]], {"kernel": hp.choice("kernel", ["a", "b", "c"])},
                max_evals=25, rstate=0)
    assert best["kernel"] == 1  # index, like hyperopt's argmin


def test_malformed_result_fails_trial_not_sweep():
    out = fmin(lambda p: {"loss": "bad", "status": STATUS_OK}, {"x": hp.uniform("x", 0, 1)},
               max_evals=3, rstate=0, return_argmin=False)
    assert all(t["result"]["status"] == STATUS_FAIL for t in out.trials)


def test_fmin_nonfinite_loss_is_isolated():
    calls = iter(range(100))

    def obj(p):
        return float("nan") if next(calls) == 0 else (p["x"] - 2.0) ** 2

    trials = Trials()
    best = fmin(obj, {"x": hp.uniform("x", 0, 5)}, max_evals=15, trials=trials, rstate=0)
    assert abs(best["x"] - 2.0) < 1.5
    assert sum(r["status"] == "fail" for r in trials.results) == 1
    assert all(math.isfinite(loss) for _, loss in trials._history())


def test_string_objective_needs_a_remote_executor():
    with pytest.raises(TypeError, match="string ref"):
        fmin("mod:fn", {"x": hp.uniform("x", 0, 1)}, max_evals=1)


# -- DeviceTrials ------------------------------------------------------------------


def test_device_trials_parallel_sweep_on_the_cpu():
    seen, lock = [], threading.Lock()

    def obj(p):
        val = float(torch.tensor(p["x"]) ** 2)
        with lock:
            seen.append(p["x"])
        return val

    trials = DeviceTrials(parallelism=4, devices=CPU * 4)
    best = fmin(obj, {"x": hp.uniform("x", -3, 3)}, max_evals=20, trials=trials, rstate=0)
    assert len(trials.trials) == 20 and len(seen) == 20
    assert [t["tid"] for t in trials.trials] == list(range(20))
    assert abs(best["x"]) < 1.5


def test_device_trials_failure_isolation():
    def obj(p):
        if p["x"] > 0:
            raise ValueError("boom")
        return -p["x"]

    trials = DeviceTrials(parallelism=3, devices=CPU * 3)
    fmin(obj, {"x": hp.uniform("x", -1, 1)}, max_evals=15, trials=trials, rstate=1)
    assert len(trials.trials) == 15
    assert any(t["result"]["status"] == STATUS_FAIL for t in trials.trials)
    assert trials.best_trial["result"]["loss"] >= 0


@pytest.mark.parametrize("pin", [True, False])
def test_device_trials_max_concurrency(pin):
    state, lock = {"now": 0, "peak": 0}, threading.Lock()

    def obj(p):
        with lock:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
        time.sleep(0.02)
        with lock:
            state["now"] -= 1
        return p["x"] ** 2

    trials = (DeviceTrials(parallelism=3, devices=CPU * 2) if pin
              else DeviceTrials(parallelism=3, pin_devices=False))
    fmin(obj, {"x": hp.uniform("x", -1, 1)}, max_evals=12, trials=trials, rstate=0)
    # Pinned, the pool of 2 devices bounds it below the 3 threads.
    assert 1 <= state["peak"] <= (2 if pin else 3)


def test_device_trials_resume_keeps_the_pool():
    dt = DeviceTrials(parallelism=2, devices=CPU * 2)
    fmin(lambda p: p["x"] ** 2, {"x": hp.uniform("x", -1, 1)}, max_evals=4, trials=dt, rstate=0)
    fmin(lambda p: p["x"] ** 2, {"x": hp.uniform("x", -1, 1)}, max_evals=10, trials=dt,
         rstate=1)
    assert [t["tid"] for t in dt.trials] == list(range(10))


def test_device_trials_of_one_equal_sequential_trials():
    space = {"x": hp.uniform("x", -4, 4), "q": scope.int(hp.quniform("q", 0, 3, 1))}

    def obj(p):
        return (p["x"] - 1) ** 2 + 0.1 * p["q"]

    seq = fmin(obj, space, max_evals=20, rstate=5, return_argmin=False)
    par = fmin(obj, space, max_evals=20, trials=DeviceTrials(parallelism=1, devices=CPU),
               rstate=5, return_argmin=False)
    assert [t["point"] for t in par.trials] == [t["point"] for t in seq.trials]
    assert par.losses == seq.losses


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
def test_device_trials_need_a_card_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTrials(parallelism=2)


def test_trials_submit_and_trial_spans_share_a_trace():
    """Each trial's span joins the trace its proposal minted (the handoff
    across the pool boundary), and the outcome counter counts it."""
    from dss_ml_at_scale_tpu_torch import telemetry

    def outcomes():
        return sum(m["value"] for m in telemetry.snapshot()["metrics"]
                   if m["name"] == "hpo_trials_total" and m["labels"].get("status") == "ok")

    before = outcomes()
    start = len(telemetry.get_span_log().events())
    fmin(lambda p: p["x"] ** 2, {"x": hp.uniform("x", -1, 1)}, max_evals=3,
         trials=DeviceTrials(parallelism=2, devices=CPU), rstate=0)
    events = [e for e in telemetry.get_span_log().events()[start:]
              if e["name"] in ("trial", "trial.submit")]
    by_tid: dict = {}
    for e in events:
        by_tid.setdefault(e["args"]["tid"], []).append(e.get("trace"))
    assert sorted(by_tid) == [0, 1, 2]
    assert all(len(ids) == 2 and ids[0] == ids[1] is not None for ids in by_tid.values())
    assert len({ids[0] for ids in by_tid.values()}) == 3
    assert outcomes() == before + 3


def test_fmin_journals_every_trial_in_a_run_store(tmp_path):
    from dss_ml_at_scale_tpu_torch.tracking import RunStore, read_journal

    store = RunStore(tmp_path, "hpo", run_name="sweep")
    fmin(lambda p: p["x"] ** 2, {"x": hp.uniform("x", -1, 1)}, max_evals=6,
         trials=DeviceTrials(parallelism=2, devices=CPU), rstate=0, tracker=store)
    store.finish()
    trials = [e for e in read_journal(store.path) if e["event"] == "trial"]
    assert sorted(e["tid"] for e in trials) == list(range(6))
    assert all(e["status"] == STATUS_OK and e["loss"] >= 0 for e in trials)
    assert sorted(m["step"] for m in store.metrics() if m["name"] == "loss") == list(range(6))


# -- batched_fmin --------------------------------------------------------------------

_SPACE = {"x": hp.uniform("x", -5, 5)}


def test_batched_fmin_per_group_optima():
    """Twin of tests/test_group_apply.py: each group finds its own optimum."""
    targets = np.array([-3.0, 0.0, 2.5])

    def evaluate(points):
        return np.array([(p["x"] - t) ** 2 for p, t in zip(points, targets)])

    best, hist = batched_fmin(evaluate, _SPACE, max_evals=40, n_groups=3, rstate=0)
    for b, t in zip(best, targets):
        assert abs(b["x"] - t) < 1.0
    assert all(len(h) == 40 for h in hist)


def test_batched_fmin_failed_group_trial_isolated():
    def evaluate(points):
        out = np.array([p["x"] ** 2 for p in points])
        out[1] = np.nan  # group 1 always diverges this round
        return out

    with pytest.raises(ValueError, match="group 1"):
        batched_fmin(evaluate, _SPACE, max_evals=5, n_groups=3, rstate=0)
    calls = iter(range(1000))

    def flaky(points):
        k = next(calls)
        out = np.array([p["x"] ** 2 for p in points])
        if k == 0:
            out[1] = np.inf
        return out

    _, hist = batched_fmin(flaky, _SPACE, max_evals=5, n_groups=3, rstate=0)
    assert [len(h) for h in hist] == [5, 4, 5]
    with pytest.raises(ValueError, match="want"):
        batched_fmin(lambda pts: np.zeros(2), _SPACE, max_evals=1, n_groups=3)
    with pytest.raises(ValueError, match="rstates"):
        batched_fmin(flaky, _SPACE, max_evals=1, n_groups=3, rstate=[1, 2])


def test_batched_fmin_matches_sequential_fmin():
    """Twin of tests/test_group_apply.py: one group replays fmin's stream."""
    space = {"x": hp.uniform("x", 0, 10)}
    obj = lambda p: (p["x"] - 3.0) ** 2  # noqa: E731
    trials = Trials()
    fmin(obj, space, max_evals=12, trials=trials, rstate=7)
    best, hist = batched_fmin(lambda pts: np.array([obj(pts[0])]), space, 12, 1,
                              rstate=[np.random.default_rng(7)])
    assert [p["x"] for p, _ in hist[0]] == [t["point"]["x"] for t in trials.trials]
    assert abs(best[0]["x"] - 3.0) < 1.0


@pytest.mark.parametrize("kind", ["scalar", "generator", "list"])
def test_batched_fmin_histories_equal_jax(kind):
    from dss_ml_at_scale_tpu.parallel.group_apply import batched_fmin as jax_batched_fmin

    def space(h, sc):
        return {"p": sc.int(h.quniform("p", 0, 4, 1)), "x": h.uniform("x", -2, 2)}

    def evaluate(points):
        # Group 3 fails its trials at p = 4: they stay out of its history.
        return np.array([np.nan if g == 3 and p["p"] == 4 else
                         (p["p"] - 2) ** 2 + (p["x"] - 0.3 * g) ** 2
                         for g, p in enumerate(points)], float)

    def rstate():
        if kind == "scalar":
            return 123
        if kind == "generator":
            return np.random.default_rng(9)
        return [np.random.default_rng(s) for s in range(4)]

    mine = batched_fmin(evaluate, space(hp, scope), 14, 4, rstate=rstate())
    theirs = jax_batched_fmin(evaluate, space(jax_hpo.hp, jax_scope), 14, 4, rstate=rstate())
    assert mine == theirs
    if kind == "scalar":  # the reference's rstate=123 for every SKU: the same first draw
        assert mine[1][0][0][0] == mine[1][1][0][0]


def test_hpo_package_exports():
    assert {"STATUS_OK", "STATUS_FAIL", "Trials", "fmin", "hp", "sample_space", "space_eval",
            "TPE", "random_suggest", "tpe_suggest"} <= set(dir(hpo))
