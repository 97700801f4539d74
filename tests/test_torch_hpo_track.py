"""The distributed HPO track in the port (Track B): ``datagen/regression.py``
without scikit-learn, ``hpo/shipping.py``, ``hpo/objectives.py`` and the
``datagen regression``, ``hpo`` and ``trial-worker`` commands, against the
JAX package's (which call scikit-learn).

- ``gen_data``'s four arrays equal JAX's bit for bit (the same numpy
  ``RandomState`` draws as scikit-learn's ``make_regression`` and
  ``train_test_split``).
- ``train_and_eval``'s R² equals JAX's (scikit-learn's ``Lasso``) within
  1e-6 absolute at alphas 0.01, 0.5, 3 and 9.5; measured here 0.0 at
  200,000 bytes and at most 1e-14 on the ill-posed 20,000-byte problem.
- ``tune_alpha`` at parallelism 1 proposes the same alphas and picks the
  same best as JAX's.
- Shipping: ``Broadcast`` builds once per process (2 trial-worker
  processes, 2 builds over 6 trials), ``save_shared``/``load_shared``
  round-trips; twins of ``tests/test_hpo.py:228-300``.
- The CLI: twins of ``tests/test_cli.py``'s hpo tests (closure,
  shared-FS, remote over a worker process, no tracking, the refusals) and
  of ``tests/test_crashonly.py``'s ``hpo --resume-auto``.
"""

import json
import os
import subprocess

import numpy as np
import pytest

from dss_ml_at_scale_tpu.datagen import regression as jax_regression
from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.datagen import regression
from dss_ml_at_scale_tpu_torch.hpo import STATUS_OK, fmin, hp
from dss_ml_at_scale_tpu_torch.hpo.shipping import (
    Broadcast,
    broadcast,
    clear_shared_cache,
    load_shared,
    save_shared,
)
from dss_ml_at_scale_tpu_torch.parallel import HostTrials
from dss_ml_at_scale_tpu_torch.tracking import read_journal
from dss_ml_at_scale_tpu_torch.tracking.store import JOURNAL_NAME
from torch_workers import start_worker, stop

ALPHAS = (0.01, 0.5, 3.0, 9.5)
R2_TOL = 1e-6


@pytest.fixture(scope="module")
def data200k():
    return regression.gen_data(200_000), jax_regression.gen_data(200_000)


def test_gen_data_equals_jax_bit_for_bit(data200k):
    got, want = data200k
    assert [a.shape for a in got] == [(197, 100), (50, 100), (197,), (50,)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)


@pytest.mark.parametrize("n_bytes", [20_000, 200_000])
def test_lasso_r2_equals_jax(data200k, n_bytes):
    data = data200k[0] if n_bytes == 200_000 else regression.gen_data(n_bytes)
    for alpha in ALPHAS:
        got = regression.train_and_eval(data, alpha)
        want = jax_regression.train_and_eval(data, alpha)
        assert got["status"] == want["status"] == "ok"
        assert abs(got["loss"] - want["loss"]) <= R2_TOL, (alpha, got, want)


def test_lasso_fit_equals_sklearn_coefficients(data200k):
    from sklearn.linear_model import Lasso

    X, _, y, _ = data200k[0]
    for alpha in ALPHAS:
        coef, intercept = regression.lasso_fit(X, y, alpha)
        model = Lasso(alpha=alpha).fit(X, y)
        np.testing.assert_allclose(coef, model.coef_, atol=1e-9, rtol=0)
        assert abs(intercept - model.intercept_) <= 1e-9


def test_r2_score_is_sklearns(rng):
    from sklearn.metrics import r2_score

    y, p = rng.normal(size=50), rng.normal(size=50)
    assert abs(regression.r2_score(y, p) - r2_score(y, p)) <= 1e-12


def test_tune_alpha_equals_jax_at_parallelism_1(data200k):
    import torch

    from dss_ml_at_scale_tpu.hpo import Trials as JaxTrials
    from dss_ml_at_scale_tpu_torch.hpo import Trials

    data = data200k[0]
    port, jax = Trials(), JaxTrials()
    best = regression.tune_alpha(lambda a: regression.train_and_eval(data, a), max_evals=6,
                                 trials=port)
    jax_best = jax_regression.tune_alpha(lambda a: jax_regression.train_and_eval(data, a),
                                         max_evals=6, trials=jax)
    assert best == jax_best
    assert [t["point"] for t in port.trials] == [t["point"] for t in jax.trials]
    np.testing.assert_allclose([t["result"]["loss"] for t in port.trials],
                               [t["result"]["loss"] for t in jax.trials], atol=R2_TOL, rtol=0)
    # The CLI's default executor, one trial at a time on the CPU device.
    pinned = regression.tune_alpha(lambda a: regression.train_and_eval(data, a), parallelism=1,
                                   max_evals=6, devices=[torch.device("cpu")])
    assert pinned == best


# -- shipping (twins of tests/test_hpo.py) ---------------------------------------

def test_broadcast_lazy_and_shared():
    builds = {"n": 0}

    def factory():
        builds["n"] += 1
        return np.arange(10)

    b = Broadcast(factory=factory)
    assert builds["n"] == 0
    np.testing.assert_array_equal(b.value, np.arange(10))
    b.value
    assert builds["n"] == 1
    assert broadcast([1, 2]).value == [1, 2]
    with pytest.raises(ValueError):
        Broadcast()


def test_unpersist_semantics():
    with pytest.raises(ValueError, match="value-backed"):
        broadcast([1]).unpersist()
    b = Broadcast(factory=lambda: [1, 2])
    assert b.value == [1, 2]
    b.unpersist()
    assert b.value == [1, 2]


def test_shared_fs_roundtrip(tmp_path, rng):
    x, y = rng.normal(size=(100, 5)), np.arange(100)
    path = save_shared(tmp_path / "data", X=x, y=y)
    assert path.endswith(".npz")
    out = load_shared(path)
    np.testing.assert_array_equal(out["X"], x)
    np.testing.assert_array_equal(out["y"], y)
    assert load_shared(path) is out  # cached once per process
    clear_shared_cache()
    assert load_shared(path) is not out


def test_broadcast_materializes_once_per_worker_process():
    """Two trial-worker processes of the port's CLI, six trials of the
    broadcast objective: each process builds the module-level
    ``Broadcast(factory)`` once and every trial there shares it."""
    procs = [start_worker("--bind", "127.0.0.1:0", env={"DSST_BROADCAST_BYTES": "200000"})
             for _ in range(2)]
    try:
        trials = HostTrials([a for _, a in procs], parallelism=2, rpc_timeout=60.0)
        fmin("dss_ml_at_scale_tpu_torch.hpo.objectives:lasso_broadcast",
             {"alpha": hp.uniform("alpha", 0.01, 2.0)}, max_evals=6, trials=trials,
             rstate=np.random.default_rng(0))
    finally:
        for p, _ in procs:
            stop(p)
    results = [t["result"] for t in trials.trials]
    assert all(r["status"] == STATUS_OK for r in results)
    by_pid: dict[int, list] = {}
    for r in results:
        by_pid.setdefault(r["pid"], []).append(r["broadcast_builds"])
    assert len(by_pid) == 2, by_pid
    assert all(b == [1] * len(b) for b in by_pid.values()), by_pid


# -- the CLI ---------------------------------------------------------------------

def test_datagen_regression_and_hpo_shared_fs(tmp_path, capsys):
    npz = tmp_path / "reg.npz"
    assert main(["datagen", "regression", "--bytes", "200000", "--out", str(npz)]) == 0
    assert "regression: 197+50 samples" in capsys.readouterr().out
    arrays = np.load(npz)
    for name, want in zip(("X_train", "X_test", "y_train", "y_test"),
                          jax_regression.gen_data(200_000)):
        assert np.array_equal(arrays[name], want)
    assert main(["hpo", "--data", str(npz), "--parallelism", "2", "--max-evals", "2",
                 "--device", "cpu"]) == 0
    assert "shared-fs" in capsys.readouterr().out


def test_hpo_closure_mode(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DSST_TRACKING_ROOT")
    assert main(["hpo", "--bytes", "100000", "--max-evals", "2", "--device", "cpu"]) == 0
    assert "closure" in capsys.readouterr().out
    runs = list((tmp_path / "dsst_runs" / "hpo").iterdir())
    assert len(runs) == 1
    params = json.loads((runs[0] / "params.json").read_text())
    assert "trial_0" in params and "trial_1" in params and params["mode"] == "closure"
    metrics = [json.loads(line) for line in (runs[0] / "metrics.jsonl").read_text().splitlines()]
    assert sum(1 for m in metrics if m["name"] == "loss") >= 2


def test_hpo_no_tracking_opt_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DSST_TRACKING_ROOT")
    assert main(["hpo", "--bytes", "100000", "--max-evals", "2", "--no-tracking",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    assert not (tmp_path / "dsst_runs").exists()


def test_hpo_closure_equals_jax_cli_at_parallelism_1(tmp_path, capsys):
    from dss_ml_at_scale_tpu.config.cli import main as jax_main

    argv = ["hpo", "--bytes", "100000", "--max-evals", "3", "--parallelism", "1",
            "--no-tracking"]
    assert main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_main(argv) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == port


def test_hpo_refusals(capsys):
    assert main(["hpo", "--workers", "127.0.0.1:1"]) == 2
    assert "requires --data" in capsys.readouterr().out
    assert main(["hpo", "--resume-auto", "--no-tracking", "--device", "cpu"]) == 2
    assert "needs tracking" in capsys.readouterr().out
    import torch

    if not torch.cuda.is_available():
        assert main(["hpo", "--bytes", "1e4", "--max-evals", "1"]) == 1
        assert "no CUDA device" in capsys.readouterr().out


def test_hpo_remote_workers_cli(tmp_path, capsys):
    npz = tmp_path / "reg.npz"
    main(["datagen", "regression", "--bytes", "200000", "--out", str(npz)])
    secret = tmp_path / "secret"
    secret.write_text("s3cret\n")
    proc, addr = start_worker("--bind", "127.0.0.1:0", "--secret-file", str(secret))
    try:
        capsys.readouterr()
        assert main(["hpo", "--workers", addr, "--data", str(npz), "--max-evals", "3",
                     "--parallelism", "1", "--secret-file", str(secret)]) == 0
        out = capsys.readouterr().out
        assert "remote, 1 workers" in out and "3/3 trials ok" in out
    finally:
        stop(proc)


def _dead_pid() -> int:
    p = subprocess.Popen(["sleep", "0"])
    p.wait()
    return p.pid


def test_hpo_resume_auto_continues_from_journaled_trials(tmp_path, capsys):
    root = tmp_path / "runs"
    base = ["hpo", "--bytes", "2e4", "--parallelism", "1", "--tracking-root", str(root),
            "--experiment", "hx", "--device", "cpu"]
    assert main(base + ["--max-evals", "2"]) == 0
    capsys.readouterr()
    # The kill, simulated: the finished run becomes a dead RUNNING run.
    run_dir = next((root / "hx").iterdir())
    meta = json.loads((run_dir / "meta.json").read_text())
    meta["status"] = "RUNNING"
    meta.pop("end_time", None)
    (run_dir / "meta.json").write_text(json.dumps(meta))
    lines = (run_dir / JOURNAL_NAME).read_text().splitlines()
    start = json.loads(lines[0])
    start["pid"] = _dead_pid()
    events = [start] + [json.loads(x) for x in lines[1:] if json.loads(x)["event"] == "trial"]
    (run_dir / JOURNAL_NAME).write_text("".join(json.dumps(e) + "\n" for e in events))

    assert main(base + ["--max-evals", "4", "--resume-auto"]) == 0
    out = capsys.readouterr().out
    assert "continuing from 2 journaled trial(s)" in out and "best alpha" in out
    new_run = max((root / "hx").iterdir(), key=lambda p: p.stat().st_mtime)
    assert sorted(e["tid"] for e in read_journal(new_run) if e["event"] == "trial") == [2, 3]
    assert json.loads((run_dir / "meta.json").read_text())["status"] == "INTERRUPTED"


def test_objectives_import_no_sklearn():
    """The port's regression path runs where scikit-learn is absent."""
    code = ("import sys; sys.modules['sklearn'] = None\n"
            "from dss_ml_at_scale_tpu_torch.datagen.regression import gen_data, train_and_eval\n"
            "from dss_ml_at_scale_tpu_torch.hpo import objectives\n"
            "r = train_and_eval(gen_data(50_000), 0.5); assert r['status'] == 'ok', r\n"
            "print('ok', r['loss'])")
    proc = subprocess.run([os.sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)) or ".")
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stderr[-2000:]
