"""The port's SIGKILL chaos soak on the CPU (``--device cpu``).

The port's counterparts of the JAX package's ``tests/test_crashonly.py``
soak cases: a seeded 5-cycle soak against the port's ``train`` (one kill
inside the save window through ``fs.crash_after_tmp.manifest``,
``--resume-auto`` between cycles) passes every invariant, final parameters
bitwise equal to the uninterrupted same-seed run included; the serve soak
restarts ``serve`` on the trained checkpoint; the hpo soak completes every
trial; ``chaos --json`` emits the report and exits by its verdict; a soak
asked for the card where there is none is refused. Every child has a time
limit of its own (``timeout_s``), so a hang fails instead of stalling.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.resilience.chaos import ChaosConfig, run_chaos

CHILD_LIMIT = 120.0  # seconds, each child


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    # The children inherit the environment: one intra-op thread each keeps
    # a soak beside other test workers from oversubscribing the cores.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("DSST_FAULT_PLAN", raising=False)


def _failing(report: dict) -> str:
    return json.dumps({k: v for k, v in report["invariants"].items() if not v.get("ok")},
                      indent=1)


def test_train_soak_five_sigkill_cycles_then_serve_restarts(tmp_path):
    report = run_chaos(ChaosConfig(
        workdir=str(tmp_path / "soak"), cycles=5, seed=0, kill_min_s=1.0, kill_max_s=3.0,
        epochs=2, rows=48, batch_size=16, image_size=32, timeout_s=CHILD_LIMIT,
        device="cpu"))
    assert report["ok"], _failing(report)
    assert report["kills_delivered"] >= 5
    inv = report["invariants"]
    assert set(inv) == {"final_run_completed", "kill_schedule_completed", "save_window_kill",
                        "runs_terminal", "manifest_walk_clean", "no_stranded_tmp",
                        "commit_log_sane", "params_bitwise_equal", "flight_recorder_tail"}
    parity = inv["params_bitwise_equal"]
    assert parity["chaos"] == parity["ref"] and parity["chaos"]["step"] == 6
    assert inv["save_window_kill"]["fs_cycles"] == [2]
    assert any({"fit"} <= set(names) for names in
               inv["flight_recorder_tail"]["open_spans_per_run"])

    serve = run_chaos(ChaosConfig(
        workdir=str(tmp_path / "serve"), workload="serve", cycles=2,
        checkpoint_dir=str(tmp_path / "soak" / "ckpt"), timeout_s=CHILD_LIMIT, device="cpu"))
    assert serve["ok"] and serve["kills_delivered"] == 2, serve


def test_hpo_soak_completes_every_trial(tmp_path):
    report = run_chaos(ChaosConfig(
        workdir=str(tmp_path / "hpo"), workload="hpo", cycles=2, seed=1, kill_min_s=1.0,
        kill_max_s=3.0, max_evals=6, timeout_s=CHILD_LIMIT, device="cpu"))
    assert report["ok"], _failing(report)
    assert report["invariants"]["all_trials_completed"]["tids"] == list(range(6))


def test_chaos_cli_json_report(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["chaos", "--workdir", str(tmp_path / "c"), "--cycles", "1", "--seed", "2",
                   "--epochs", "1", "--kill-max", "2.0", "--timeout", str(CHILD_LIMIT),
                   "--device", "cpu", "--json"])
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == (0 if report["ok"] else 1)
    assert report["workload"] == "train" and report["device"] == "cpu"
    assert "params_bitwise_equal" in report["invariants"]


def test_chaos_on_the_card_without_one_is_refused(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["chaos", "--workdir", str(tmp_path / "c"), "--cycles", "1"])
    assert rc == 1 and "no CUDA device" in out.getvalue()
    assert not (tmp_path / "c").exists()
    with pytest.raises(ValueError, match="checkpoint-dir"):
        run_chaos(ChaosConfig(workdir=str(tmp_path / "s"), workload="serve", device="cpu"))
