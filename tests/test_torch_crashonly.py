"""Crash-only training through the port's CLI, in subprocesses
(``tests/test_crashonly.py`` of the JAX package, on the port's ``lm``).

- SIGTERM mid-epoch: the run returns ``preempted`` with a metrics-less
  checkpoint of a mid-epoch step; ``--resume`` and ``--resume-auto`` then
  end at the uninterrupted run's step count.
- A ``kN`` SIGKILL at ``fs.crash_after_tmp.manifest`` (inside the second
  save's window) leaves the step's staging directory stranded;
  ``--resume-auto`` sweeps it and converges.
- ``runs doctor --json`` classifies the killed run INTERRUPTED with its
  resumable step, and ``runs doctor --resume`` revives it to the end.
- ``checkpoints verify`` reports a torn step as corrupt.

Each subprocess has a time limit of its own.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity
from dss_ml_at_scale_tpu_torch.tracking import list_runs

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 120  # seconds, each subprocess
LM = ["lm", "--device", "cpu", "--vocab", "32", "--dim", "32", "--heads", "2", "--layers",
      "1", "--seq", "16", "--batch-size", "2", "--limit-val-batches", "1", "--epochs", "2",
      "--checkpoint-dir", "ck", "--tracking-root", "runs"]


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("DSST_FAULT_PLAN",
                                                              "COORDINATOR_ADDRESS")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(work: Path, *args: str) -> subprocess.Popen:
    work.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli",
                             *args], cwd=work, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, rc=0) -> dict | None:
    try:
        out, err = proc.communicate(timeout=LIMIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == rc, err[-3000:]
    lines = out.strip().splitlines()
    return json.loads(lines[-1]) if rc == 0 else None


def _sigterm_after_first_log(proc: subprocess.Popen, work: Path) -> None:
    """SIGTERM once the fit has logged its first step metrics (step 10):
    the loop, and its SIGTERM handler, are running."""
    deadline = time.monotonic() + LIMIT
    while time.monotonic() < deadline and proc.poll() is None:
        if any(p.stat().st_size for p in (work / "runs").glob("lm/*/metrics.jsonl")):
            proc.send_signal(signal.SIGTERM)
            return
        time.sleep(0.01)
    raise AssertionError("the run logged no step before its end")


def test_sigterm_saves_mid_epoch_and_resume_reaches_the_full_count(tmp_path):
    spe = 400
    argv = [*LM, "--steps-per-epoch", str(spe)]
    works = {how: tmp_path / how for how in ("--resume", "--resume-auto")}
    procs = {how: _start(w, *argv) for how, w in works.items()}
    for how, proc in procs.items():
        _sigterm_after_first_log(proc, works[how])
    for how, proc in procs.items():
        summary = _finish(proc)
        step = summary["steps"]
        assert summary["preempted"] is True and 10 <= step < spe, summary
        ck = works[how] / "ck"
        assert integrity.list_steps(ck) == [step]
        assert json.loads((ck / str(step) / "metrics.json").read_text()) == {}
        assert integrity.verify_step(ck / str(step))[0] == "intact"
    procs = {how: _start(w, *argv, how) for how, w in works.items()}
    for how, proc in procs.items():
        summary = _finish(proc)
        assert summary["steps"] == 2 * spe and summary["preempted"] is False
        assert summary["auto_resumed"] is (how == "--resume-auto")
        assert integrity.list_steps(works[how] / "ck")[-1] == 2 * spe


def test_sigkill_in_the_manifest_window_then_resume_auto_and_doctor(tmp_path):
    spe = 3
    argv = ["--fault-plan", "fs.crash_after_tmp.manifest=k1@1", *LM, "--steps-per-epoch",
            str(spe)]
    works = {how: tmp_path / how for how in ("auto", "doctor")}
    for proc in [_start(w, *argv) for w in works.values()]:
        _finish(proc, rc=-signal.SIGKILL)
    for work in works.values():
        ck = work / "ck"
        assert integrity.list_steps(ck) == [spe]
        stranded = list(ck.glob(f"{2 * spe}.tmp-*"))
        assert len(stranded) == 1 and (stranded[0] / "dsst_manifest.json.tmp").is_file()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["runs", "doctor", "--json", "--tracking-root",
                         str(works["doctor"] / "runs")]) == 0
    (run,) = json.loads(out.getvalue())["runs"]
    assert run["effective_status"] == "INTERRUPTED" and run.get("marked") is True
    assert run["resumable_step"] == spe and run["checkpoint_dir"] == str(works["doctor"] / "ck")
    assert "--fault-plan" in run["cmdline"]
    procs = [_start(works["auto"], *LM, "--steps-per-epoch", str(spe), "--resume-auto"),
             _start(works["doctor"], "runs", "doctor", "--resume", "--tracking-root", "runs")]
    summary = _finish(procs[0])
    assert summary["steps"] == 2 * spe and summary["auto_resumed"] is True
    _finish(procs[1])
    for work in works.values():
        ck = work / "ck"
        assert integrity.list_steps(ck) == [spe, 2 * spe]
        assert not list(ck.glob("*.tmp*")) and not list(ck.rglob("*.tmp"))
        assert all(r["status"] == "intact" for r in integrity.verify_checkpoint_dir(ck))
        statuses = sorted(m["status"] for m in list_runs(work / "runs"))
        assert statuses == ["FINISHED", "INTERRUPTED"]
    # A torn step: checkpoints verify reports it corrupt (exit 1).
    state = works["auto"] / "ck" / str(2 * spe) / "state.pt"
    state.write_bytes(state.read_bytes()[:100])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["checkpoints", "verify", str(works["auto"] / "ck"), "--json"]) == 1
    report = json.loads(out.getvalue())
    assert (report["corrupt"], report["intact"]) == (1, 1)
    assert report["steps"][0]["step"] == 2 * spe and report["steps"][0]["status"] == "corrupt"
