"""The port's run store vs the JAX package's (``tracking/store.py``;
``tests/test_tracking.py``, ``tests/test_crashonly.py``).

- ``RunStore`` round trips params, metrics, artifacts, text, the telemetry
  archive and the journal; ``to_mlflow`` raises where ``mlflow`` is
  missing, as the JAX store's does.
- On the same on-disk layout, each package's ``classify_run``,
  ``list_runs`` and ``sweep_interrupted`` give the same answer on run
  directories the other wrote: finished, failed, and a RUNNING run whose
  writer is dead (INTERRUPTED, with its journaled checkpoint).
- The ``train``, ``lm`` and ``serve-lm`` commands log a FINISHED run; a
  command that raises logs FAILED.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from dss_ml_at_scale_tpu import tracking as jax_tracking
from dss_ml_at_scale_tpu_torch import tracking
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.resilience import faults
from dss_ml_at_scale_tpu_torch.tracking import RunStore, start_run

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


def test_run_store_round_trip(tmp_path):
    src = tmp_path / "model.txt"
    src.write_text("weights")
    store = RunStore(tmp_path / "store", "exp1", run_name="my-run")
    store.log_params({"lr": 1e-5, "batch": 212, "obj": object()})
    store.log_metrics({"loss": 2.5}, step=1)
    store.log_metrics({"loss": 1.5, "acc": 0.7}, step=2)
    store.log_artifact(src)
    store.log_text("hello", "notes.md")
    store.log_telemetry({"metrics": []})
    store.journal_checkpoint(4, str(tmp_path / "ck"))
    store.finish()
    store.finish()  # idempotent
    store.log_metrics({"loss": 0.5}, step=3)  # after finish: dropped
    assert store.params()["lr"] == 1e-5 and store.params()["obj"].startswith("<object")
    assert [m["value"] for m in store.metrics() if m["name"] == "loss"] == [2.5, 1.5]
    meta = json.loads((store.path / "meta.json").read_text())
    assert meta["status"] == "FINISHED" and meta["run_name"] == "my-run"
    run = tracking.load_run(tmp_path / "store", "exp1", store.run_id)
    assert run["last_metrics"]["loss"] == {"value": 1.5, "step": 2}
    assert run["artifacts"] == ["model.txt", "notes.md"] and run["metric_points"] == 3
    assert json.loads((store.path / "telemetry.json").read_text()) == {"metrics": []}
    events = [e["event"] for e in tracking.read_journal(store.path)]
    # Every run registers its flight recorder and alert journal (the
    # JAX store's trace and slo_journal events).
    assert events == ["start", "trace", "slo_journal", "checkpoint", "finish"]
    with pytest.raises(ImportError):
        store.to_mlflow()


def test_start_run_marks_failed(tmp_path):
    with pytest.raises(RuntimeError):
        with start_run(tmp_path, "exp") as run:
            raise RuntimeError("boom")
    assert json.loads((run.path / "meta.json").read_text())["status"] == "FAILED"


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def _runs(store_cls, root, ckpt: Path):
    """A finished run, a failed one, and a RUNNING one whose writer died
    after journaling a checkpoint."""
    a = store_cls(root, "exp", run_name="done")
    a.log_metrics({"loss": 1.0}, step=1)
    a.finish()
    b = store_cls(root, "exp", run_name="failed")
    b.finish("FAILED")
    c = store_cls(root, "exp", run_name="killed")
    c.journal_event("config", checkpoint_dir=str(ckpt))
    c.journal_checkpoint(2, str(ckpt))
    c._metrics.close()
    if hasattr(c, "_trace_path"):  # the JAX store's recorders stop with the "dead" writer
        from dss_ml_at_scale_tpu.telemetry import flightrec
        from dss_ml_at_scale_tpu.telemetry import slo as jax_slo

        flightrec.disable(c._trace_path)
        jax_slo.get_engine().detach_journal(c._alerts_path)
    journal = c.path / "journal.jsonl"
    lines = journal.read_text().splitlines()
    start = json.loads(lines[0])
    start["pid"] = _dead_pid()
    journal.write_text("\n".join([json.dumps(start)] + lines[1:]) + "\n")
    return c.path


def _comparable(report):
    return sorted(({k: v for k, v in r.items() if k not in ("heartbeat_age_s",)}
                   for r in report), key=lambda r: r["run_id"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_classifies_the_others_runs(tmp_path, writer):
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity

    ckpt = tmp_path / "ck"
    (ckpt / "2").mkdir(parents=True)
    (ckpt / "2" / "state.pt").write_bytes(b"x")
    integrity.write_manifest(ckpt / "2")
    store_cls = jax_tracking.RunStore if writer == "jax" else RunStore
    killed = _runs(store_cls, tmp_path / "runs", ckpt)
    port_cls, jax_cls = tracking.classify_run(killed), jax_tracking.classify_run(killed)
    assert port_cls["effective_status"] == jax_cls["effective_status"] == "INTERRUPTED"
    assert {k: v for k, v in port_cls.items() if k != "heartbeat_age_s"} == {
        k: v for k, v in jax_cls.items() if k != "heartbeat_age_s"}
    assert port_cls["last_step"] == 2 and port_cls["checkpoint_dir"] == str(ckpt)
    listed = [{k: v for k, v in m.items() if k != "wall_seconds"}
              for m in tracking.list_runs(tmp_path / "runs")]
    assert listed == [{k: v for k, v in m.items() if k != "wall_seconds"}
                      for m in jax_tracking.list_runs(tmp_path / "runs")]
    assert sorted(m["status"] for m in listed) == ["FAILED", "FINISHED", "INTERRUPTED"]
    # One sweep marks the dead run; the other package then reads the mark.
    sweep, other = ((tracking.sweep_interrupted, jax_tracking.sweep_interrupted)
                    if writer == "jax" else
                    (jax_tracking.sweep_interrupted, tracking.sweep_interrupted))
    first = sweep(tmp_path / "runs")
    assert [r.get("marked") for r in first if r["run_id"] == killed.name] == [True]
    assert [r["resumable_step"] for r in first if r["run_id"] == killed.name] == [2]
    again = _comparable(other(tmp_path / "runs"))
    assert again == _comparable(sweep(tmp_path / "runs", mark=False))
    assert {r["run_id"]: r["status"] for r in again}[killed.name] == "INTERRUPTED"
    assert not any(r.get("marked") for r in again)


def _main(argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    assert lines[-2].startswith("run -> ")
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    path = tmp_path_factory.mktemp("img") / "t"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["datagen", "images", "--out", str(path), "--n", "16", "--classes",
                         "4", "--size", "32"]) == 0
    return str(path)


def _only_run(root, experiment):
    runs = tracking.list_runs(root, experiment)
    assert len(runs) == 1
    return runs[0], root / experiment / runs[0]["run_id"]


def test_train_and_lm_log_finished_runs(tmp_path, images):
    root = tmp_path / "runs"
    _main(["train", "--data", images, "--model", "tiny-bottleneck", "--pallas-fused",
           "--batch-size", "8", "--crop", "32", "--num-classes", "4", "--epochs", "1",
           "--device", "cpu", "--tracking-root", str(root), "--checkpoint-dir",
           str(tmp_path / "ck")])
    meta, path = _only_run(root, "imagenet")
    assert meta["status"] == "FINISHED" and meta["run_name"] == "train"
    params = json.loads((path / "params.json").read_text())
    assert params["model"] == "tiny-bottleneck" and "fn" not in params
    events = [e["event"] for e in tracking.read_journal(path)]
    assert events == ["start", "trace", "slo_journal", "config", "checkpoint", "finish"]
    assert (path / "flightrec.jsonl").is_file()
    assert tracking.read_journal(path)[0]["cmdline"][0] == "train"
    _main(["lm", "--device", "cpu", "--vocab", "32", "--dim", "32", "--heads", "2",
           "--layers", "1", "--seq", "16", "--batch-size", "2", "--steps-per-epoch", "2",
           "--epochs", "1", "--limit-val-batches", "1", "--tracking-root", str(root),
           "--experiment", "lm-x"])
    meta, path = _only_run(root, "lm-x")
    assert meta["status"] == "FINISHED"
    assert "entropy_floor" in json.loads((path / "params.json").read_text())
    assert tracking.load_run(root, "lm-x", meta["run_id"])["last_metrics"]["val_loss"][
        "step"] == 2


def test_no_tracking_writes_no_run(tmp_path, images):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", "--data", images, "--model", "tiny", "--batch-size", "8",
                         "--crop", "32", "--num-classes", "4", "--epochs", "1", "--device",
                         "cpu", "--tracking-root", str(tmp_path / "runs"),
                         "--no-tracking"]) == 0
    assert "run ->" not in out.getvalue() and not (tmp_path / "runs").exists()


def test_a_raised_command_logs_a_failed_run(tmp_path, images):
    root = tmp_path / "runs"
    with pytest.raises(faults.InjectedFault), contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--fault-plan", "checkpoint.save=1", "train", "--data", images, "--model",
                  "tiny", "--batch-size", "8", "--crop", "32", "--num-classes", "4",
                  "--epochs", "1", "--device", "cpu", "--tracking-root", str(root),
                  "--checkpoint-dir", str(tmp_path / "ck")])
    os.environ.pop("DSST_FAULT_PLAN", None)
    meta, path = _only_run(root, "imagenet")
    assert meta["status"] == "FAILED"
    last = tracking.read_journal(path)[-1]
    assert (last["event"], last["status"]) == ("finish", "FAILED")
    assert tracking.classify_run(path)["effective_status"] == "FAILED"


def test_serve_lm_logs_a_finished_run(tmp_path):
    root = tmp_path / "runs"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "serve-lm", "--stub",
         "--port", "0", "--slots", "2", "--max-len", "32", "--prefill-buckets", "8",
         "--tracking-root", str(root)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        boot = json.loads(proc.stdout.readline())
        assert boot["decoder"] == "StubLMDecoder"
        meta, path = _only_run(root, "serve-lm")
        assert meta["status"] == "RUNNING"
        assert tracking.classify_run(path)["effective_status"] == "RUNNING"
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    assert "run -> " in out
    meta, _ = _only_run(root, "serve-lm")
    assert meta["status"] == "FINISHED"
