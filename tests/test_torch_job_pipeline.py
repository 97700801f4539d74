"""The port's job-DAG runner (``config/pipeline.py``, the ``pipeline``
command) against the JAX package's.

- Twins of ``tests/test_cli.py``'s pipeline tests: the dry run, dependents
  skipped on failure, retries (until success, and exhausted), the
  failed-vs-skipped summary, and every spec of ``pipelines/`` valid and in
  the JAX runner's topological order.
- ``--task-device`` appends ``--device`` to exactly the tasks whose
  command takes one.
- ``pipelines/imagenet_train.json`` and ``pipelines/full_stack.json`` run
  unchanged through the port with ``--task-device cpu``, and
  ``demand_forecasting.json`` through a test spec with its DAG and
  commands but a reduced size (1 SKU per product, 1 year, small order
  bounds: the real one is the reference's size), each pipeline in a
  subprocess under a timeout of its own.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from dss_ml_at_scale_tpu.config.pipeline import _topo_order as jax_topo_order
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.config import pipeline as pl
from dss_ml_at_scale_tpu_torch.data.delta import DeltaTable

ROOT = Path(__file__).resolve().parents[1]
SPECS = sorted((ROOT / "pipelines").glob("*.json"))


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _spec(tmp_path, tasks, **extra) -> str:
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({"name": "t", "tasks": tasks, **extra}))
    return str(path)


_BAD_BOM = ["datagen", "bom", "--demand", "{workdir}/missing", "--out", "{workdir}/b",
            "--mapper-out", "{workdir}/m"]


@pytest.mark.parametrize("spec", SPECS, ids=[p.stem for p in SPECS])
def test_every_spec_is_valid_and_ordered_as_by_jax(spec):
    tasks = json.loads(spec.read_text())["tasks"]
    got = [t["task_key"] for t in pl._topo_order(tasks)]
    assert got == [t["task_key"] for t in jax_topo_order(tasks)]
    assert set(got) == {t["task_key"] for t in tasks}
    for t in tasks:  # every command parses under the port's CLI
        argv = [a.replace("{workdir}", "/w") for a in t["argv"]]
        if argv[:2] == ["datagen", "photos"] or argv[0] == "ingest":
            continue  # ROADMAP Queue 1 item 2: not ported yet
        cli.build_parser().parse_args(argv)


def test_topo_order_rejects_cycles_duplicates_and_unknown_deps():
    with pytest.raises(ValueError, match="cycle"):
        pl._topo_order([{"task_key": "x", "argv": [], "depends_on": ["y"]},
                        {"task_key": "y", "argv": [], "depends_on": ["x"]}])
    with pytest.raises(ValueError, match="duplicate"):
        pl._topo_order([{"task_key": "x", "argv": []}, {"task_key": "x", "argv": []}])
    with pytest.raises(ValueError, match="unknown"):
        pl._topo_order([{"task_key": "x", "argv": [], "depends_on": ["nope"]}])


def test_pipeline_dry_run(tmp_path):
    spec = _spec(tmp_path, [
        {"task_key": "gen", "argv": ["datagen", "demand", "--out", "{workdir}/d"]},
        {"task_key": "next", "argv": ["runs", "list"], "depends_on": ["gen"]},
    ])
    rc, out = _main(["pipeline", "--spec", spec, "--workdir", str(tmp_path), "--dry-run",
                     "--task-device", "cpu"])
    assert rc == 0
    assert f"datagen demand --out {tmp_path / 'd'} --device cpu" in out
    assert "runs list\n" in out  # takes no --device
    assert out.index("gen") < out.index("next")


def test_pipeline_dry_run_with_info(tmp_path):
    # tests/test_cli.py's dry run, whose dependent task is JAX's `info`.
    spec = _spec(tmp_path, [
        {"task_key": "gen", "argv": ["datagen", "demand", "--out", "{workdir}/d"]},
        {"task_key": "next", "argv": ["info"], "depends_on": ["gen"]},
    ])
    rc, out = _main(["pipeline", "--spec", spec, "--workdir", str(tmp_path), "--dry-run",
                     "--task-device", "cpu"])
    assert rc == 0
    assert str(tmp_path / "d") in out
    assert out.rstrip().endswith("info")  # takes no --device
    assert out.index("gen") < out.index("next")


def test_pipeline_runs_info_and_skips_it_after_a_failure(tmp_path):
    # tests/test_cli.py's failed-vs-skipped summary with `info` downstream,
    # and an `info` task that runs: its lines reach the runner's stdout.
    spec = _spec(tmp_path, [
        {"task_key": "topology", "argv": ["info"]},
        {"task_key": "bad", "argv": _BAD_BOM},
        {"task_key": "down", "argv": ["info"], "depends_on": ["bad"]},
    ], timeout_seconds=120)
    proc = _pipeline(spec, tmp_path, "--task-device", "cpu")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[topology] info\n" in proc.stdout and "[topology] ok (" in proc.stdout
    assert "process 0/1\ndevices 1 local / 1 global\n" in proc.stdout
    assert "[down] SKIPPED (failed dependency bad)" in proc.stdout
    assert "pipeline failed: bad (skipped: down)" in proc.stdout


def test_task_device_goes_to_the_commands_that_take_one():
    for argv, takes in ((["datagen", "demand"], True), (["datagen", "bom"], False),
                        (["datagen", "images"], False), (["forecast"], True), (["eda"], True),
                        (["train"], True), (["predict"], True), (["export"], True),
                        (["lm"], True), (["runs", "list"], False), (["pipeline"], False),
                        (["info"], False)):
        assert pl.takes_device(argv) is takes, argv


def test_pipeline_runs_tasks_and_skips_dependents_on_failure(tmp_path):
    spec = _spec(tmp_path, [
        {"task_key": "gen", "argv": ["datagen", "demand", "--out", "{workdir}/demand",
                                     "--skus-per-product", "1", "--years", "1"]},
        {"task_key": "bad", "argv": _BAD_BOM, "depends_on": ["gen"]},
        {"task_key": "downstream", "argv": ["datagen", "bom", "--demand", "{workdir}/demand",
                                            "--out", "{workdir}/b2", "--mapper-out",
                                            "{workdir}/m2"], "depends_on": ["bad"]},
    ], timeout_seconds=120)
    proc = _pipeline(spec, tmp_path, "--task-device", "cpu")
    assert proc.returncode == 1, proc.stdout
    assert (tmp_path / "demand" / "_delta_log").is_dir()
    assert "[gen] ok (" in proc.stdout and "[bad] FAILED (exit" in proc.stdout
    assert "[downstream] SKIPPED (failed dependency bad)" in proc.stdout
    assert not (tmp_path / "b2").exists()
    assert "pipeline failed: bad (skipped: downstream)" in proc.stdout


def test_pipeline_retries_until_success(tmp_path, monkeypatch):
    calls = []

    def flaky(cmd, timeout, env):
        calls.append(cmd)
        if len(calls) == 1:
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, 0 if len(calls) == 3 else 2)

    monkeypatch.setattr(pl.subprocess, "run", flaky)
    spec = _spec(tmp_path, [{"task_key": "flaky", "argv": ["runs", "list"], "max_retries": 2,
                             "timeout_seconds": 5}])
    rc, out = _main(["pipeline", "--spec", spec, "--workdir", str(tmp_path)])
    assert rc == 0 and len(calls) == 3
    assert calls[0][1:3] == ["-m", "dss_ml_at_scale_tpu_torch.config.cli"]
    assert "[flaky] TIMEOUT after 5s (attempt 1/3)" in out
    assert "[flaky] FAILED (exit 2" in out and "attempt 2/3" in out
    assert "[flaky] ok (" in out and out.strip().endswith("pipeline ok")


def test_pipeline_retries_are_exhausted_then_fail(tmp_path):
    spec = _spec(tmp_path, [{"task_key": "flaky", "argv": _BAD_BOM, "max_retries": 2},
                            {"task_key": "down", "argv": ["runs", "list"],
                             "depends_on": ["flaky"]}])
    proc = _pipeline(spec, tmp_path)
    assert proc.returncode == 1
    assert "attempt 1/3" in proc.stdout and "attempt 3/3" in proc.stdout
    assert "pipeline failed: flaky (skipped: down)" in proc.stdout


def _pipeline(spec, workdir, *extra, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), DSST_TRACKING_ROOT=str(Path(workdir) / "runs"),
               OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "pipeline", "--spec",
         str(spec), "--workdir", str(workdir), *extra],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=timeout)


def _read(path):
    return pa.concat_tables(pq.read_table(u) for u in DeltaTable(path).file_uris())


def _json_lines(text):
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def test_imagenet_train_spec_runs_on_the_cpu(tmp_path):
    proc = _pipeline(ROOT / "pipelines" / "imagenet_train.json", tmp_path, "--task-device",
                     "cpu", timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("pipeline ok")
    assert _read(tmp_path / "predictions").num_rows == 256
    train = next(j for j in _json_lines(proc.stdout) if "steps" in j)
    assert train["steps"] == 32 and 0.0 <= train["val_acc"] <= 1.0


def test_demand_forecasting_spec_runs_on_the_cpu_at_a_reduced_size(tmp_path):
    spec = json.loads((ROOT / "pipelines" / "demand_forecasting.json").read_text())
    small = {"generate_demand": ["--skus-per-product", "1", "--years", "1"],
             "fine_grained_forecasting": ["--max-p", "1", "--max-d", "1", "--max-q", "1",
                                          "--max-iter", "10", "--horizon", "10"]}
    for t in spec["tasks"]:
        t["argv"] = t["argv"] + small.get(t["task_key"], [])
    path = tmp_path / "demand_small.json"
    path.write_text(json.dumps(spec))
    proc = _pipeline(path, tmp_path, "--task-device", "cpu", timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("pipeline ok")
    assert _read(tmp_path / "part_level_demand").num_rows == 265
    assert _read(tmp_path / "sku_mapper").num_rows == 5
    assert _read(tmp_path / "bom").num_rows > 0
    fc = _read(tmp_path / "part_level_demand_with_forecasts")
    assert fc.num_rows == 265 and np.isfinite(fc.column("Demand_Fitted").to_numpy()).all()


def test_full_stack_spec_runs_on_the_cpu(tmp_path):
    proc = _pipeline(ROOT / "pipelines" / "full_stack.json", tmp_path, "--task-device", "cpu",
                     timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("pipeline ok")
    assert _read(tmp_path / "forecasts").num_rows == 265
    assert _read(tmp_path / "predictions").num_rows == 128
    assert (tmp_path / "weights.npz").stat().st_size > 0
    lines = _json_lines(proc.stdout)
    train = next(j for j in lines if "val_top2_acc" in j)
    assert 0.0 <= train["val_top2_acc"] <= 1.0
    lm = next(j for j in lines if "sample_mean_true_prob" in j)
    assert 0.0 < lm["sample_mean_true_prob"] <= 1.0 and lm["steps"] == 10
    assert lm["flash_launches"] == 0  # the CPU runs the plain version


def test_real_photos_spec_dry_runs(tmp_path):
    rc, out = _main(["pipeline", "--spec", str(ROOT / "pipelines" / "real_photos_train.json"),
                     "--workdir", str(tmp_path), "--dry-run"])
    assert rc == 0
    assert [ln.split()[0] for ln in out.strip().splitlines()] == [
        "gen_photos", "ingest", "train", "predict"]
