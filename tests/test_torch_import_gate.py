"""The port stands alone: no JAX, no flax, no module of the JAX package.

Under pytest ``tests/conftest.py`` imports jax first, so the runtime check
runs in a fresh subprocess: it imports every module of the port, serves one
generation over HTTP on the CPU through the real model, writes a 16-row
image table and trains the pallas-level ``tiny-bottleneck`` on it through
the port's ``train`` entry (crop 32, on the CPU, supervised: a fault plan
poisons one step, which is discarded and its rows quarantined, and the
run is journaled in a run store), serves one JPEG from that checkpoint
through the image server, takes one ``vit-tiny`` train step, one LM train step
through the ``lm`` entry with a checkpoint and one more after restoring it
(``--resume``), generates a demand table and forecasts it (``datagen
demand`` and ``forecast`` on the CPU, by the grid and by TPE), runs a tiny
``eda`` and a ``pipeline --dry-run``, writes a photo tree and ingests it,
writes a regression ``.npz``, runs ``hpo`` on the CPU (closure and shared
filesystem) and two trials through an in-process trial worker over RPC,
runs one CPU ``chaos`` cycle, ``trace tail`` on its killed run and ``slo
status --report`` on a saved SLO document, runs ``lint --json`` and ``audit
--device cpu --entrypoints train_step.lm --json``, runs ``info`` and ``info
--probe``, imports the session sanitizer's pytest plugin (with every other
module, the ``bench`` modules among them), runs ``bench --list-scenarios``
and one scenario of ``bench`` in process, and then lists what got loaded (scikit-learn must not be among it). A second check runs one
data-parallel ``train`` step in two processes (gloo on the CPU, meeting at
a ``file://`` rendezvous), each of which lists what it loaded. The static
scan reads every source file of the port (``runtime/`` and ``native/``
among them) and ``chip_smoke.py`` for imports of the same.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dss_ml_at_scale_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")

_CHILD = r"""
import contextlib, http.client, io, json, pkgutil, importlib, sys, tempfile
import dss_ml_at_scale_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import torch
from dss_ml_at_scale_tpu_torch.models import seeded_lm
from dss_ml_at_scale_tpu_torch.serving.lm import LMConfig, LMEngine, TransformerDecoder
from dss_ml_at_scale_tpu_torch.workloads.serving import serve_lm_in_thread

model = seeded_lm(0, device="cpu", vocab_size=64, dim=32, num_heads=2,
                  num_layers=1, max_seq=32, attention="flash",
                  dtype=torch.float32)
engine = LMEngine(TransformerDecoder(model, slots=2, max_len=32, buckets=(8,)),
                  LMConfig(slots=2, max_len=32, prefill_buckets=(8,))).start()
with serve_lm_in_thread(engine) as handle:
    conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=60)
    conn.request("POST", "/generate",
                 json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 4}).encode(),
                 {"Content-Type": "application/json"})
    lines = [json.loads(l) for l in conn.getresponse().read().splitlines() if l]
    conn.close()
from dss_ml_at_scale_tpu_torch.config import cli
work = tempfile.mkdtemp()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["datagen", "images", "--out", work + "/t", "--n", "16",
                     "--classes", "4", "--size", "32"]) == 0
    assert cli.main(["--fault-plan", "grads.nonfinite=1@1", "train", "--data", work + "/t",
                     "--model", "tiny-bottleneck", "--pallas-fused", "--batch-size", "8",
                     "--crop", "32", "--num-classes", "4", "--epochs", "1", "--device", "cpu",
                     "--health-policy", "skip", "--checkpoint-dir", work + "/tck"]) == 0
train = json.loads(out.getvalue().strip().splitlines()[-1])
from dss_ml_at_scale_tpu_torch.workloads.serving import Predictor, serve_in_thread
import pyarrow.parquet as pq
from dss_ml_at_scale_tpu_torch.data import DeltaTable
jpeg = pq.read_table(DeltaTable(work + "/t").file_uris()[0]).column("content")[0].as_py()
with serve_in_thread(Predictor(work + "/tck", micro_batch=4, device="cpu")) as handle:
    conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=60)
    conn.request("POST", "/predict", jpeg, {"Content-Type": "image/jpeg"})
    predicted = json.loads(conn.getresponse().read())
    conn.close()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["train", "--data", work + "/t", "--model", "vit-tiny", "--batch-size", "16",
                     "--crop", "32", "--num-classes", "4", "--epochs", "1", "--device", "cpu",
                     "--no-tracking"]) == 0
vit = json.loads(out.getvalue().strip().splitlines()[-1])
lm = []
for epochs, extra in (("1", []), ("2", ["--resume"])):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["lm", "--vocab", "32", "--dim", "32", "--heads", "2", "--layers", "1",
                         "--seq", "16", "--batch-size", "2", "--steps-per-epoch", "1",
                         "--limit-val-batches", "1", "--device", "cpu", "--epochs", epochs,
                         "--checkpoint-dir", work + "/ck", *extra]) == 0
    lm.append(json.loads(out.getvalue().strip().splitlines()[-1]))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["lm", "--vocab", "32", "--dim", "32", "--heads", "2", "--layers", "1",
                     "--seq", "16", "--batch-size", "2", "--steps-per-epoch", "1",
                     "--limit-val-batches", "1", "--device", "cpu", "--epochs", "1",
                     "--ffn", "moe", "--num-experts", "4", "--no-tracking"]) == 0
lm.append(json.loads(out.getvalue().strip().splitlines()[-1]))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["datagen", "demand", "--out", work + "/d", "--skus-per-product", "1",
                     "--years", "1", "--seed", "2", "--device", "cpu"]) == 0
    assert cli.main(["forecast", "--data", work + "/d", "--out", work + "/f", "--max-p", "0",
                     "--max-d", "1", "--max-q", "0", "--max-iter", "3", "--horizon", "10",
                     "--device", "cpu", "--no-tracking"]) == 0
forecast = out.getvalue().strip().splitlines()[-1]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["forecast", "--data", work + "/d", "--out", work + "/ft", "--search", "tpe",
                     "--max-evals", "2", "--max-p", "1", "--max-d", "0", "--max-q", "0",
                     "--max-iter", "3", "--horizon", "10", "--device", "cpu",
                     "--no-tracking"]) == 0
tpe = out.getvalue().strip().splitlines()[-1]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["eda", "--data", work + "/d", "--horizon", "13", "--seasonal-periods", "13",
                     "--max-evals", "1", "--parallelism", "1", "--max-iter", "3",
                     "--device", "cpu", "--no-tracking"]) == 0
eda = out.getvalue().strip().splitlines()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["pipeline", "--spec", "pipelines/full_stack.json", "--workdir", work,
                     "--dry-run", "--task-device", "cpu"]) == 0
plan = out.getvalue().strip().splitlines()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["datagen", "photos", "--out", work + "/raw", "--n", "8", "--size", "48"]) == 0
    assert cli.main(["ingest", "--data-root", work + "/raw", "--out", work + "/pt"]) == 0
    assert cli.main(["datagen", "regression", "--bytes", "50000", "--out", work + "/r.npz"]) == 0
    assert cli.main(["hpo", "--bytes", "50000", "--max-evals", "2", "--device", "cpu",
                     "--no-tracking"]) == 0
    assert cli.main(["hpo", "--data", work + "/r.npz", "--max-evals", "2", "--device", "cpu",
                     "--no-tracking"]) == 0
track = out.getvalue().strip().splitlines()
from dss_ml_at_scale_tpu_torch.hpo import fmin, hp
from dss_ml_at_scale_tpu_torch.parallel.trials import HostTrials, serve_trial_worker
server = serve_trial_worker(block=False)
try:
    trials = HostTrials([f"{server.address[0]}:{server.address[1]}"], rpc_timeout=60.0)
    fmin("dss_ml_at_scale_tpu_torch.hpo.objectives:lasso_shared",
         {"alpha": hp.uniform("alpha", 0.0, 10.0),
          "data_path": hp.choice("data_path", [work + "/r.npz"])},
         max_evals=2, trials=trials, rstate=0)
finally:
    server.shutdown()
remote = [t["result"]["status"] for t in trials.trials]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["chaos", "--workdir", work + "/chaos", "--cycles", "1", "--epochs", "1",
                     "--kill-max", "2.0", "--timeout", "120", "--device", "cpu",
                     "--json"]) in (0, 1)
chaos = json.loads(out.getvalue().strip().splitlines()[-1])
import glob, os
from dss_ml_at_scale_tpu_torch import telemetry
with open(work + "/slo.json", "w") as f:
    json.dump(telemetry.slo.get_engine().render_status(), f)
ops = []
for argv in (["trace", "tail", "--json", "--run",
              min(glob.glob(work + "/chaos/runs/chaos/*"), key=os.path.getmtime)],
             ["slo", "status", "--report", work + "/slo.json", "--json"]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    ops.append(out.getvalue())
analysis = []
for argv in (["lint", "--json"],
             ["audit", "--device", "cpu", "--entrypoints", "train_step.lm", "--json"]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    analysis.append({"rc": rc, "report": json.loads(out.getvalue())})
info = []
for argv in (["info"], ["info", "--probe", "120"]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    info.append({"rc": rc, "out": out.getvalue()})
bench = []
for argv in (["bench", "--list-scenarios"],
             ["bench", "--scenarios", "slo_overhead", "--in-process", "--repetitions", "1",
              "--device", "cpu", "--json"]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    bench.append({"rc": rc, "out": out.getvalue()})
print(json.dumps({"done": lines[-1], "analysis": analysis, "info": info, "bench": bench, "train": train, "lm": lm, "forecast": forecast,
                  "tpe": tpe, "eda": eda, "plan": plan, "track": track, "remote": remote,
                  "predicted": predicted, "vit": vit, "chaos": chaos, "ops": ops,
                  "modules": sorted(sys.modules)}))
"""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return (top in FORBIDDEN or name == "dss_ml_at_scale_tpu"
            or name.startswith("dss_ml_at_scale_tpu."))


def test_port_serves_a_generation_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["done"]["done"] == "max_tokens"
    assert report["done"]["tokens"] == 4
    assert report["train"]["steps"] == 2 and report["train"]["device"] == "cpu"
    # The supervised step discarded the poisoned update and quarantined its rows.
    assert report["train"]["skipped_steps"] == 1 and report["train"]["quarantined"] == 1
    assert report["train"]["train_loss"] > 0
    assert [r["steps"] for r in report["lm"]] == [1, 2, 1]  # the last: --ffn moe
    assert report["forecast"].startswith("forecast: 5 groups, 265 rows, mse ")
    assert report["tpe"].startswith("forecast: 5 groups, 265 rows, mse ")
    assert report["eda"][0].startswith("EDA for Product=")
    assert sum(ln.strip().startswith(("hw_", "sarimax")) for ln in report["eda"]) == 7
    assert [ln.split()[0] for ln in report["plan"]] == [
        "gen_demand", "gen_images", "train_lm_and_sample", "forecast", "train_classifier",
        "predict", "export_weights"]
    assert report["lm"][1]["best_checkpoint"] is not None
    (pred,) = report["predicted"]["predictions"]  # the image server scored one JPEG
    assert 0 <= pred["pred_index"] < 4 and 0 < pred["pred_prob"] <= 1
    assert report["vit"]["steps"] == 1 and report["vit"]["train_loss"] > 0
    assert report["track"][0].startswith("photos: 8 real-photo JPEG crops")
    assert report["track"][1].startswith("ingested 8 rows")
    assert report["track"][2].startswith("regression: ")
    assert [ln.split(":")[0] for ln in report["track"][3:]] == ["hpo (closure)",
                                                                 "hpo (shared-fs)"]
    assert report["remote"] == ["ok", "ok"]
    # A CPU chaos cycle (the fs kill inside the save window), the killed
    # run's tail, and an SLO document judged from a file.
    assert report["chaos"]["workload"] == "train" and report["chaos"]["device"] == "cpu"
    assert report["chaos"]["invariants"]["params_bitwise_equal"]["ok"]
    assert report["chaos"]["invariants"]["save_window_kill"]["ok"]
    tail = [json.loads(ln) for ln in report["ops"][0].splitlines()]
    assert any(r.get("open") and r["name"] in ("fit", "checkpoint", "checkpoint.finalize")
               for r in tail)
    assert json.loads(report["ops"][1])["version"] == 1
    # The analysis tiers run without JAX: lint over the port, and the audit
    # of one entrypoint on the CPU (on torch's fake process group).
    lint, audit = report["analysis"]
    assert lint["rc"] == 0 and lint["report"]["ok"] and len(lint["report"]["rules"]) == 12
    assert audit["rc"] == 0 and audit["report"]["entrypoints"] == ["train_step.lm"]
    assert audit["report"]["device"] == "cpu"
    # `info` in process and through its --probe child.
    for run in report["info"]:
        assert run["rc"] == 0, run
        assert run["out"].splitlines()[:2] == ["process 0/1", "devices 1 local / 1 global"]
    # `bench`: the registry listed, one scenario measured in process.
    listing, run = report["bench"]
    assert listing["rc"] == 0 and len(listing["out"].splitlines()) == 11
    assert run["rc"] == 0 and json.loads(run["out"])["results"]["slo_overhead"]["completed"] == 1
    loaded = [m for m in report["modules"] if _forbidden(m) or m.split(".")[0] == "sklearn"]
    assert loaded == []
    assert "dss_ml_at_scale_tpu_torch.ops.flash_attention" in report["modules"]
    assert "dss_ml_at_scale_tpu_torch.ops.fused_matmul" in report["modules"]
    for name in ("resilience.checkpoint", "resilience.health", "resilience.faults",
                 "resilience.preemption", "tracking.store", "ops.sarimax", "ops.kalman",
                 "ops.neldermead", "ops.bfgs", "ops.arma", "datagen.demand",
                 "parallel.group_apply", "workloads.forecasting", "models.moe",
                 "parallel.ring", "parallel.pipeline", "models.pipelined_lm",
                 "models.vit", "serving.scheduler", "serving.batcher",
                 "config.checkpoints", "workloads.serving", "hpo.tpe", "hpo.fmin",
                 "hpo.space", "parallel.trials", "ops.holt_winters", "workloads.eda",
                 "config.pipeline", "ingest.imagenet", "datagen.photos", "datagen.regression",
                 "hpo.shipping", "hpo.objectives", "runtime.rpc", "resilience.workers",
                 "telemetry.export", "resilience.chaos", "telemetry.flightrec",
                 "telemetry.federation", "telemetry.device", "telemetry.catalog",
                 "config.observe", "config.analysis", "analysis.core",
                 "analysis.checkers.host_sync", "analysis.sanitize.runtime",
                 "analysis.sanitize.workloads", "analysis.audit.core",
                 "analysis.audit.entrypoints", "analysis.audit.rules",
                 "analysis.sanitize.pytest_plugin", "bench.core", "bench.stats",
                 "bench.scenarios", "bench.loadgen", "bench.mfu", "bench.profile",
                 "bench.__main__", "utils.benchlib"):
        assert f"dss_ml_at_scale_tpu_torch.{name}" in report["modules"]


_RANK = r"""
import contextlib, io, json, os, sys
from dss_ml_at_scale_tpu_torch.config import cli
work, rank = sys.argv[1], sys.argv[2]
os.environ.update(NUM_PROCESSES="2", PROCESS_ID=rank)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["train", "--data", work + "/t", "--model", "tiny-bottleneck",
                     "--pallas-fused", "--batch-size", "4", "--crop", "32",
                     "--num-classes", "4", "--epochs", "1", "--device", "cpu",
                     "--workers", "1", "--coordinator", "file://" + work + "/rdzv"]) == 0
summary = json.loads(out.getvalue().strip().splitlines()[-1])
print(json.dumps({"train": summary, "modules": sorted(sys.modules)}))
"""


def test_two_rank_train_step_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "COORDINATOR_ADDRESS")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"
    # Four files of four rows: each process reads its own files.
    gen = subprocess.run(
        [sys.executable, "-c", "import sys; from dss_ml_at_scale_tpu_torch.datagen import "
         "write_image_delta; write_image_delta(sys.argv[1], 16, classes=4, size=32, "
         "max_rows_per_file=4)", str(tmp_path / "t")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert gen.returncode == 0, gen.stderr
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp_path), str(r)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        reports.append(json.loads(out.strip().splitlines()[-1]))
    for rank, report in enumerate(reports):
        # 16 rows, 4 per process and step, 2 processes: two steps.
        assert report["train"]["steps"] == 2
        assert report["train"]["process_index"] == rank
        assert report["train"]["process_count"] == 2
        assert [m for m in report["modules"] if _forbidden(m)] == []
        assert "dss_ml_at_scale_tpu_torch.runtime.distributed" in report["modules"]
    assert reports[0]["train"]["train_loss"] == reports[1]["train"]["train_loss"]


def test_static_scan_covers_runtime_and_native():
    names = {str(p.relative_to(PORT)) for p in _sources() if PORT in p.parents}
    assert {"runtime/distributed.py", "runtime/topology.py", "native/__init__.py",
            "data/augment.py", "models/pretrained.py", "resilience/faults.py",
            "resilience/retry.py", "resilience/durability.py", "resilience/rollback.py",
            "resilience/health.py", "resilience/preemption.py", "tracking/store.py",
            "ops/kalman.py", "ops/arma.py", "ops/neldermead.py", "ops/bfgs.py",
            "ops/sarimax.py", "datagen/demand.py", "parallel/group_apply.py",
            "workloads/forecasting.py", "models/moe.py", "parallel/ring.py",
            "parallel/pipeline.py", "models/pipelined_lm.py", "hpo/__init__.py",
            "hpo/space.py", "hpo/hp.py", "hpo/tpe.py", "hpo/fmin.py", "parallel/trials.py",
            "ops/holt_winters.py", "ops/polish.py", "workloads/eda.py", "datagen/bom.py",
            "config/pipeline.py", "config/observe.py", "resilience/chaos.py",
            "telemetry/flightrec.py", "telemetry/federation.py", "telemetry/device.py",
            "telemetry/catalog.py", "telemetry/export.py", "config/analysis.py",
            "analysis/core.py", "analysis/astutil.py", "analysis/checkers/trace_safety.py",
            "analysis/checkers/retrace_hazard.py", "analysis/sanitize/runtime.py",
            "analysis/sanitize/report.py", "analysis/audit/core.py",
            "analysis/audit/entrypoints.py"} <= names


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "compare_torch_kernels.py",
                                         ROOT / "scripts" / "profile_torch_lm.py",
                                         ROOT / "scripts" / "profile_torch_train.py",
                                         ROOT / "scripts" / "resnet_grad_sensitivity.py",
                                         ROOT / "scripts" / "lm_curve_torch.py",
                                         ROOT / "scripts" / "profile_torch_groupfit.py",
                                         ROOT / "scripts" / "golden_fit_sweep_torch.py",
                                         ROOT / "scripts" / "real_photos_spread.py",
                                         ROOT / "scripts" / "analysis_tiers_probe.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
