"""The port stands alone: no JAX, no flax, no module of the JAX package.

Under pytest ``tests/conftest.py`` imports jax first, so the runtime check
runs in a fresh subprocess: it imports every module of the port, serves one
generation over HTTP on the CPU through the real model, writes a 16-row
image table and trains the pallas-level ``tiny-bottleneck`` on it through
the port's ``train`` entry (crop 32, on the CPU), and then lists what got
loaded. The static scan reads every source file of the port (and
``chip_smoke.py``) for imports of the same.
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
    assert cli.main(["train", "--data", work + "/t", "--model", "tiny-bottleneck",
                     "--pallas-fused", "--batch-size", "8", "--crop", "32",
                     "--num-classes", "4", "--epochs", "1", "--device", "cpu"]) == 0
train = json.loads(out.getvalue().strip().splitlines()[-1])
print(json.dumps({"done": lines[-1], "train": train, "modules": sorted(sys.modules)}))
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
    assert report["train"]["train_loss"] > 0
    loaded = [m for m in report["modules"] if _forbidden(m)]
    assert loaded == []
    assert "dss_ml_at_scale_tpu_torch.ops.flash_attention" in report["modules"]
    assert "dss_ml_at_scale_tpu_torch.ops.fused_matmul" in report["modules"]


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "compare_torch_kernels.py",
                                         ROOT / "scripts" / "profile_torch_lm.py",
                                         ROOT / "scripts" / "profile_torch_train.py",
                                         ROOT / "scripts" / "resnet_grad_sensitivity.py"]


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
