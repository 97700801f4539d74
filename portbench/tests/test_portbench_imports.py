"""No module the runner reaches has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``dss_ml_at_scale_tpu`` (compared whole: the port's name
begins with the JAX package's), and the references import nothing of the
port."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dss_ml_at_scale_tpu"}
PORT = "dss_ml_at_scale_tpu_torch"


def _imported_tops(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_file_names_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        assert not (_imported_tops(path) & FORBIDDEN), path


def test_references_import_nothing_of_the_port():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert PORT not in _imported_tops(path), path


def test_a_run_loads_no_forbidden_module():
    """A tiny run of every configuration on the CPU, in a fresh process
    without this test process's imports: what the port loads counts too."""
    code = """
import json, sys
from portbench import run, spec
from portbench.tests.tiny import tiny_cell
for name in ("resnet50.train_b212", "vit_s16.train_b212"):
    for m in spec.load_cell(name).per_layer:
        spec.load_module("metrics", m["name"])
    run.run_cell(tiny_cell(name), 3, 0.1, True, device="cpu", log=lambda *a, **k: None)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in tops
    assert not (tops & FORBIDDEN)


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "resnet50.train_b212", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dss_ml_at_scale_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert run.forbidden_modules() == ["jaxlib.fake"]



def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "resnet50.train_b212", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
