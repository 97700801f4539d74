"""A short run of a cell on the card, through the benchmark's command (marked
``cuda``: it skips where there is no card; run it with
``python3 -m pytest --noconftest -m cuda portbench/tests -q``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels and the benchmark run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, trace):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "vit_s16.train_b212", "--seed", "4000000001", "--seconds", "3",
                          "--trace", str(trace)], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=360, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    cell = spec.load_cell("vit_s16.train_b212")
    names = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    assert sorted(result["metrics"]) == sorted(names)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert out.stderr.strip().splitlines()[-1] == "correct: True"
