"""The port's ``info`` command and its ``--probe`` watchdog against the JAX
package's (``dss_ml_at_scale_tpu/config/cli.py::_cmd_info``).

- ``info`` prints JAX's three line shapes: ``process i/n``, ``devices L
  local / G global`` and one indented line per local device; on a host
  with no visible CUDA device, the device line is ``cpu``. JAX's side runs
  in a child on one CPU device (this session's conftest gives JAX eight).
- ``--probe``: a hung child returns 3 with the "accelerator unreachable"
  line (``tests/test_cli.py``'s twin); a real child's lines and rc come
  through; non-positive seconds exit 2 at parse time; the parent touches
  no CUDA state before it spawns the child.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dss_ml_at_scale_tpu_torch.config import cli

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (r"process \d+/\d+", r"devices \d+ local / \d+ global", r"  \S.*")


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT), **extra)
    return env


def _shapes(lines: list[str]) -> None:
    assert len(lines) >= 3, lines
    for line, shape in zip(lines[:2], SHAPES):
        assert re.fullmatch(shape, line), (line, shape)
    local = int(lines[1].split()[1])
    assert len(lines[2:]) == local, lines
    for line in lines[2:]:
        assert re.fullmatch(SHAPES[2], line), line


def test_info_prints_the_three_line_shapes_of_jax(capsys, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["info"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert port == ["process 0/1", "devices 1 local / 1 global", "  cpu"]
    jax = subprocess.run(
        [sys.executable, "-m", "dss_ml_at_scale_tpu.config.cli", "--platform", "cpu", "info"],
        env=_env(JAX_PLATFORMS="cpu"), cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert jax.returncode == 0, jax.stderr
    jax_lines = jax.stdout.splitlines()
    _shapes(jax_lines)
    _shapes(port)
    assert jax_lines[:2] == port[:2]


def test_info_in_process_on_jax_eight_devices_keeps_the_shapes(capsys):
    """JAX's ``info`` in this process (conftest's eight CPU devices): the
    same shapes, one device line per local device."""
    from dss_ml_at_scale_tpu.config.cli import main as jax_main

    assert jax_main(["info"]) == 0
    _shapes(capsys.readouterr().out.splitlines())


def test_info_names_the_card_the_process_drives(capsys, monkeypatch):
    """With a card: its index and name, the card of ``process_device``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: f"Card {torch.device(d).index}")
    assert cli.main(["info"]) == 0
    assert capsys.readouterr().out.splitlines()[2] == "  cuda:0 (Card 0)"


def test_info_probe_reports_instead_of_hanging(capsys, monkeypatch):
    def fake_run(*a, **kw):
        raise subprocess.TimeoutExpired(cmd=a[0], timeout=kw["timeout"])

    monkeypatch.setattr(subprocess, "run", fake_run)
    rc = cli.main(["info", "--probe", "0.5"])
    out = capsys.readouterr().out
    assert rc == 3 and "unreachable" in out and "0.5s" in out
    assert out.startswith("accelerator unreachable: device query did not return within 0.5s")


def test_info_probe_passes_a_real_childs_lines_and_rc(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # the child finds the package through PYTHONPATH
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert cli.main(["info", "--probe", "120"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "process 0/1", "devices 1 local / 1 global", "  cpu"]


def test_info_probe_passes_the_childs_rc_and_stderr(capsys, monkeypatch):
    def fake_run(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 7, "process 0/1\n", "boom\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert cli.main(["info", "--probe", "5"]) == 7
    out, err = capsys.readouterr()
    assert out == "process 0/1\n" and err == "boom\n"


@pytest.mark.parametrize("seconds", ["0", "-1"])
def test_info_probe_rejects_non_positive_seconds_at_parse_time(seconds, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["info", "--probe", seconds])
    assert exc.value.code == 2
    assert "must be a positive number of seconds" in capsys.readouterr().err


def test_info_probe_parent_touches_no_cuda(monkeypatch):
    """The parent spawns the child before any CUDA call: every entry of
    torch.cuda that would query or initialize the driver raises here."""
    seen = []

    def fake_run(cmd, **kw):
        seen.append((cmd, kw["timeout"], kw["env"]["PYTHONPATH"].split(os.pathsep)[0]))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    def touched(*a, **kw):
        raise AssertionError("the --probe parent touched CUDA")

    monkeypatch.setattr(subprocess, "run", fake_run)
    for name in ("is_available", "device_count", "get_device_name", "init", "_lazy_init",
                 "current_device", "set_device"):
        monkeypatch.setattr(torch.cuda, name, touched)
    assert cli.main(["info", "--probe", "30"]) == 0
    assert not torch.cuda.is_initialized()
    (cmd, timeout, path0), = seen
    assert cmd == [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "info"]
    assert timeout == 30.0 and path0 == str(ROOT)
