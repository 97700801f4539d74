"""The port's session-wide ``DSST_SANITIZE=1`` pytest mode
(``analysis/sanitize/pytest_plugin.py``), the counterpart of the session
mode in ``tests/conftest.py``.

Each case runs a pytest child over a small test file written to
``tmp_path``, with ``-p dss_ml_at_scale_tpu_torch.analysis.sanitize.pytest_plugin``
and no conftest, under a timeout:

- a hazard of ``tests/fixtures/sanitize/lock_order_positive.py`` (an AB/BA
  lock-order cycle) seeded from a copy outside ``tests/fixtures/sanitize/``:
  every test passes, the report is printed and the session exits 1;
- the same hazard loaded from ``tests/fixtures/sanitize/`` itself: exit 0
  (the session gate drops the fixtures' own findings);
- a clean session (the fixture's negative twin, copied outside): exit 0;
- without ``DSST_SANITIZE``: the hazard passes at exit 0 with no report and
  no scope armed.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "sanitize"
PLUGIN = "dss_ml_at_scale_tpu_torch.analysis.sanitize.pytest_plugin"
HEADER = "=== dsst sanitize (DSST_SANITIZE=1 session) ==="

_TEST = '''
import importlib.util
import os
import sys

from dss_ml_at_scale_tpu_torch.analysis.sanitize import is_armed, sanitize_scope


def test_session_scope():
    assert is_armed() == bool(os.environ.get("DSST_SANITIZE"))


def test_seeded_hazard():
    spec = importlib.util.spec_from_file_location("sanfix_session", {path!r})
    mod = importlib.util.module_from_spec(spec)
    sys.modules["sanfix_session"] = mod
    spec.loader.exec_module(mod)
    with sanitize_scope(extra_prefixes=("sanfix_",)):
        mod.run()
'''


def _session(tmp_path: Path, hazard: Path, sanitize: bool) -> subprocess.CompletedProcess:
    test = tmp_path / "test_session_hazard.py"
    test.write_text(_TEST.format(path=str(hazard)))
    env = {k: v for k, v in os.environ.items() if k not in ("DSST_SANITIZE", "PYTHONPATH")}
    env.update(PYTHONPATH=str(ROOT), PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    if sanitize:
        env["DSST_SANITIZE"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
         "-p", PLUGIN, "--rootdir", str(tmp_path), str(test)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)


def _copy(tmp_path: Path, name: str) -> Path:
    out = tmp_path / "hazards" / f"{name}.py"
    out.parent.mkdir(exist_ok=True)
    out.write_text((FIXTURES / f"{name}.py").read_text())
    return out


def test_unbaselined_finding_fails_a_passing_session(tmp_path):
    proc = _session(tmp_path, _copy(tmp_path, "lock_order_positive"), sanitize=True)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "2 passed" in proc.stdout and "failed" not in proc.stdout, out
    assert HEADER in proc.stdout, out
    report = proc.stdout.split(HEADER, 1)[1]
    assert "lock_order_positive.py" in report and "[lock-order]" in report, report
    assert "1 finding(s)" in report and "<pytest session>" in report, report


def test_fixture_hazards_are_excluded(tmp_path):
    proc = _session(tmp_path, FIXTURES / "lock_order_positive.py", sanitize=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 passed" in proc.stdout and HEADER not in proc.stdout


def test_clean_session_passes(tmp_path):
    proc = _session(tmp_path, _copy(tmp_path, "lock_order_negative"), sanitize=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 passed" in proc.stdout and HEADER not in proc.stdout


def test_without_the_variable_the_plugin_does_nothing(tmp_path):
    proc = _session(tmp_path, _copy(tmp_path, "lock_order_positive"), sanitize=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 passed" in proc.stdout and HEADER not in proc.stdout


def test_plugin_disarmed_in_process(monkeypatch):
    """In this process, without the variable: configure arms nothing and
    sessionfinish leaves the exit status alone."""
    import types

    import pytest

    from dss_ml_at_scale_tpu_torch.analysis.sanitize import is_armed
    from dss_ml_at_scale_tpu_torch.analysis.sanitize import pytest_plugin as plugin

    monkeypatch.delenv("DSST_SANITIZE", raising=False)
    config = types.SimpleNamespace(stash=pytest.Stash())
    armed = is_armed()
    plugin.pytest_configure(config)
    assert is_armed() == armed and plugin._ARMED not in config.stash
    session = types.SimpleNamespace(config=config, exitstatus=0)
    plugin.pytest_sessionfinish(session, 0)
    assert session.exitstatus == 0
