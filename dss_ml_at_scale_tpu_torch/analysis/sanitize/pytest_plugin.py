"""``DSST_SANITIZE=1`` for a whole pytest session, as a plugin module.

Port of the session mode of the JAX package's ``tests/conftest.py``. Load it
with ``-p dss_ml_at_scale_tpu_torch.analysis.sanitize.pytest_plugin``:

    DSST_SANITIZE=1 python -m pytest tests/test_torch_*.py \\
        -p dss_ml_at_scale_tpu_torch.analysis.sanitize.pytest_plugin

With ``DSST_SANITIZE`` set, the runtime thread sanitizer is armed from
``pytest_configure`` to ``pytest_sessionfinish``: every lock and thread the
port creates during the session is instrumented, and a finding that the
port's sanitize baseline does not hold turns a passing session's exit
status into 1. Findings whose path lies under ``tests/fixtures/sanitize/``
are dropped: the suite seeds those hazards on purpose, and the session
gate judges the port's code. Without the variable the plugin does nothing.
The scope is opt-in (it adds bookkeeping to every instrumented acquire);
the always-on coverage is ``tests/test_torch_sanitize.py``'s gate.
"""

from __future__ import annotations

import os
import sys

import pytest

# Imported with the plugin, before any test module or conftest can patch
# ``threading``: the runtime keeps the real factories it finds at import.
from . import build_result, sanitize_scope

FIXTURE_DIR = "tests/fixtures/sanitize/"

# The session's armed scope: (its context manager, the scope it entered).
_ARMED = pytest.StashKey[tuple]()


def pytest_configure(config) -> None:
    if not os.environ.get("DSST_SANITIZE"):
        return
    cm = sanitize_scope()
    config.stash[_ARMED] = (cm, cm.__enter__())


def pytest_sessionfinish(session, exitstatus) -> None:
    armed = session.config.stash.get(_ARMED, None)
    if armed is None:
        return
    del session.config.stash[_ARMED]
    cm, scope = armed
    cm.__exit__(None, None, None)
    res = build_result(scope, ["<pytest session>"], full_run=False)
    res.findings = [f for f in res.findings if FIXTURE_DIR not in f.path]
    if not res.findings:
        return
    sys.stdout.write("\n=== dsst sanitize (DSST_SANITIZE=1 session) ===\n"
                     + res.render_text() + "\n")
    if session.exitstatus == 0:
        session.exitstatus = 1
