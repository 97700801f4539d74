"""Trial-worker subprocesses of the port's CLI for the tests: started, their
announced address read within a bound, and stopped."""

import os
import select
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli"]


def start_worker(*extra: str, env: dict | None = None, timeout: float = 60.0):
    """A ``trial-worker`` process and its ``host:port``; the first stdout
    line must arrive within ``timeout`` seconds."""
    proc = subprocess.Popen(CLI + ["trial-worker", *extra], stdout=subprocess.PIPE, text=True,
                            cwd=REPO, env={**os.environ, **(env or {})})
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    if not ready:
        stop(proc)
        raise TimeoutError(f"trial-worker printed no address within {timeout} s")
    line = proc.stdout.readline()
    if "listening on" not in line:
        stop(proc)
        raise RuntimeError(f"trial-worker did not start: {line!r}")
    return proc, line.strip().rsplit(" ", 1)[-1]


def stop(proc, timeout: float = 10.0) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=timeout)
    if proc.stdout is not None:
        proc.stdout.close()
