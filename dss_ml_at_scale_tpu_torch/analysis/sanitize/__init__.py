"""Runtime thread sanitizer — the third analysis tier (``sanitize``).

Port of ``dss_ml_at_scale_tpu/analysis/sanitize/``, pointed at the port's
threads. The static tiers check ``with self._lock`` blocks syntactically
(``lint``) and the traced programs (``audit``); neither can see what
happens when the port's thread families (the feeder and its side stream,
the serving batcher and decode pool, the HPO worker pool's heartbeats, the
run journal, the trace handoffs) run together. This package closes the
loop TSan-style, in process:

- **Lock interposition** (:mod:`.runtime`): while armed,
  ``threading.Lock/RLock/Condition/Thread`` *creation from the port's own
  modules* returns instrumented objects. Per-thread held-lock sets feed a
  global lock-acquisition-order graph; cycles are reported as potential
  deadlocks with the acquisition stacks of every edge — even when no
  deadlock fires in the run. torch's own locks and threads, and the CUDA
  caching allocator's, stay raw.
- **Dynamic guarded-by enforcement**: classes declaring
  ``_guarded_by_lock`` (the contract the lint rule checks statically) get
  their guarded attributes checked on every read/write — an access off
  the declaring lock while another live thread is (or has been) inside
  that lock is a finding carrying the offending stack and the lock's
  current holder.
- **Scope-exit checks**: threads created inside a sanitize scope that are
  still alive at its end (unjoined), and instrumented locks still held
  (leaked), are findings.

Disarmed, nothing is patched: the declaring classes get plain
``threading`` objects and guarded attributes stay ordinary slots/dict
entries — zero overhead on the hot path.

Findings render through the same text/JSON + mandatory-reason suppression
+ content-addressed baseline idioms as ``lint``
(:data:`DEFAULT_SANITIZE_BASELINE`, the port's
``analysis/baselines/sanitize.json``); suppressions are ordinary ``# dsst:
ignore[rule] reason`` comments on the offending source line.
"""

from __future__ import annotations

from .report import (  # noqa: F401
    DEFAULT_SANITIZE_BASELINE,
    RULES,
    SanitizeResult,
    SanitizeUsageError,
    build_result,
)
from .runtime import (  # noqa: F401
    SanitizeScope,
    is_armed,
    sanitize_scope,
)
from .workloads import (  # noqa: F401
    run_workloads,
    workload_catalog,
    workload_names,
)

_OBSERVATION: tuple | None = None


def arm_observation_mode() -> None:
    """``DSST_SANITIZE=1`` on any command of the port's CLI: arm
    instrumentation for the whole process and report findings to stderr
    at exit.

    Observation, not a gate — the exit code is untouched, so a chaos soak
    (whose children inherit the environment) or a production run can ride
    with the sanitizer armed without changing its pass/fail semantics.
    ``sanitize`` is the gating face.
    """
    global _OBSERVATION
    if _OBSERVATION is not None:
        return
    import atexit

    cm = sanitize_scope()
    scope = cm.__enter__()
    _OBSERVATION = (cm, scope)
    atexit.register(_report_observation)


def _report_observation() -> None:
    global _OBSERVATION
    if _OBSERVATION is None:
        return
    cm, scope = _OBSERVATION
    _OBSERVATION = None
    try:
        cm.__exit__(None, None, None)
    except Exception:  # disarm must never mask the command's own exit
        return
    import sys

    res = build_result(scope, ["<env-armed process>"], full_run=False)
    if res.findings:
        sys.stderr.write(
            "sanitize (DSST_SANITIZE=1 observation mode):\n"
            + res.render_text() + "\n"
        )
