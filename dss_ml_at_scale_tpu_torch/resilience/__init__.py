"""Fault-tolerance layer of the port (``dss_ml_at_scale_tpu/resilience``):

- :mod:`.faults`: deterministic fault injection at named sites, armed by a
  seeded :class:`FaultPlan`; a no-op when disarmed.
- :mod:`.retry`: exponential backoff with full jitter and a deadline, and
  the classifier of transient failures.
- :mod:`.checkpoint`: per-step content-checksum manifests, verified at
  restore so a torn latest step falls back to the newest intact one.
- :mod:`.durability`: crash-only publishes (tmp, fsync, rename, fsync the
  directory), with ``fs.*`` fault sites that tear each stage.
- :mod:`.rollback`: per-batch row provenance and the JSONL quarantine
  blocklist the reader consults.
- :mod:`.health`: the supervised step (discard a bad update before it
  commits) and the skip → rollback → abort policy ladder.
- :mod:`.preemption`: SIGTERM turned into a flag the training loop polls.
- :mod:`.workers`: the HPO worker pool (drop, cool-down, heartbeat
  re-admission).

Not ported: the JAX package's chaos soak (``chaos.py``).
"""

from .checkpoint import MANIFEST_NAME, verify_checkpoint_dir, verify_step, write_manifest  # noqa: F401
from .durability import append_jsonl, durable_replace, durable_write_bytes, durable_write_json, durable_write_text, fsync_dir, sweep_stranded_tmp  # noqa: F401
from .faults import KNOWN_SITES, FaultPlan, InjectedFault, active_plan, clear, fault_fires, install, install_from_spec, maybe_fail  # noqa: F401
from .preemption import PreemptionGuard  # noqa: F401
from .retry import RetryPolicy, call_with_retry, is_transient  # noqa: F401
from .rollback import PROVENANCE_KEY, QuarantineList, RowRange  # noqa: F401
from .workers import WorkerPool  # noqa: F401
