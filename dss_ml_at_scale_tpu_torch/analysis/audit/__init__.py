"""``audit`` — the entrypoint analysis tier of the port.

Port of ``dss_ml_at_scale_tpu/analysis/audit/``. Where the JAX package
traces jaxprs and lowered HLO, this package runs the registry of the
port's real entrypoints (:mod:`.entrypoints`) once each under a dispatch
recorder and a FLOP counter, on torch's fake process group of 8 ranks,
and audits donation (in-place state), dtype discipline, collectives,
host interop and a per-device program baseline (the port's
``analysis/baselines/audit.json``). See :mod:`.core` for the framework
and :mod:`.rules` for the rules.
"""

from .core import (
    AUDIT_SCHEMA_VERSION,
    AUDIT_WORLD_SIZE,
    COST_TOLERANCE,
    DEFAULT_AUDIT_BASELINE,
    AuditFinding,
    AuditResult,
    AuditRule,
    AuditUsageError,
    EntrypointContext,
    ProgramSpec,
    audit_world,
    load_audit_baseline,
    register_rule,
    rule_catalog,
    rule_names,
    run_audit,
    write_audit_baseline,
)
from .entrypoints import builders, entrypoint_names

__all__ = [
    "AUDIT_SCHEMA_VERSION",
    "AUDIT_WORLD_SIZE",
    "COST_TOLERANCE",
    "DEFAULT_AUDIT_BASELINE",
    "AuditFinding",
    "AuditResult",
    "AuditRule",
    "AuditUsageError",
    "EntrypointContext",
    "ProgramSpec",
    "audit_world",
    "builders",
    "entrypoint_names",
    "load_audit_baseline",
    "register_rule",
    "rule_catalog",
    "rule_names",
    "run_audit",
    "write_audit_baseline",
]
