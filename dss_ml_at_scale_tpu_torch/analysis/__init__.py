"""Static and runtime analysis of the port: ``lint``, ``sanitize``, ``audit``.

Port of ``dss_ml_at_scale_tpu/analysis/``, pointed at the port's own
sources, threads and programs. Twelve lint rules over one shared AST parse
per file: the nine whose meaning carries over unchanged (``bare-except``,
``no-print``, ``durable-write``, ``lock-discipline``, ``fault-sites``,
``telemetry-registry``, ``span-discipline``, ``slo-registry``,
``bench-registry``), each reconciled against the port's own registries,
and the three JAX rules retargeted to what the same hazard is in PyTorch
(``host-sync``, ``trace-safety``, ``retrace-hazard``; each module's
docstring says what it means in torch). See :mod:`.core` for the framework
(suppressions, baseline, renderers, exit codes), :mod:`.checkers` for the
rules, :mod:`.sanitize` for the runtime thread sanitizer and :mod:`.audit`
for the entrypoint audit.

Entry points: the CLI's ``lint`` command, :func:`run_lint` (tests),
:func:`lint_text` (one checker over one source string).
"""

from .core import (
    DEFAULT_BASELINE,
    Checker,
    FileContext,
    Finding,
    LintResult,
    LintUsageError,
    checker_catalog,
    checker_names,
    lint_text,
    load_baseline,
    register_checker,
    run_lint,
    write_baseline,
)

__all__ = [
    "Checker",
    "DEFAULT_BASELINE",
    "FileContext",
    "Finding",
    "LintResult",
    "LintUsageError",
    "checker_catalog",
    "checker_names",
    "lint_text",
    "load_baseline",
    "register_checker",
    "run_lint",
    "write_baseline",
]
