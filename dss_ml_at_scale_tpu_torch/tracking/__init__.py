"""Experiment tracking of the port: run/param/metric/artifact store and
the run journal (port of ``dss_ml_at_scale_tpu/tracking``)."""

from .store import (  # noqa: F401
    JOURNAL_NAME,
    RunStore,
    boot_id,
    classify_run,
    list_runs,
    load_run,
    pid_alive,
    read_journal,
    set_run_cmdline,
    start_run,
    sweep_interrupted,
)
