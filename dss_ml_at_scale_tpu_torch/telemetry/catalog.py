"""The metric-, span-, SLO- and bench-name catalogs: every series, span,
objective and bench metric the port may emit.

Port copy of ``dss_ml_at_scale_tpu/telemetry/catalog.py``, cut to the names
the port emits. The registry is get-or-create by design (call sites never
coordinate), so a typo'd name silently forks a series and a renamed metric
silently orphans its reader. This catalog is the one place names are
*declared*; the lint rules ``telemetry-registry``, ``span-discipline``,
``slo-registry`` and ``bench-registry`` (``python -m
dss_ml_at_scale_tpu_torch.config.cli lint``) hold the port's call sites to
it in both directions (every literal name at a ``counter()``/``gauge()``/
``histogram()``/``window()``/``span()``/``Objective()``/``Scenario()`` call
site is declared here with its kind, and every entry here still has a call
site). ``tests/test_torch_catalog.py`` keeps its own reconciliation too.

:data:`KNOWN_BENCH_METRICS` is the ``bench`` command's table: JAX's 11
scenarios and the exact metric keys each schema emits, which the
``bench-registry`` rule holds ``bench/scenarios.py`` to.

:data:`SPAN_ATTRIBUTION` is what ``trace attribution`` buckets a step's
spans by; a span not listed buckets as "host".
"""

from __future__ import annotations

# name -> kind ("counter" | "gauge" | "histogram" | "window")
KNOWN_METRICS: dict[str, str] = {
    # -- static / IR analysis ----------------------------------------------
    "audit_entrypoints_total": "counter",
    "audit_findings_total": "counter",
    # -- bench / utilization ----------------------------------------------
    "bench_regressions_total": "counter",
    "bench_scenarios_total": "counter",
    "entrypoint_achieved_flops_per_sec": "gauge",
    "entrypoint_flops_utilization": "gauge",
    # the slo_overhead scenario's probe, on a private registry (never served)
    "slo_overhead_probe_hist": "histogram",
    # -- checkpointing / resilience ---------------------------------------
    "auto_resume_total": "counter",
    "checkpoint_fallback_total": "counter",
    "faults_injected_total": "counter",
    "fsync_seconds_total": "counter",
    "health_rollbacks_total": "counter",
    "loss_spikes_total": "counter",
    "nonfinite_steps_total": "counter",
    "preemption_signals_total": "counter",
    "quarantined_batches_total": "counter",
    "retry_total": "counter",
    "runs_interrupted_total": "counter",
    "worker_readmitted_total": "counter",
    # -- tracing / flight recorder ----------------------------------------
    "flight_recorder_bytes_total": "counter",
    "trace_spans_total": "counter",
    # -- device / compile --------------------------------------------------
    "device_hbm_bytes_in_use": "gauge",
    "device_hbm_bytes_limit": "gauge",
    "device_hbm_bytes_peak": "gauge",
    "device_live_buffers": "gauge",
    "device_memory_stats_supported": "gauge",
    "device_monitor_samples_total": "counter",
    "kernel_compile_events_total": "counter",
    # -- input pipeline ----------------------------------------------------
    "corrupt_samples_total": "counter",
    "feeder_batches_total": "counter",
    "feeder_depth": "gauge",
    "feeder_occupancy": "gauge",
    "feeder_stage_seconds": "histogram",
    "feeder_stall_seconds_total": "counter",
    "ingest_bytes_total": "counter",
    "ingest_rows_total": "counter",
    "reader_queue_depth": "gauge",
    "reader_stall_seconds_total": "counter",
    # -- training / HPO ----------------------------------------------------
    "hpo_trials_total": "counter",
    "skus_fitted_total": "counter",
    "pipeline_utilization": "gauge",
    "train_compile_events_total": "counter",
    "train_data_wait_seconds": "histogram",
    "train_step_seconds": "histogram",
    "train_throughput_rows_per_sec": "gauge",
    # -- live SLO plane ----------------------------------------------------
    "admission_est_queue_wait_ms": "gauge",
    "admission_service_rate_ewma": "gauge",
    "feeder_stall_window_seconds": "window",
    "fleet_replicas_up": "gauge",
    "fleet_scrape_staleness_seconds": "gauge",
    "fleet_scrape_total": "counter",
    "serving_request_window_seconds": "window",
    "slo_alert_transitions_total": "counter",
    "slo_alerts_firing": "gauge",
    "train_step_window_seconds": "window",
    # -- LM token serving --------------------------------------------------
    "lm_decode_step_seconds": "histogram",
    "lm_inter_token_window_seconds": "window",
    "lm_prefill_seconds": "histogram",
    "lm_queue_depth": "gauge",
    "lm_retired_total": "counter",
    "lm_slots_active": "gauge",
    "lm_tokens_total": "counter",
    "lm_ttft_window_seconds": "window",
    # -- serving -----------------------------------------------------------
    "predict_batch_seconds": "histogram",
    "predict_errors_total": "counter",
    "predict_images_total": "counter",
    "scoring_nonfinite_total": "counter",
    "serving_admission_rejected_total": "counter",
    "serving_batch_fill": "histogram",
    "serving_batches_total": "counter",
    "serving_deadline_expired_total": "counter",
    "serving_errors_total": "counter",
    "serving_queue_depth": "gauge",
    "serving_ready": "gauge",
    "serving_request_seconds": "histogram",
    "serving_time_in_queue_seconds": "histogram",
}

# Span name -> what the span covers. The catalog test reconciles span()
# and SpanLog.record() call sites against this in both directions;
# ``trace attribution`` buckets step spans by these names
# (:data:`SPAN_ATTRIBUTION` below).
KNOWN_SPANS: dict[str, str] = {
    # -- training ----------------------------------------------------------
    "fit": "one Trainer.fit call, open for the whole run",
    "train_epoch": "one epoch's committed-step loop",
    "train_step": "one committed train step's host span: on a card the "
                  "dispatch of its kernels (no synchronize; the card's time "
                  "once the launch queue is full), plus the verdict fetch "
                  "when health-supervised; on the CPU its compute",
    "eval": "one epoch's validation pass",
    "checkpoint": "one step's save: torch.save into the staging "
                  "directory, then the finalize",
    "checkpoint.finalize": "the step's manifest (hashes), the rename "
                           "into place and the journal commit",
    "health_rollback": "restore-from-checkpoint on a health rollback",
    # -- input pipeline ----------------------------------------------------
    "reader.next": "feeder thread pulling one host batch from the reader",
    "feeder.place": "feeder thread staging one batch: pinned host copy "
                    "and the non-blocking copy to the card on its stream",
    # -- serving -----------------------------------------------------------
    "serve.request": "one HTTP /predict request, admission to response",
    "serve.decode": "decode pool turning one request's payloads into "
                    "arrays",
    "serve.score": "one request's share of a scored micro-batch",
    "serve.generate": "one HTTP /generate request, admission to the "
                      "final streamed chunk",
    "lm.prefill": "one bucket-padded prompt prefill + arena scatter "
                  "(admission into a free slot)",
    "lm.step": "one slot_decode dispatch over every slot (all active "
               "generations advance one token)",
    # -- HPO ---------------------------------------------------------------
    "trial": "one HPO trial evaluation",
    "trial.submit": "the sweep coordinator proposing and submitting one trial",
    # -- group fit ---------------------------------------------------------
    "panel.build": "pad_groups stacking a long frame into the (G, L) "
                   "panel (vectorized scatter, host-side)",
    "grid.chunk": "one grid-fused group-fit launch: place one chunk, "
                  "fit the full order grid, device argmin",
    "tpe.round": "one TPE round of the per-SKU search: every group's "
                 "proposals fitted in one batched launch",
    "tpe.refit": "the refit of every group's best TPE order",
    # -- ingest ------------------------------------------------------------
    "ingest": "one ingest run over a raw image tree",
    # -- SLO ---------------------------------------------------------------
    "slo.alert": "one burn-rate alert state transition (recorded under "
                 "the worst offender's trace id, so the Perfetto export "
                 "draws a flow arrow to the offending request/step)",
}

# SLO objective name -> what the objective covers. The catalog test
# reconciles the objectives of ``telemetry/slo.py``'s
# default_objectives() against this in both directions: a typo'd
# objective would otherwise silently declare a new budget nobody alerts
# on.
KNOWN_SLOS: dict[str, str] = {
    "serving_latency_p99": "admitted requests settle inside the latency "
                           "budget (the configured deadline)",
    "serving_error_rate": "requests answered without 429/503/5xx",
    "feeder_stall_fraction": "step-loop wall time blocked on the feeder "
                             "queue stays under 1%",
    "train_step_p95": "windowed p95 train-step seconds vs the armed "
                      "step budget",
    "ttft_p99": "windowed p99 time-to-first-token (admit -> first "
                "streamed chunk) vs the armed TTFT budget",
    "inter_token_p99": "windowed p99 gap between consecutive streamed "
                       "tokens vs the armed per-token budget",
}

# Span name -> attribution bucket: where a step's wall time went, as
# ``trace attribution`` reads it. Sourcing the mapping here means a
# renamed span breaks the catalog test, not the attribution silently.
# Spans not listed bucket as "host".
SPAN_ATTRIBUTION: dict[str, str] = {
    "reader.next": "data_wait",
    "feeder.place": "transfer",
    "train_step": "compute",
    "panel.build": "host",
    "grid.chunk": "compute",
    "lm.prefill": "compute",
    "lm.step": "compute",
}

# Scenario name -> the exact metric keys its schema may emit (``bench``),
# JAX's table key for key. The ``bench-registry`` lint rule reconciles the
# ``Scenario(...)`` declarations in ``bench/scenarios.py`` against this in
# both directions: a typo'd metric key would otherwise silently fork a
# baseline series and dodge its regression gate.
KNOWN_BENCH_METRICS: dict[str, tuple[str, ...]] = {
    "compute": (
        "compute_steps_per_sec",
        "compute_images_per_sec",
    ),
    "decode": (
        "decode_images_per_sec",
    ),
    "feeder_e2e": (
        "e2e_images_per_sec",
        "e2e_steps_per_sec",
        "feeder_stall_fraction",
        "e2e_unexplained_fraction",
    ),
    "group_fit": (
        "group_fit_skus_per_sec",
        "group_fit_fits_per_sec",
        "group_fit_launches_per_sec",
    ),
    "group_fit_10k": (
        "group_fit_10k_skus_per_sec",
        "group_fit_10k_chunks",
    ),
    "reader": (
        "reader_images_per_sec",
    ),
    "recorder_overhead": (
        "recorder_emit_ring_us",
        "recorder_emit_tail_us",
        "recorder_tail_bytes_per_event",
    ),
    "sanitizer_overhead": (
        "sanitizer_plain_acquire_us",
        "sanitizer_armed_acquire_us",
        "sanitizer_overhead_ratio",
    ),
    "serving": (
        "serving_throughput_rps",
        "serving_p50_ms",
        "serving_p99_ms",
        "serving_batch_fill_mean",
        "serving_live_p99_ms",
    ),
    "lm_serving": (
        "lm_tokens_per_sec",
        "lm_solo_tokens_per_sec",
        "lm_batching_speedup",
        "lm_ttft_p99_ms",
        "lm_inter_token_p99_ms",
    ),
    "slo_overhead": (
        "slo_sketch_observe_us",
        "slo_hist_observe_us",
        "slo_overhead_ratio",
        "slo_emit_step_fraction",
    ),
}
