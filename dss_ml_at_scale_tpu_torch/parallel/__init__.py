"""Training loop of the port, and its parallel layouts: data (DDP and
ZeRO-1), sequence (ring attention) and pipeline (GPipe); and the parallel
HPO executors (device-pinned trials, trials over RPC)."""

from .pipeline import (
    PipeGrid,
    PipelinedTask,
    pipe_grid,
    pipeline_utilization,
    spmd_pipeline,
    stack_stage_params,
)
from .ring import ring_attention, sequence_shard, sharded_next_token_loss
from .schedules import warmup_cosine_decay_schedule
from .trainer import ClassifierTask, FitResult, LMTask, Trainer, TrainerConfig, restore_state
from .trials import DeviceTrials, HostTrials, objective_ref, serve_trial_worker

__all__ = ["ClassifierTask", "DeviceTrials", "FitResult", "HostTrials", "LMTask", "PipeGrid",
           "PipelinedTask", "Trainer", "TrainerConfig", "objective_ref", "pipe_grid",
           "pipeline_utilization", "restore_state", "ring_attention", "sequence_shard",
           "serve_trial_worker", "sharded_next_token_loss", "spmd_pipeline",
           "stack_stage_params", "warmup_cosine_decay_schedule"]
