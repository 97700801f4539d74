"""Training loop of the port (single card)."""

from .schedules import warmup_cosine_decay_schedule
from .trainer import ClassifierTask, FitResult, LMTask, Trainer, TrainerConfig

__all__ = ["ClassifierTask", "FitResult", "LMTask", "Trainer", "TrainerConfig",
           "warmup_cosine_decay_schedule"]
