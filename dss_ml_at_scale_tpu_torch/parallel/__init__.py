"""Training loop of the port (single card)."""

from .trainer import ClassifierTask, FitResult, Trainer, TrainerConfig

__all__ = ["ClassifierTask", "FitResult", "Trainer", "TrainerConfig"]
