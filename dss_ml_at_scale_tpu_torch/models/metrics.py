"""Loss and metric functions: the port of
``dss_ml_at_scale_tpu/models/metrics.py``. Each returns a 0-d f32 tensor
on the logits' device (no host sync)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.float(), labels.long())


def multiclass_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy (argmax takes the first of equal maxima, as jnp's)."""
    return (logits.argmax(-1) == labels).float().mean()


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k accuracy (the standard ImageNet top-5 companion metric)."""
    if k > logits.shape[-1]:
        raise ValueError(
            f"top-{k} accuracy needs at least {k} classes, got "
            f"{logits.shape[-1]} (check eval_topk)"
        )
    top = logits.topk(k, dim=-1).indices
    return (top == labels[:, None]).any(-1).float().mean()
