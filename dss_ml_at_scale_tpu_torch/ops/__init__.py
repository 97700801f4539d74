"""Ops of the port: hand-written Hopper kernels beside their plain versions."""

from .flash_attention import BlockDivisibilityError, attention_reference, flash_attention
from .fused_matmul import (
    bn_relu_matmul,
    bn_relu_matmul_bwd_da,
    bn_relu_matmul_bwd_dw,
    bn_relu_matmul_fwd,
)
from .fused_norm import BatchNorm, bn_act

__all__ = [
    "BatchNorm",
    "BlockDivisibilityError",
    "attention_reference",
    "bn_act",
    "bn_relu_matmul",
    "bn_relu_matmul_bwd_da",
    "bn_relu_matmul_bwd_dw",
    "bn_relu_matmul_fwd",
    "flash_attention",
]
