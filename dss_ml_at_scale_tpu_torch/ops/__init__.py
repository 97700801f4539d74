"""Ops of the port: hand-written Hopper kernels beside their plain versions."""

from .flash_attention import BlockDivisibilityError, attention_reference, flash_attention

__all__ = ["BlockDivisibilityError", "attention_reference", "flash_attention"]
