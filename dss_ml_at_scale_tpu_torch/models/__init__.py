"""Models of the port (PyTorch ``nn.Module``s)."""

from .convert import init_lm_state, lm_state_from_flax, seeded_lm
from .transformer import (
    RMSNorm,
    TransformerBlock,
    TransformerLM,
    decode_step,
    generate,
    init_kv_cache,
    next_token_loss,
    rms_norm,
)

__all__ = [
    "RMSNorm",
    "TransformerBlock",
    "TransformerLM",
    "decode_step",
    "generate",
    "init_kv_cache",
    "init_lm_state",
    "lm_state_from_flax",
    "next_token_loss",
    "rms_norm",
    "seeded_lm",
]
