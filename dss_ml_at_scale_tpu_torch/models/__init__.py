"""Models of the port (PyTorch ``nn.Module``s)."""

from .convert import (
    block_state_from_flax,
    init_lm_state,
    init_resnet_state,
    lm_state_from_flax,
    resnet_state_from_flax,
    seeded_lm,
    seeded_resnet,
)
from .moe import MoEMLP, collect_aux_loss, moe_dense_reference
from .pipelined_lm import PipelinedLM, PipelinedLMTask, init_pipelined_lm_state
from .resnet import BottleneckBlock, ResNet, ResNet18, ResNet50, ResNet101, ResNetBlock
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
    "BottleneckBlock",
    "MoEMLP",
    "PipelinedLM",
    "PipelinedLMTask",
    "RMSNorm",
    "ResNet",
    "ResNet101",
    "ResNet18",
    "ResNet50",
    "ResNetBlock",
    "TransformerBlock",
    "TransformerLM",
    "block_state_from_flax",
    "collect_aux_loss",
    "decode_step",
    "generate",
    "init_kv_cache",
    "init_lm_state",
    "init_pipelined_lm_state",
    "init_resnet_state",
    "lm_state_from_flax",
    "moe_dense_reference",
    "next_token_loss",
    "resnet_state_from_flax",
    "rms_norm",
    "seeded_lm",
    "seeded_resnet",
]
