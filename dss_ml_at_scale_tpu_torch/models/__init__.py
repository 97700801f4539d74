"""Models of the port (PyTorch ``nn.Module``s)."""

from .convert import (
    block_state_from_flax,
    init_lm_state,
    init_resnet_state,
    lm_state_from_flax,
    init_vit_state,
    resnet_state_from_flax,
    seeded_lm,
    seeded_resnet,
    seeded_vit,
    vit_state_from_flax,
)
from .moe import MoEMLP, collect_aux_loss, moe_dense_reference
from .pipelined_lm import PipelinedLM, PipelinedLMTask, init_pipelined_lm_state
from .pretrained import (
    convert_torchvision_vit,
    export_torchvision,
    load_pretrained_resnet,
    load_pretrained_vit,
)
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
from .vit import ViT, ViTBlock, vit_s16, vit_t16, vit_tiny

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
    "ViT",
    "ViTBlock",
    "block_state_from_flax",
    "collect_aux_loss",
    "convert_torchvision_vit",
    "decode_step",
    "export_torchvision",
    "generate",
    "init_kv_cache",
    "init_lm_state",
    "init_pipelined_lm_state",
    "init_resnet_state",
    "init_vit_state",
    "lm_state_from_flax",
    "load_pretrained_resnet",
    "load_pretrained_vit",
    "moe_dense_reference",
    "next_token_loss",
    "resnet_state_from_flax",
    "rms_norm",
    "seeded_lm",
    "seeded_resnet",
    "seeded_vit",
    "vit_s16",
    "vit_state_from_flax",
    "vit_t16",
    "vit_tiny",
]
