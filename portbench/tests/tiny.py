"""Cells of the benchmark at a size a CPU test run holds: the real
configuration files cut to presets the port builds by name
(``tiny-bottleneck``: two stages of one bottleneck block, 8 filters;
``vit-t16``: ViT-Ti/16, 192 wide, 12 blocks of 3 heads), 1000 classes,
images of 32 pixels (5 tokens for the ViT) in batches of 32 (ResNet) and
96 (ViT). The cells' own limits are kept: at these sizes the port's sound
runs read within them."""

from __future__ import annotations

import copy

from portbench import spec

BATCH = {"resnet50": 32, "vit_s16": 96}
TINY = {
    "resnet50": {"stage_sizes": [1, 1], "num_filters": 8, "num_classes": 1000,
                 "port": {"classifier": "tiny-bottleneck", "fused_bn": "pallas",
                          "torch_padding": False}},
    "vit_s16": {"hidden_size": 192, "num_layers": 12, "num_heads": 3, "head_dim": 64,
                "mlp_dim": 768, "patch_size": 16, "num_classes": 1000,
                "port": {"classifier": "vit-t16"}},
}


def tiny_cell(name: str, crop: int = 32) -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config.update(copy.deepcopy(TINY[cell.config_name]))
    cell.traffic.update(batch=BATCH[cell.config_name], crop=crop)
    return cell
