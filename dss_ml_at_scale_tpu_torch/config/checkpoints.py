"""The classifier factory shared by the port's entry points.

Port of ``dss_ml_at_scale_tpu/config/checkpoints.py::build_classifier_model``
for the ResNet choices; the ViT choices wait for the port of
``models/vit.py``, and checkpoint resolution for the port's checkpoints.
"""

from __future__ import annotations

CLASSIFIERS = ("resnet50", "tiny", "tiny-bottleneck")


def build_classifier_model(name: str, *, num_classes: int, torch_padding: bool,
                           fused_bn: bool | str = True, device="cuda"):
    """``resnet50``, or the CI-sized ``tiny`` (basic blocks) and
    ``tiny-bottleneck`` (the ResNet-50 block; the one small model that
    exercises ``fused_bn="pallas"``), in bf16 with seed-0 weights on
    ``device``. ``fused_bn`` takes the ResNet levels: False, True, or
    "pallas"."""
    from ..models.convert import seeded_resnet
    from ..models.resnet import BottleneckBlock, ResNetBlock

    if name not in CLASSIFIERS:
        raise ValueError(f"unknown classifier {name!r}; the port has {CLASSIFIERS}")
    if name == "resnet50":
        config = dict(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock, num_filters=64)
    else:
        config = dict(stage_sizes=[1, 1], num_filters=8,
                      block_cls=BottleneckBlock if name == "tiny-bottleneck" else ResNetBlock)
    return seeded_resnet(0, device=device, num_classes=num_classes,
                         torch_padding=torch_padding, fused_bn=fused_bn, **config)
