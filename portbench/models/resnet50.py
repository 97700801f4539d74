"""ResNet-50 in the port, built as ``train --pallas-fused`` builds it, and
what is counted from the configuration's published shapes."""

from __future__ import annotations

import math


def build_port(config: dict, traffic: dict, device, dtype=None):
    """The port's classifier (``config/checkpoints.py::build_classifier_model``
    at the configuration's level, padding and classes), in train mode; its
    weights are replaced by the benchmark's. ``dtype`` builds the same model
    at another compute dtype (the check's float32 witness)."""
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model

    port = config["port"]
    if dtype is not None:
        from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock, ResNet

        return ResNet(stage_sizes=config["stage_sizes"], block_cls=BottleneckBlock,
                      num_classes=int(config["num_classes"]),
                      num_filters=int(config["num_filters"]), dtype=dtype,
                      fused_bn=port["fused_bn"],
                      torch_padding=bool(port["torch_padding"])).to(device).train()
    model = build_classifier_model(port["classifier"], num_classes=int(config["num_classes"]),
                                   torch_padding=bool(port["torch_padding"]),
                                   fused_bn=port["fused_bn"], device=device,
                                   crop=int(traffic["crop"]))
    return model.train()


def _stages(config: dict, crop: int):
    """``(blocks, width, side)`` of each stage: the side of its 3x3 conv's
    output, the stem and the max-pool halving the crop twice first."""
    side = math.ceil(math.ceil(crop / 2) / 2)
    for i, count in enumerate(config["stage_sizes"]):
        if i:
            side = math.ceil(side / 2)
        yield int(count), int(config["num_filters"]) * 2 ** i, side


def forward_macs(config: dict, crop: int) -> int:
    """Multiply-adds of one image's forward pass: every convolution and the
    head (BatchNorm, ReLU, pooling and the loss are not products)."""
    exp, w0 = int(config["expansion"]), int(config["num_filters"])
    stem = math.ceil(crop / 2)
    macs = stem * stem * w0 * 3 * int(config["stem_kernel"]) ** 2
    cin, in_side = w0, math.ceil(stem / 2)
    for count, width, side in _stages(config, crop):
        for j in range(count):
            first_side = in_side if j == 0 else side
            macs += first_side * first_side * width * cin  # conv1, 1x1 at the input's side
            macs += side * side * width * width * 9  # conv2, 3x3 (strided in the first block)
            macs += side * side * width * exp * width  # conv3, 1x1
            if j == 0 and (cin != width * exp or side != in_side):
                macs += side * side * width * exp * cin  # projection shortcut
            cin = width * exp
        in_side = side
    return macs + cin * int(config["num_classes"])


def train_flops_per_image(config: dict, crop: int) -> float:
    """Forward and backward: the forward's MACs x 2 x 3 (each product's two
    gradients cost it twice again); nothing recomputed is counted."""
    return 6.0 * forward_macs(config, crop)


def fused_calls(config: dict, traffic: dict) -> list[tuple[int, int, int, int]]:
    """``(calls, M, K, N)`` a training step makes of each of K1, K2 and K3:
    one call per bottleneck block, the middle BN's output ``[M, K]`` (M the
    batch's pixels at the stage's side) into conv3's ``[K, N]``, with no
    residual operand."""
    batch, exp = int(traffic["batch"]), int(config["expansion"])
    return [(count, batch * side * side, width, width * exp)
            for count, width, side in _stages(config, int(traffic["crop"]))]
