"""ViT-S/16 in the port, built as ``train --model vit-s16`` builds it, and
what is counted from the configuration's published shapes."""

from __future__ import annotations


def build_port(config: dict, traffic: dict, device, dtype=None):
    """The port's classifier (``config/checkpoints.py::build_classifier_model``,
    its position table sized by the crop), in train mode; its weights are
    replaced by the benchmark's. ``dtype`` builds the same model at another
    compute dtype (the check's float32 witness)."""
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model

    if dtype is not None:
        from dss_ml_at_scale_tpu_torch.models.vit import ViT

        d = int(config["hidden_size"])
        return ViT(int(config["num_classes"]), image_size=int(traffic["crop"]),
                   patch=int(config["patch_size"]), dim=d, depth=int(config["num_layers"]),
                   num_heads=int(config["num_heads"]), mlp_ratio=int(config["mlp_dim"]) // d,
                   dtype=dtype, device=device).train()

    model = build_classifier_model(config["port"]["classifier"],
                                   num_classes=int(config["num_classes"]), torch_padding=False,
                                   fused_bn=False, device=device, crop=int(traffic["crop"]))
    return model.train()


def forward_macs(config: dict, crop: int) -> int:
    """Multiply-adds of one image's forward pass: the patch projection, per
    block q, k, v and the output projection, attention's two products
    (scores and the weighted sum, every token against every token), the
    MLP, and the head on the class token."""
    d, p = int(config["hidden_size"]), int(config["patch_size"])
    patches = (crop // p) ** 2
    n = patches + 1
    block = 4 * n * d * d + 2 * n * n * d + 2 * n * d * int(config["mlp_dim"])
    return (patches * d * 3 * p * p + int(config["num_layers"]) * block
            + d * int(config["num_classes"]))


def attention_macs(config: dict, crop: int) -> int:
    """The part of :func:`forward_macs` in attention's two products."""
    n = (crop // int(config["patch_size"])) ** 2 + 1
    return int(config["num_layers"]) * 2 * n * n * int(config["hidden_size"])


def train_flops_per_image(config: dict, crop: int) -> float:
    """Forward and backward: the forward's MACs x 2 x 3; nothing recomputed
    is counted."""
    return 6.0 * forward_macs(config, crop)


def fused_calls(config: dict, traffic: dict) -> list:
    """The ViT makes no call of the fused BN-ReLU-matmul."""
    return []
