"""Checkpoint-meta resolution shared by train, predict, export and serve.

Port of ``dss_ml_at_scale_tpu/config/checkpoints.py``. ``train`` persists
``dsst_model.json`` beside its checkpoint steps; every consumer (the CLI
commands and the serving library) resolves it through this one module, so
the restore-critical branches (the scoring level of a fused checkpoint,
the ViT's training crop) cannot drift between entry points. Failures
raise (``FileNotFoundError``, ``ValueError``); the CLI turns them into
messages and exit codes.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

CLASSIFIERS = ("resnet50", "tiny", "tiny-bottleneck", "vit-t16", "vit-s16", "vit-tiny")


def build_classifier_model(name: str, *, num_classes: int, torch_padding: bool,
                           fused_bn: bool | str = True, device="cuda", crop: int = 224):
    """``resnet50``, the CI-sized ``tiny`` (basic blocks) and
    ``tiny-bottleneck`` (the ResNet-50 block; the one small model that
    exercises ``fused_bn="pallas"``), or the ViTs ``vit-t16``, ``vit-s16``
    and the CI-sized ``vit-tiny`` (the presets of ``models/vit.py``), in
    bf16 with seed-0 weights on ``device``. ``fused_bn`` takes the ResNet
    levels: False, True, or "pallas". A ViT has no convolution padding and
    no BatchNorm: ``torch_padding`` and ``fused_bn`` are inert for it, and
    its position table is sized by ``crop``."""
    if name not in CLASSIFIERS:
        raise ValueError(f"unknown classifier {name!r}; the port has {CLASSIFIERS}")
    if name.startswith("vit"):
        from ..models.convert import seeded_vit
        from ..models.vit import vit_s16, vit_t16, vit_tiny

        preset = {"vit-t16": vit_t16, "vit-s16": vit_s16, "vit-tiny": vit_tiny}[name]
        return seeded_vit(0, device=device, preset=preset, num_classes=num_classes,
                          image_size=crop)
    from ..models.convert import seeded_resnet
    from ..models.resnet import BottleneckBlock, ResNetBlock

    if name == "resnet50":
        config = dict(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock, num_filters=64)
    else:
        config = dict(stage_sizes=[1, 1], num_filters=8,
                      block_cls=BottleneckBlock if name == "tiny-bottleneck" else ResNetBlock)
    return seeded_resnet(0, device=device, num_classes=num_classes,
                         torch_padding=torch_padding, fused_bn=fused_bn, **config)


def resolve_checkpoint(checkpoint_dir, crop_override: int | None = None, *, device="cuda"):
    """``(meta, crop, model, task)`` for a ``train`` checkpoint directory,
    the model built on ``device`` (its weights still the seeded ones:
    :func:`..parallel.restore_state` loads the checkpoint's).

    Raises ``FileNotFoundError`` when the directory has no
    ``dsst_model.json`` and ``ValueError`` when a crop override differs
    from a ViT's training crop (its position table is sized by it; a
    ResNet pools globally and takes any crop). A ``--pallas-fused``
    checkpoint is rebuilt at the fused level (``bool("pallas")``, as the
    JAX resolver does): inference applies the same BN statistics either
    way, and scores without the fused-matmul kernels.
    """
    meta_path = Path(checkpoint_dir) / "dsst_model.json"
    if not meta_path.exists():
        raise FileNotFoundError(
            f"no dsst_model.json under {checkpoint_dir}; "
            "was this checkpoint written by train?"
        )
    meta = json.loads(meta_path.read_text())
    crop = crop_override or int(meta.get("crop", 224))
    if (str(meta.get("model", "")).startswith("vit") and meta.get("crop")
            and crop != int(meta["crop"])):
        raise ValueError(
            f"--crop {crop} differs from the training crop {meta['crop']}: ViT "
            "checkpoints must be scored at the crop they were trained with"
        )
    from ..parallel import ClassifierTask

    model = build_classifier_model(
        meta.get("model", "resnet50"),
        num_classes=int(meta["num_classes"]),
        torch_padding=bool(meta.get("torch_padding", False)),
        fused_bn=bool(meta.get("fused_bn", False)),
        device=device, crop=crop,
    )
    return meta, crop, model, ClassifierTask(model=model)


def make_scorer(task):
    """The one classification scorer: images -> ``(pred_index,
    pred_prob)``, shared by ``predict`` and the HTTP server, so their
    outputs agree by construction. Takes what the task's ``images`` takes
    (float NHWC, uint8, or NCHW) on the model's device: the f32 softmax of
    the eval-mode logits, its argmax (the first index on ties, as
    ``jnp.argmax``) and its max."""
    model = task.model

    @torch.inference_mode()
    def score(images):
        model.eval()
        probs = torch.softmax(model(task.images({"image": images})).float(), dim=-1)
        return probs.argmax(dim=-1), probs.amax(dim=-1)

    return score
