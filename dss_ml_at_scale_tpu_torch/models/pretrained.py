"""Torchvision-layout weights in and out of the port's ResNet and ViT.

Port of ``dss_ml_at_scale_tpu/models/pretrained.py``.
The reference fine-tunes torchvision's pretrained ``resnet50`` (reference
``deep_learning/2.distributed-data-loading-petastorm.py:150``);
:func:`load_pretrained_resnet` reads weights in that layout, a torch
``state_dict`` (``.pt``/``.pth``, Lightning checkpoints included) or an
``.npz`` with the same key names, into :class:`..models.resnet.ResNet`,
whose ``state_dict`` already carries torchvision's names, so ``train
--pretrained <path>`` fine-tunes instead of cold-starting.
:func:`export_torchvision` writes the port's model back out as an
``.npz`` that the JAX package's loader and this one both read.

Build the model with ``torch_padding=True`` to match torchvision's
numerics: torchvision pads stride-2 convs symmetrically where XLA's SAME
does not, and the running BatchNorm statistics embed that choice.

For the ViT, :func:`convert_torchvision_vit` maps torchvision's
``VisionTransformer`` layout onto the port's names (``_vit_torch_name``):
``conv_proj``, ``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_<i>.{ln_1, self_attention, ln_2, mlp}``,
``encoder.ln``, ``heads.head``; the fused attention projection
``in_proj_weight`` ``[3d, d]`` splits into the q/k/v rows (``_qkv_split``),
and the MLP's Linears are ``mlp.0``/``mlp.3`` (current torchvision) or
``mlp.linear_1``/``mlp.linear_2`` (older releases). The position table
fixes the resolution: a file of another one fails the shape check.
:func:`export_torchvision` writes either model back out.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

# The classifier head exists exactly once at the root of the layout, unlike
# conv1/bn1, which recur inside the blocks: it anchors a wrapper prefix.
_ANCHOR = "fc.weight"


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """Read a torchvision-layout state dict from ``.pt``/``.pth`` (torch) or
    ``.npz``. A Lightning checkpoint is unwrapped twice: its
    ``state_dict`` envelope, then a uniform submodule prefix (a
    ``LightningModule`` that holds the backbone as ``self.model`` saves
    ``model.conv1.weight``), found from wherever ``fc.weight`` lives."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return _strip_wrapper_prefix({k: z[k] for k in z.files})
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # Lightning checkpoints carry an argparse.Namespace of
        # hyper-parameters, which the strict unpickler rejects: allow that
        # one class (still weights_only) and read again.
        with torch.serialization.safe_globals([argparse.Namespace]):
            state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, Mapping) and "state_dict" in state:
        state = state["state_dict"]
    return _strip_wrapper_prefix({k: _to_numpy(v) for k, v in state.items()})


def _strip_wrapper_prefix(state: dict) -> dict:
    """Strip a uniform wrapper prefix (``model.``, ``module.``, any
    attribute name) ending at a module boundary; anything else is left."""
    if _ANCHOR in state:
        return state
    prefixes = {k[: -len(_ANCHOR)] for k in state if k.endswith(_ANCHOR)}
    if len(prefixes) != 1:
        return state
    prefix = prefixes.pop()
    if not prefix.endswith("."):
        # A partial key such as ``aux_fc.weight``: stripping would mangle it.
        return state
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state.items()}


def convert_torchvision_resnet(state: Mapping, model: torch.nn.Module, *,
                               reinit_head: bool = False) -> dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` filled from ``state``: every tensor of
    the model must find its key with the same shape (a ``KeyError`` or a
    ``ValueError`` otherwise); extra keys (``num_batches_tracked``) are
    ignored. ``reinit_head`` keeps the model's own ``fc`` (the fine-tune to
    another class count)."""
    out = {}
    for name, template in model.state_dict().items():
        if reinit_head and name.startswith("fc."):
            out[name] = template.detach().cpu().clone()
            continue
        if name not in state:
            raise KeyError(f"pretrained state has no {name!r}")
        arr = _to_numpy(state[name])
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != model {tuple(template.shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def load_pretrained_resnet(path: str | Path, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Load ``path`` into ``model`` in place and return the loaded state.
    When the file has no head (a backbone-only export) or one of another
    class count than the model's, the head keeps its fresh initialization."""
    state = load_state_dict(path)
    reinit_head = _ANCHOR not in state or state[_ANCHOR].shape[0] != model.num_classes
    loaded = convert_torchvision_resnet(state, model, reinit_head=reinit_head)
    model.load_state_dict(loaded)
    return loaded


def _vit_torch_name(name: str) -> tuple[list[str], str]:
    """A port ViT ``state_dict`` key -> (torchvision key candidates, the
    q/k/v row it takes of a fused ``in_proj``, or "")."""
    wb = name.rsplit(".", 1)[-1]
    if name.startswith("patch_embed."):
        return [f"conv_proj.{wb}"], ""
    if name == "cls_token":
        return ["class_token"], ""
    if name == "pos_embed":
        return ["encoder.pos_embedding"], ""
    if name.startswith("ln_final."):
        return [f"encoder.ln.{wb}"], ""
    if name.startswith("head."):
        return [f"heads.head.{wb}"], ""
    _, i, inner, _ = name.split(".")
    prefix = f"encoder.layers.encoder_layer_{i}"
    if inner in ("q", "k", "v"):
        part = "in_proj_weight" if wb == "weight" else "in_proj_bias"
        return [f"{prefix}.self_attention.{part}"], inner
    mapped = {"ln_attn": ["ln_1"], "ln_mlp": ["ln_2"],
              "attn_out": ["self_attention.out_proj"],
              "mlp_in": ["mlp.0", "mlp.linear_1"], "mlp_out": ["mlp.3", "mlp.linear_2"]}
    return [f"{prefix}.{m}.{wb}" for m in mapped[inner]], ""


def _qkv_split(which: str, a: np.ndarray) -> np.ndarray:
    """The q, k or v third of a fused ``in_proj`` weight or bias."""
    d = a.shape[0] // 3
    i = "qkv".index(which)
    return a[i * d:(i + 1) * d]


def convert_torchvision_vit(state: Mapping, model: torch.nn.Module, *,
                            reinit_head: bool = False) -> dict[str, torch.Tensor]:
    """A ViT ``model``'s ``state_dict`` filled from torchvision-layout
    ``state``: every tensor must find one of its candidate keys with the
    same shape after the q/k/v split (``KeyError``/``ValueError``
    otherwise); extra keys are ignored. ``reinit_head`` keeps the model's
    own head."""
    out = {}
    for name, template in model.state_dict().items():
        if reinit_head and name.startswith("head."):
            out[name] = template.detach().cpu().clone()
            continue
        candidates, which = _vit_torch_name(name)
        key = next((k for k in candidates if k in state), None)
        if key is None:
            raise KeyError(f"pretrained state has none of {candidates} (for {name!r})")
        arr = _to_numpy(state[key])
        if which:
            arr = _qkv_split(which, arr)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key} -> {name}: shape {tuple(arr.shape)} != model "
                             f"{tuple(template.shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def load_pretrained_vit(path: str | Path, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Load ``path`` into the ViT ``model`` in place and return the loaded
    state. The model's position table fixes the resolution: a file
    trained at another one fails the shape check (no interpolation). A
    missing head, or one of another class count, keeps the model's."""
    state = load_state_dict(path)
    head = state.get("heads.head.weight")
    reinit_head = head is None or head.shape[0] != model.num_classes
    loaded = convert_torchvision_vit(state, model, reinit_head=reinit_head)
    model.load_state_dict(loaded)
    return loaded


def export_torchvision(model: torch.nn.Module, path: str | Path) -> dict[str, np.ndarray]:
    """Write ``model``'s weights as a torchvision-layout ``.npz`` (f32) and
    return them: the inverse of :func:`load_pretrained_resnet` and
    :func:`load_pretrained_vit` (a ViT's q/k/v re-fused into
    ``in_proj_weight``/``in_proj_bias``), and a file the JAX package's
    ``--pretrained`` reads."""
    from .vit import ViT

    path = Path(path)
    if path.suffix != ".npz":
        # np.savez appends ".npz" to any other name: refuse instead.
        raise ValueError(f"export path must end in .npz (got {path})")
    state = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    if not isinstance(model, ViT):
        np.savez(path, **state)
        return state
    out: dict[str, np.ndarray] = {}
    for name, arr in state.items():
        candidates, which = _vit_torch_name(name)
        if not which:
            out[candidates[0]] = arr
        elif which == "q":  # the three thirds, fused once
            block, _, wb = name.rsplit(".", 2)
            out[candidates[0]] = np.concatenate([state[f"{block}.{w}.{wb}"] for w in "qkv"])
    np.savez(path, **out)
    return out


__all__ = [
    "convert_torchvision_resnet",
    "convert_torchvision_vit",
    "export_torchvision",
    "load_pretrained_resnet",
    "load_pretrained_vit",
    "load_state_dict",
]
