"""Row-group transform pipeline (the TransformSpec equivalent).

Port of ``dss_ml_at_scale_tpu/data/transform.py`` on the PIL backend. The
contract is columnar: the function maps a dict of numpy arrays (one row
group) to a dict of numpy arrays, and ``fields`` declares the output schema
the trainer relies on. ``backend="auto"`` resolves to ``"pil"`` and reports
it on ``spec.backend``; the JAX package's C++ ``native`` decoder waits for
the port's own copy, so ``backend="native"`` raises.
"""

from __future__ import annotations

import dataclasses
import io
import threading
from typing import Callable, Mapping, Sequence

import numpy as np

Columnar = Mapping[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: np.dtype
    shape: tuple[int, ...]  # per-row shape, () for scalar columns


class SubstitutionCounter:
    """Thread-safe tally of corrupt records zero-substituted by a spec."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self, k: int = 1) -> None:
        with self._lock:
            self._n += k

    @property
    def count(self) -> int:
        return self._n


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """Transform + declared output schema. ``func`` runs on the host inside
    the reader's worker pool: JPEG decode lives there."""

    func: Callable[[Columnar], Columnar]
    fields: Sequence[Field]
    backend: str | None = None
    substitutions: SubstitutionCounter = dataclasses.field(default_factory=SubstitutionCounter)

    def __call__(self, batch: Columnar) -> dict[str, np.ndarray]:
        out = dict(self.func(batch))
        declared = {f.name: f for f in self.fields}
        if set(out) != set(declared):
            raise ValueError(
                f"transform produced columns {sorted(out)} but declared {sorted(declared)}"
            )
        n = None
        for name, arr in out.items():
            f = declared[name]
            arr = np.asarray(arr, dtype=f.dtype)
            want = (len(arr),) + tuple(f.shape)
            if arr.shape != want:
                raise ValueError(f"column {name}: shape {arr.shape} != declared {want}")
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError("transform produced ragged column lengths")
            out[name] = arr
        return out


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def decode_resize_crop(jpeg_bytes: bytes, resize: int = 256, crop: int = 224) -> np.ndarray:
    """JPEG -> float32 HWC in [0,1], shorter-side resize then center crop
    (torchvision's Resize(256)/CenterCrop(224)/ToTensor, channels last)."""
    from PIL import Image

    img = Image.open(io.BytesIO(jpeg_bytes)).convert("RGB")
    w, h = img.size
    scale = resize / min(w, h)
    img = img.resize((max(1, round(w * scale)), max(1, round(h * scale))), Image.BILINEAR)
    w, h = img.size
    left, top = (w - crop) // 2, (h - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    return np.asarray(img, np.float32) / 255.0


def imagenet_transform_spec(
    *,
    resize: int = 256,
    crop: int = 224,
    backend: str = "auto",
    output_dtype: str = "float32",
    on_error: str = "raise",
) -> TransformSpec:
    """The reference's training TransformSpec, columnar, from a table's
    ``content``/``label_index`` columns: ``image`` HWC (float32 normalized,
    or the raw uint8 bytes that the train step normalizes on the device) and
    ``label`` int32. ``on_error="substitute"`` turns an undecodable record
    into the dataset-mean image, counted on ``spec.substitutions``."""
    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "native":
        raise ValueError(
            "the native JPEG decoder is not ported yet; use backend='pil' or 'auto'"
        )
    if output_dtype not in ("float32", "uint8"):
        raise ValueError(f"unknown output_dtype {output_dtype!r}")
    if on_error not in ("raise", "substitute"):
        raise ValueError(f"unknown on_error {on_error!r}")
    if crop > resize:
        raise ValueError(f"crop ({crop}) must be <= resize ({resize})")

    image_shape = (crop, crop, 3)

    def _decode(b: bytes) -> np.ndarray:
        img = decode_resize_crop(b, resize=resize, crop=crop)
        if output_dtype == "uint8":
            return np.round(img * 255.0).astype(np.uint8)  # undo ToTensor's /255
        return (img - IMAGENET_MEAN) / IMAGENET_STD

    def _substitute() -> np.ndarray:
        """The dataset-mean image in this spec's value space."""
        if output_dtype == "uint8":
            return np.broadcast_to(np.round(IMAGENET_MEAN * 255.0).astype(np.uint8),
                                   image_shape).copy()
        return np.zeros(image_shape, np.float32)

    def _decode_or_substitute(b: bytes) -> np.ndarray:
        try:
            return _decode(b)
        except Exception:
            if on_error == "raise":
                raise
            spec.substitutions.add()
            return _substitute()

    def _func(batch: Columnar) -> Columnar:
        images = np.stack([_decode_or_substitute(bytes(b)) for b in batch["content"]])
        labels = np.asarray(batch["label_index"], np.int32)
        return {"image": images, "label": labels}

    spec = TransformSpec(
        func=_func,
        fields=[
            Field("image", np.dtype(output_dtype), image_shape),
            Field("label", np.dtype(np.int32), ()),
        ],
        backend="pil",
    )
    return spec
