"""Real-photograph fixture sets: crops of actual camera images -> JPEG tree.

Port of ``dss_ml_at_scale_tpu/datagen/photos.py``. The reference's
deep-learning track trains on real ImageNet JPEGs; with no network, the
real photographic bytes come from two sample photographs, china.jpg and
flower.jpg (CC-BY 2.0; attribution in ``_photos/README.txt``), kept in the
package (``_photos/``). They are the two photographs scikit-learn ships,
read as its ``load_sample_image`` reads them (Pillow, ``np.asarray``), so
the port needs no scikit-learn. Random crops of them carry what synthetic
gratings cannot: real sensor noise, natural textures and lighting, and
real JPEG artifacts, labeled by source photograph.

The output is an ImageNet-style file tree (``Data/<class>_<i>.JPEG``,
label parsed from the filename prefix), so it flows through ``ingest``
like the reference's tree.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CLASSES = ("china", "flower")
PHOTO_DIR = Path(__file__).resolve().parent / "_photos"


def _source_photos() -> dict[str, np.ndarray]:
    """Each class's photograph as an ``(H, W, 3)`` uint8 array."""
    from PIL import Image

    out = {}
    for name in CLASSES:
        with Image.open(PHOTO_DIR / f"{name}.jpg") as im:
            out[name] = np.asarray(im)
    return out


def write_photo_tree(
    out_root: str | Path,
    n: int,
    *,
    size: int = 96,
    seed: int = 0,
    quality: int = 92,
    data_dir: str = "Data",
) -> int:
    """Write ``n`` labeled real-photo JPEG crops under ``out_root/Data``.

    Classes alternate between the two source photographs; each file is a
    uniformly placed ``size`` x ``size`` crop, flipped left to right half
    the time. Deterministic for a given seed (the same draws as the JAX
    package's, so the same files). Returns the file count.
    """
    from PIL import Image

    sources = _source_photos()
    for name, arr in sources.items():
        if min(arr.shape[:2]) <= size:
            raise ValueError(f"crop size {size} too large for source {name} {arr.shape}")
    rng = np.random.default_rng(seed)
    out = Path(out_root) / data_dir
    out.mkdir(parents=True, exist_ok=True)
    # Overwrite semantics (like the Delta generators): stale crops of an
    # earlier larger or differently sized run must not leak into ingest.
    for old in out.glob("*.JPEG"):
        old.unlink()
    for i in range(n):
        name = CLASSES[i % len(CLASSES)]
        arr = sources[name]
        h, w = arr.shape[:2]
        y = int(rng.integers(0, h - size))
        x = int(rng.integers(0, w - size))
        crop = arr[y:y + size, x:x + size]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        Image.fromarray(np.ascontiguousarray(crop)).save(
            out / f"{name}_{i}.JPEG", format="JPEG", quality=quality)
    return n
