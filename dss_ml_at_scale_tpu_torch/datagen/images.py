"""Synthetic labeled-image datasets: JPEG gratings → Delta.

Port copy of ``dss_ml_at_scale_tpu/datagen/images.py``: the same seed gives
the same JPEG bytes and labels as the JAX package's generator.

The image-track fixture generator (the counterpart of the demand panel,
SURVEY.md §4.4 — the reference tests by generating its data in-cluster):
each class is a distinct spatial-frequency/orientation grating whose
phase, contrast, and noise vary per image, so a classifier must learn
structure — a linear probe on mean color sits at chance. Used by the
accuracy-proof harness (``bench_accuracy.py``) and ``dsst datagen
images`` for quick-start training without an external dataset.
"""

from __future__ import annotations

import functools
import io
from pathlib import Path

import numpy as np


@functools.lru_cache(maxsize=8)
def _grid(size: int) -> tuple[np.ndarray, np.ndarray]:
    yy, xx = np.mgrid[0:size, 0:size] / size
    return yy, xx


def grating_jpeg(rng: np.random.Generator, label: int, classes: int,
                 size: int) -> bytes:
    """One JPEG: class = orientation/frequency; nuisance = phase/contrast."""
    from PIL import Image

    yy, xx = _grid(size)
    angle = label * np.pi / classes
    freq = 3.0 + 1.5 * (label % 5)
    phase = rng.uniform(0, 2 * np.pi)
    g = np.sin(
        2 * np.pi * freq * (xx * np.cos(angle) + yy * np.sin(angle)) + phase
    )
    contrast = rng.uniform(0.5, 1.0)
    base = 0.5 + 0.4 * contrast * g
    img = base[..., None] + rng.normal(0, 0.08, (size, size, 3))
    buf = io.BytesIO()
    Image.fromarray((img.clip(0, 1) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=90
    )
    return buf.getvalue()


def write_image_delta(
    path: str | Path,
    n: int,
    *,
    classes: int = 10,
    size: int = 64,
    seed: int = 0,
    label_noise: float = 0.0,
    max_rows_per_file: int = 256,
    mode: str = "error",
):
    """Generate ``n`` labeled JPEGs into a Delta table (content/label_index).

    ``label_noise``: fraction of rows whose STORED label is replaced by a
    uniform draw over all classes (the image itself is always rendered
    from the true class). With rate ρ on a split, the best achievable
    accuracy against its stored labels is exactly ``(1-ρ) + ρ/classes``
    — a known ceiling strictly below 1, which makes accuracy curves
    discriminating: a regression moves the plateau out of a pinned band,
    where a saturating clean run (val_acc 1.0) hides it.

    Returns the stored label array (generation order; the table's
    canonical read order depends on fragment naming — join through the
    table, not this).
    """
    import pyarrow as pa

    from ..data.delta import write_delta

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    jpegs = [grating_jpeg(rng, int(l), classes, size) for l in labels]
    stored = labels.copy()
    if label_noise:
        # Noise draws come AFTER the image draws so the same seed yields
        # byte-identical images at any noise rate.
        flip = rng.random(n) < label_noise
        stored[flip] = rng.integers(0, classes, int(flip.sum()))
    table = pa.table(
        {
            "content": pa.array(jpegs, type=pa.binary()),
            "label_index": pa.array(stored.astype(np.int64)),
        }
    )
    write_delta(table, path, max_rows_per_file=max_rows_per_file, mode=mode)
    return stored
