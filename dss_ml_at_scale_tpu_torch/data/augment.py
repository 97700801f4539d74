"""On-device train-time augmentation: RandomResizedCrop + horizontal flip.

Port of ``dss_ml_at_scale_tpu/data/augment.py``. The decode pool keeps
emitting deterministic center crops; the train step draws one crop box and
one flip bit per image from a key that is a pure function of (seed, step),
``fold_in(key(seed), step)``, and resamples the box onto the fixed output
window on the device. Eval and predict never augment.

The draws are the JAX package's, bit for bit: :class:`ThreefryKey` ports
``jax.random``'s threefry2x32 ``key``, ``fold_in``, ``split``, ``uniform``,
``bernoulli`` and ``normal`` in numpy uint32 arithmetic, with the partitionable
counter layout (``jax_threefry_partitionable``, the default of current
JAX). They are a few dozen numbers per batch, drawn on the host. The box
math follows XLA's float32 arithmetic on the CPU: its scale-and-shift of a
uniform is one fused multiply-add, and its ``exp`` and ``log`` are the
Cephes polynomials with fused multiply-adds (:func:`xla_exp`,
:func:`xla_log`), so the boxes are the JAX package's bit for bit.

The resample is ``jax.image.scale_and_translate(..., method="bilinear")``
with its default ``antialias=True``: when it downscales, the triangle
kernel widens by 1/scale, which ``F.interpolate`` and ``grid_sample`` do
not do. :func:`weight_matrices` builds JAX's per-image separable weight
matrices (``jax/_src/image/scale.py::compute_weight_mat``) on the device,
and :func:`random_resized_crop_flip` applies them as two batched products.
The sample positions are computed in plain float32 operations; XLA
contracts some of them into multiply-adds depending on how it fuses the
program, so a position may differ from JAX's by a unit or two in the last
place, and a weight by a few 1e-6.

In a run of several processes every rank derives the same key, draws the
boxes of the global batch and takes its own rows' share, so the crops are
those JAX draws for the global batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs ``(x1, x2)``
    under key ``(k1, k2)``, all uint32."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = np.asarray(x1, np.uint32) + ks[0]
    b = np.asarray(x2, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = (b << np.uint32(r)) | (b >> np.uint32(32 - r))
            b = a ^ b
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 values rounded once: the product is exact
    in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def xla_exp(x) -> np.ndarray:
    """float32 ``exp`` as XLA computes it on the CPU: ``2^n * p(r)``, the
    Cephes polynomial, with fused multiply-adds."""
    f = np.float32
    x = np.clip(np.asarray(x, f), f(-88.8), f(88.8))
    n = np.floor(_fma(x, f(1.44269504088896341), f(0.5)))
    r = _fma(n, f(2.12194440e-4), _fma(n, f(-0.693359375), x))
    y = _fma(r, f(1.9875691500e-4), f(1.3981999507e-3))
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1):
        y = _fma(y, r, f(c))
    y = f(1.0) + _fma(y, r * r, r)
    return np.ldexp(y, n.astype(np.int32)).astype(f)


def xla_log(x) -> np.ndarray:
    """float32 ``log`` of positive normal numbers as XLA computes it on the
    CPU: the Cephes polynomial in the mantissa, with fused multiply-adds."""
    f = np.float32
    bits = np.asarray(x, f).view(np.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(f)  # in [0.5, 1)
    e = ((bits >> 23) - 126).astype(f)
    small = m < f(0.707106781186547524)
    m = m - f(1.0) + np.where(small, m, f(0.0))
    e = e - np.where(small, f(1.0), f(0.0))
    m2 = m * m
    m3 = m2 * m
    y = _fma(_fma(m, f(7.0376836292e-2), f(-1.1514610310e-1)), m, f(1.1676998740e-1))
    y1 = _fma(_fma(m, f(-1.2420140846e-1), f(1.4249322787e-1)), m, f(-1.6668057665e-1))
    y2 = _fma(_fma(m, f(2.0000714765e-1), f(-2.4999993993e-1)), m, f(3.3333331174e-1))
    # The product with m^3 and the exponent's low part are one fused
    # multiply-add, as is the exponent's high part at the end.
    y = _fma(_fma(_fma(y, m3, y1), m3, y2), m3, e * f(-2.12194440e-4))
    return _fma(e, f(0.693359375), (m - m2 * f(0.5)) + y)


def xla_log1p(x) -> np.ndarray:
    """float32 ``log1p`` as XLA computes it on the CPU: the Cephes rational
    approximation with fused multiply-adds where ``|x| < sqrt(2) - 1``,
    :func:`xla_log` of ``1 + x`` elsewhere."""
    f = np.float32
    x = np.asarray(x, f)

    def horner(coeffs):
        r = np.zeros_like(x)
        for c in coeffs:
            r = _fma(r, x, f(c))
        return r

    x2 = x * x
    small = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    small = x + _fma(f(-0.5), x2, small)
    return np.where(np.abs(x) < f(0.41421356237309504880), small, xla_log(x + f(1.0)))


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' single-precision erfinv polynomials ("Approximating the erfinv
# function"), for w = -log(1 - x^2) below 5 and at or above it.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def xla_erfinv(x) -> np.ndarray:
    """float32 ``erfinv`` as XLA computes it (``chlo.erf_inv``): Giles'
    polynomials in ``w = -log1p(-x^2)``, evaluated with fused
    multiply-adds; ``+-inf`` at ``+-1``."""
    f = np.float32
    x = np.asarray(x, f)
    w = -xla_log1p(x * -x)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0))
    p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, f(lo), f(hi)))
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == f(1.0), x * f(np.inf), p * x)


@dataclasses.dataclass(frozen=True)
class ThreefryKey:
    """A raw threefry2x32 key: ``jax.random.key``'s two uint32 words."""

    k1: int
    k2: int

    @classmethod
    def from_seed(cls, seed: int) -> "ThreefryKey":
        """``jax.random.key(seed)`` under JAX's default 32-bit integers: the
        seed's low word, behind a zero high word."""
        return cls(0, int(seed) & 0xFFFFFFFF)

    def _hash(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """The hash of the counters 0..n-1 (a uint64 iota as two uint32
        halves, the partitionable layout)."""
        counts = np.arange(n, dtype=np.uint64)
        return threefry2x32(self.k1, self.k2, (counts >> np.uint64(32)).astype(np.uint32),
                            (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    def fold_in(self, data: int) -> "ThreefryKey":
        a, b = threefry2x32(self.k1, self.k2, np.zeros(1, np.uint32),
                            np.array([int(data) & 0xFFFFFFFF], np.uint32))
        return ThreefryKey(int(a[0]), int(b[0]))

    def split(self, num: int = 2) -> list["ThreefryKey"]:
        a, b = self._hash(num)
        return [ThreefryKey(int(x), int(y)) for x, y in zip(a, b)]

    def random_bits(self, n: int) -> np.ndarray:
        """``n`` uint32 draws (``jax.random.bits``)."""
        a, b = self._hash(n)
        return a ^ b

    def uniform(self, n: int, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
        """``jax.random.uniform`` in float32: 23 random mantissa bits under
        the exponent of 1, minus one, scaled into ``[minval, maxval)``."""
        bits = (self.random_bits(n) >> np.uint32(9)) | np.uint32(0x3F800000)
        floats = bits.view(np.float32) - np.float32(1.0)
        lo, hi = np.float32(minval), np.float32(maxval)
        # XLA fuses the scale and the shift into one multiply-add.
        return np.maximum(lo, _fma(floats, hi - lo, lo))

    def bernoulli(self, n: int, p: float = 0.5) -> np.ndarray:
        return self.uniform(n) < np.float32(p)

    def normal(self, n: int) -> np.ndarray:
        """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` of a
        uniform ``u`` in ``(-1, 1)``."""
        f = np.float32
        u = self.uniform(n, np.nextafter(f(-1.0), f(0.0)), 1.0)
        return f(np.sqrt(2)) * xla_erfinv(u)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """RandomResizedCrop + horizontal-flip parameters (torchvision
    semantics: ``scale`` is the area fraction range, ``ratio`` the
    aspect-ratio range of the sampled box)."""

    scale: tuple[float, float] = (0.08, 1.0)
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    flip: bool = True
    seed: int = 0


def sample_boxes(key: ThreefryKey, batch: int, h: int, w: int, cfg: AugmentConfig):
    """Per-image crop boxes ``(top, left, box_h, box_w)``, float32: one
    (area, log-ratio) draw clamped to the image, at least 8 x 8, as the
    JAX package's single-draw RandomResizedCrop."""
    k_area, k_ratio, k_top, k_left = key.split(4)
    h32, w32 = np.float32(h), np.float32(w)
    area = np.float32(float(h) * float(w)) * k_area.uniform(batch, cfg.scale[0], cfg.scale[1])
    log_r = k_ratio.uniform(batch, xla_log(cfg.ratio[0]), xla_log(cfg.ratio[1]))
    r = xla_exp(log_r)
    box_w = np.clip(np.sqrt(area * r), np.float32(8.0), w32)
    box_h = np.clip(np.sqrt(area / r), np.float32(8.0), h32)
    top = k_top.uniform(batch) * (h32 - box_h)
    left = k_left.uniform(batch) * (w32 - box_w)
    return top, left, box_h, box_w


def draws(key: ThreefryKey, batch: int, h: int, w: int, cfg: AugmentConfig):
    """``(top, left, box_h, box_w, flip)`` of ``random_resized_crop_flip``
    under ``key``: the crop boxes from its first subkey, the flip bits
    (all False without ``cfg.flip``) from its second."""
    k_box, k_flip = key.split(2)
    boxes = sample_boxes(k_box, batch, h, w, cfg)
    flip = k_flip.bernoulli(batch, 0.5) if cfg.flip else np.zeros(batch, bool)
    return (*boxes, flip)


def weight_matrices(size: int, out: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """``[b, size, out]`` resampling weights of one spatial axis per image:
    ``compute_weight_mat`` of ``jax.image.scale_and_translate`` with the
    triangle (bilinear) kernel and antialiasing, in float32 on
    ``scale``'s device."""
    inv = (1.0 / scale)[:, None, None]
    kernel_scale = torch.clamp_min(inv, 1.0)
    dev = scale.device
    sample = ((torch.arange(out, dtype=torch.float32, device=dev) + 0.5)[None, None, :] * inv
              - translation[:, None, None] * inv - 0.5)  # [b, 1, out]
    x = (sample - torch.arange(size, dtype=torch.float32, device=dev)[None, :, None]).abs()
    weights = torch.clamp_min(1.0 - (x / kernel_scale).abs(), 0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= size - 0.5)
    return torch.where(inside, weights, torch.zeros_like(weights))


def crop_flip(images: torch.Tensor, crop: int, top, left, box_h, box_w, flip) -> torch.Tensor:
    """Resample each box of ``images`` ``[b, h, w, c]`` (float) onto a
    ``crop x crop`` window, mirrored where ``flip``: two batched products
    with the per-image weight matrices, on the images' device. The draws
    are numpy arrays or tensors."""
    b, h, w, c = images.shape
    dev = images.device

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    flip = torch.as_tensor(flip, dtype=torch.bool, device=dev)
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    box_h, box_w = f32(box_h), f32(box_w)
    # out[y, x] = in[top + y * box_h / crop, left + x * box_w / crop]
    scale_y, scale_x = crop / box_h, crop / box_w
    wy = weight_matrices(h, crop, scale_y, -f32(top) * scale_y)
    wx = weight_matrices(w, crop, scale_x, -f32(left) * scale_x)
    x = images.float()
    rows = torch.bmm(wy.transpose(1, 2), x.reshape(b, h, w * c)).reshape(b, crop, w, c)
    out = torch.einsum("bwx,bywc->byxc", wx, rows)
    return out.to(images.dtype)


def random_resized_crop_flip(key: ThreefryKey, images: torch.Tensor, crop: int,
                             cfg: AugmentConfig = AugmentConfig(), *, rank: int = 0,
                             ranks: int = 1) -> torch.Tensor:
    """Augmented ``[b, crop, crop, c]`` batch. The draws are those of a
    global batch of ``b * ranks`` images, of which these are rows
    ``rank * b`` to ``(rank + 1) * b``."""
    b, h, w, _ = images.shape
    drawn = draws(key, b * ranks, h, w, cfg)
    mine = slice(rank * b, (rank + 1) * b)
    return crop_flip(images, crop, *(d[mine] for d in drawn))


def augment_for_step(step: int, images: torch.Tensor, crop: int,
                     cfg: AugmentConfig = AugmentConfig(), *, rank: int = 0,
                     ranks: int = 1) -> torch.Tensor:
    """The train-step entry: key ``fold_in(key(seed), step)``, so the crop
    sequence is a pure function of (seed, step) and a resumed run replays
    it."""
    key = ThreefryKey.from_seed(cfg.seed).fold_in(step)
    return random_resized_crop_flip(key, images, crop, cfg, rank=rank, ranks=ranks)


__all__ = [
    "AugmentConfig",
    "ThreefryKey",
    "augment_for_step",
    "crop_flip",
    "draws",
    "random_resized_crop_flip",
    "sample_boxes",
    "threefry2x32",
    "weight_matrices",
    "xla_exp",
    "xla_log",
]
