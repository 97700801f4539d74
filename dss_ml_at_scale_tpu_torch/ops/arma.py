"""ARMA sample generation: scipy's ``lfilter`` over a batch of series.

Port of ``dss_ml_at_scale_tpu/ops/arma.py``, which replaces
``statsmodels.tsa.arma_generate_sample`` as the demand generator uses it.
Like the port's other generators this runs on the host in numpy: the whole
panel is a few hundred thousand filter steps, vectorized over the series.

Conventions match statsmodels/scipy: ``ar`` and ``ma`` are full lag
polynomials including the leading 1, with AR signs as in
``ar = [1, -phi_1, ..., -phi_p]``. The filter is scipy's transposed
direct form II. In float32 it computes what the JAX package's
``lax.scan`` computes on the CPU, bit for bit: XLA contracts the step's
products and sums into fused multiply-adds, and so does :func:`lfilter`.
"""

from __future__ import annotations

import numpy as np

from ..data.augment import ThreefryKey, _fma


def _muladd(a, b, c, dtype) -> np.ndarray:
    """``a * b + c``, rounded once in float32 (XLA's contraction)."""
    if dtype == np.float32:
        return _fma(a, b, c)
    return a * b + c


def lfilter(b, a, x) -> np.ndarray:
    """IIR filter ``y = lfilter(b, a, x)`` along the last axis of ``x``.

    ``b``/``a`` are the numerator/denominator polynomials, ``[k]`` or one
    row per series ``[..., k]``; ``a[..., 0]`` must be nonzero (it
    normalizes both). Transposed direct form II:

        y[t] = b[0] x[t] + z[0]
        z[i] = b[i+1] x[t] + z[i+1] - a[i+1] y[t]
    """
    x = np.asarray(x)
    dtype = x.dtype if x.dtype in (np.float32, np.float64) else np.dtype(np.float64)
    x = x.astype(dtype, copy=False)
    b = np.atleast_1d(np.asarray(b, dtype))
    a = np.atleast_1d(np.asarray(a, dtype))
    # nfilt >= 2 keeps the state non-empty even for the ARMA(0,0) /
    # pure-gain case (b and a both scalar), where the filter is y = (b0/a0) x.
    nfilt = max(b.shape[-1], a.shape[-1], 2)
    pad = lambda v: np.concatenate(  # noqa: E731
        [v, np.zeros(v.shape[:-1] + (nfilt - v.shape[-1],), dtype)], -1)
    b = pad(b) / a[..., :1]
    a = pad(a) / a[..., :1]
    batch = np.broadcast_shapes(x.shape[:-1], b.shape[:-1], a.shape[:-1])
    x = np.broadcast_to(x, batch + x.shape[-1:])
    b = np.broadcast_to(b, batch + (nfilt,))
    a = np.broadcast_to(a, batch + (nfilt,))
    z = np.zeros(batch + (nfilt - 1,), dtype)
    zero = np.zeros(batch + (1,), dtype)
    y = np.empty(x.shape, dtype)
    for t in range(x.shape[-1]):
        x_t = x[..., t:t + 1]
        y_t = _muladd(b[..., :1], x_t, z[..., :1], dtype)
        z_shift = np.concatenate([z[..., 1:], zero], -1)
        z = _muladd(-a[..., 1:], y_t, _muladd(b[..., 1:], x_t, z_shift, dtype), dtype)
        y[..., t] = y_t[..., 0]
    return y


def arma_generate_sample(
    keys: list[ThreefryKey],
    ar,
    ma,
    nsample: int,
    scale=1.0,
    burnin: int = 0,
) -> np.ndarray:
    """Draw one ARMA sample per key, ``[len(keys), nsample]`` float32;
    mirrors ``sm.tsa.arma_generate_sample``.

    ``ar``/``ma`` are ``[k]`` or one row per series, ``scale`` a scalar or
    one value per series. The innovations are ``scale * jax.random.normal(
    key, (nsample + burnin,))`` of each key, bit for bit.
    """
    eps = np.stack([k.normal(nsample + burnin) for k in keys])
    scale = np.asarray(scale, np.float32)
    eps = (scale[:, None] if scale.ndim else scale) * eps
    return lfilter(ma, ar, eps)[:, burnin:]
