"""The one table of peaks, and the roofline arithmetic.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
no sparsity), which assume the card's full 700 W: every share reported
against them goes out with the card's power limit beside it. The roofline
of a call is the larger of its operations over the peak rate and its bytes
over the peak bandwidth, each input byte counted read once and each output
byte written once (the arithmetic of the repo's ``chip_smoke.py``).
"""

from __future__ import annotations

PEAK_FLOPS = {
    "bfloat16": 989e12,  # tensor cores, dense
    "tf32": 495e12,  # tensor cores, dense
    "float32": 67e12,  # CUDA cores (FFMA)
}
PEAK_BYTES = 3.35e12  # HBM3


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take for the call, in seconds."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])


# The fused BN-ReLU-matmul (bf16 operands, f32 channel vectors) of the
# port's ``ops/fused_matmul.py``: for ``a = relu(y*s + t [+ res])``, y and
# a of [M, K], W of [K, N], g and out of [M, N].

def k1_bytes(m: int, k: int, n: int, res: bool = False) -> float:
    """K1, ``out = a @ W``: y, res, W, s, t read; out written."""
    return 2 * m * k + (2 * m * k if res else 0) + 2 * k * n + 2 * m * n + 8 * k


def k2_bytes(m: int, k: int, n: int, res: bool = False) -> float:
    """K2, ``gt = (g @ W^T) * mask`` with two channel sums: g, W, y, res,
    s, t, mean, inv read; gt and the two sums written."""
    return (2 * m * n + 2 * k * n + 2 * m * k + (2 * m * k if res else 0) + 16 * k
            + 2 * m * k + 8 * k)


def k3_bytes(m: int, k: int, n: int, res: bool = False) -> float:
    """K3, ``dW = a^T @ g`` in f32: y, res, s, t, g read; dW written."""
    return 2 * m * k + (2 * m * k if res else 0) + 8 * k + 2 * m * n + 4 * k * n


def fused_bounds_s(m: int, k: int, n: int, res: bool = False) -> dict[str, float]:
    """Each of K1-K3's bound for one call of shape (M, K, N)."""
    flops = 2 * m * k * n
    return {"K1": bound_s(k1_bytes(m, k, n, res), flops),
            "K2": bound_s(k2_bytes(m, k, n, res), flops),
            "K3": bound_s(k3_bytes(m, k, n, res), flops)}
