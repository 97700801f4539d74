"""Flash attention: a hand-written Hopper kernel and its plain version.

Port of ``dss_ml_at_scale_tpu/ops/flash_attention.py``. The public contract
is the JAX function's: layout ``[batch, heads, seq, head_dim]``; ``block_q``
and ``block_k`` clamped to the sequence lengths, and a ``ValueError`` for
lengths that are not multiples of them; a ``ValueError`` for causal with
``sq > sk``; a bottom-right causal mask (offset ``sk - sq``); finite
``-1e30`` masking.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for a CUDA
tensor (bf16 on the tensor cores, f32 on the CUDA cores) or raises. It takes
the plain version, :func:`attention_reference`, only for a tensor on the
CPU, which is where the tests run it. The block sizes are the TPU kernel's
tiling and are checked for the contract only: the CUDA kernel tiles by its
own 64 x 64 and masks ragged edges itself. Forward only: serving takes no
gradient, and the training slice brings the backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30  # finite "minus infinity": avoids inf-inf NaNs in masking
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535  # the kernel puts batch*heads on grid.y

_lib = None


class BlockDivisibilityError(ValueError):
    """A sequence length is no multiple of its clamped block size.

    The blocks are the TPU kernel's tiling, kept as the public contract;
    the CUDA kernel tiles by its own 64 x 64 and would take the length.
    Raised before any launch, so a caller may retry with other blocks.
    """


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False
) -> torch.Tensor:
    """Plain attention in f32, the numerical ground truth for the kernel.

    Shapes ``[..., seq, head_dim]``; softmax over the key axis; computed in
    f32 whatever the input dtype and returned in ``q.dtype``. With
    ``causal=True`` and ``sq != sk`` the mask is bottom-right aligned
    (query row r attends to keys ``<= r + sk - sq``).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[-2], k.shape[-2]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` for what the CUDA kernel does not take: mixed
    devices or dtypes, a dtype other than bf16/f32, a head_dim other than
    64/128, k and v of different shapes, non-contiguous or misaligned
    storage, or more than 65535 batch*heads."""
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash kernel takes head_dim 64 or 128, got {q.shape[-1]}"
        )
    if k.shape != v.shape or k.shape[:2] + k.shape[3:] != q.shape[:2] + q.shape[3:]:
        raise ValueError(
            f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not fit q "
            f"{tuple(q.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned storage; {name} is not")
    if q.shape[0] * q.shape[1] > _MAX_GRID_Y:
        raise ValueError(
            f"batch*heads = {q.shape[0] * q.shape[1]} > {_MAX_GRID_Y}"
        )


def _kernel():
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("flash_attention")
        fn = lib.dsst_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    check_kernel_inputs(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dsst_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, k.shape[2], d, int(causal),
            int(q.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    block_q: int = 256,
    block_k: int = 512,
) -> torch.Tensor:
    """Blockwise flash attention over ``[batch, heads, seq, head_dim]``.

    bf16 or f32 in, the same dtype out, f32 softmax statistics. A CUDA
    tensor goes through the hand-written kernel (``launches`` counts each
    launch); a CPU tensor through :func:`attention_reference`.
    """
    if q.ndim != 4:
        raise ValueError(f"expected [batch, heads, seq, head_dim], got {tuple(q.shape)}")
    sq, sk = q.shape[2], k.shape[2]
    if causal and sq > sk:
        # Bottom-right alignment gives the first sq - sk query rows zero
        # visible keys: their softmax denominator is 0.
        raise ValueError(
            f"causal flash attention needs sq <= sk, got sq={sq} sk={sk} "
            "(rows before the first key would attend to nothing)"
        )
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise BlockDivisibilityError(
            f"seq lengths ({sq}, {sk}) must be multiples of blocks "
            f"({block_q}, {block_k}); pad upstream"
        )
    if q.is_cuda:
        return _launch(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    return attention_reference(q, k, v, causal=causal)


flash_attention.launches = 0
