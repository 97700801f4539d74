"""Fused BN-apply + ReLU + 1x1 conv (a matrix product) with a byte-minimal
backward: three hand-written Hopper kernels and their plain versions.

Port of ``dss_ml_at_scale_tpu/ops/fused_matmul.py``. At the middle BN site
of every bottleneck block the conv output ``y`` is normalized, rectified and
fed to the third (1x1) conv; here the normalize + ReLU runs as the prologue
of the product, so the normalized activation never reaches device memory:

    forward   out = bf16(relu(y*s + t [+ res])) @ W                  (K1)
    backward  gt  = (g @ W^T) * [y*s + t (+ res) > 0], with the      (K2)
                    channel sums sum(gt) and sum(gt * x_hat)
              dW  = bf16(relu(y*s + t [+ res]))^T @ g                (K3)

with ``s = gamma * rsqrt(var + eps)`` and ``t = beta - mean * s``. The
elementwise ``dy`` finish stays in torch ops, as it stays HLO in JAX:
``dy = s * (gt - (sum_g + x_hat * sum_gx) / n_count)`` with the batch
statistics' dependence on ``y`` internalized, so the op returns no gradient
for ``mean`` and ``var`` (flax's stop-gradient running averages), or
``dy = s * gt`` with ``batch_stats=False`` (eval, frozen BN). ``dgamma`` and
``dbeta`` are the two sums, ``dres`` is ``gt``. Across ranks (``group=``,
the JAX op's ``axis_name``) the statistics are global: K2's two sums are
all-reduced before the finish, which divides by the global row count,
while ``dgamma``, ``dbeta`` and ``dW`` stay the rank's own (data
parallelism averages them, as the JAX transpose sums them).

Each kernel's wrapper (:func:`bn_relu_matmul_fwd`, :func:`bn_relu_matmul_bwd_da`,
:func:`bn_relu_matmul_bwd_dw`) launches ``csrc/fused_matmul.cu`` for CUDA
tensors, or raises for what the kernel does not take (a dtype other than
bf16, strided or misaligned storage, K or N not a multiple of 8); it runs
the plain version (``*_reference``) only for tensors on the CPU. Each
counts its launches in ``.launches``. The TPU pads M to 512 and K, N to 128
(its tiling); the CUDA kernels take any M and mask the ragged edge, and
``n_count`` is the real row count. f32 tensors on the card are refused:
the training path is bf16, and the f32 variants are still to write.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .fused_norm import reduce_grad_sums

# Tile constants of csrc/fused_matmul.cu that the plans below and the
# scratch the wrappers allocate follow. K1 walks 128 x 256 output tiles
# (kFwdBM, kFwdBN). K2 walks 128-row tiles of gt (kDaBM), ``da_tile_n``
# channels wide, and writes one row of channel sums per CTA. K3 sums M in
# runs that are multiples of its ring's 64 rows (kDwBM) for ``dw_tile_k``
# x 256 tiles of dW (kDwBN). The tile widths are chosen here and passed to
# the kernels, which take no other.
_FWD_TILE_M, _FWD_TILE_N = 128, 256
_DA_TILE_M = 128
_DW_TILE_N, _DW_DEPTH = 256, 64
# TMA coordinates and the kernels' row indices are 32-bit signed integers.
_MAX_ROWS = 2 ** 31 - 1

_lib = None


# ---------------------------------------------------------------------------
# Plain versions: the same arithmetic in torch ops (f32 products of the
# rounded operands), the CPU path and the card's yardstick.
# ---------------------------------------------------------------------------

def _z(y2, s, t, res):
    z = y2.float() * s + t
    if res is not None:
        z = z + res.float()
    return z


def bn_relu_matmul_fwd_reference(y2, s, t, w, res=None) -> torch.Tensor:
    """K1's function: ``out[M,N] = bf16(relu(y*s + t [+ res])) @ W`` in
    ``y.dtype``; ``a`` is rounded to ``y.dtype`` before the f32 product."""
    a = torch.clamp_min(_z(y2, s, t, res), 0.0).to(y2.dtype)
    return torch.matmul(a.float(), w.float()).to(y2.dtype)


def bn_relu_matmul_bwd_da_reference(g, w, y2, s, t, mean, inv, res=None):
    """K2's function: ``(gt in y.dtype, sum_g, sum_gx)``, the sums from the
    f32 ``gt``."""
    da = torch.matmul(g.float(), w.float().t())
    gt = torch.where(_z(y2, s, t, res) > 0.0, da, torch.zeros_like(da))
    x_hat = (y2.float() - mean) * inv
    return gt.to(y2.dtype), gt.sum(0), (gt * x_hat).sum(0)


def bn_relu_matmul_bwd_dw_reference(y2, s, t, g, res=None) -> torch.Tensor:
    """K3's function: ``dW[K,N] = bf16(relu(y*s + t [+ res]))^T @ g`` in f32."""
    a = torch.clamp_min(_z(y2, s, t, res), 0.0).to(y2.dtype)
    return torch.matmul(a.float().t(), g.float())


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _kernel():
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("fused_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dsst_bn_relu_matmul_fwd.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.dsst_bn_relu_matmul_fwd_smem_bytes.argtypes = [i, i]
        lib.dsst_bn_relu_matmul_fwd_smem_bytes.restype = i
        lib.dsst_bn_relu_matmul_bwd_da.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.dsst_bn_relu_matmul_bwd_dw.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.dsst_bn_relu_matmul_bwd_da_smem_bytes.argtypes = [i, i]
        lib.dsst_bn_relu_matmul_bwd_dw_smem_bytes.argtypes = [i, i]
        lib.dsst_bn_relu_matmul_bwd_da_smem_bytes.restype = i
        lib.dsst_bn_relu_matmul_bwd_dw_smem_bytes.restype = i
        for fn in (lib.dsst_bn_relu_matmul_fwd, lib.dsst_bn_relu_matmul_bwd_da,
                   lib.dsst_bn_relu_matmul_bwd_dw):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_kernel_inputs(m: int, k: int, n: int, *, bf16=(), f32=(), shapes=()) -> None:
    """Raise ``ValueError`` for what the kernels do not take: tensors on
    different devices, bf16 operands of another dtype, channel vectors
    other than f32, a wrong shape, strided or misaligned storage, K or N
    not a multiple of 8, or more rows than 32-bit row indices hold."""
    tensors = [x for x in bf16 + f32 if x is not None]
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused matmul inputs on different devices: {sorted(map(str, devices))}")
    for x in bf16:
        if x is not None and x.dtype != torch.bfloat16:
            raise ValueError(f"fused matmul kernels take bfloat16 operands, got {x.dtype}")
    for x in f32:
        if x.dtype != torch.float32:
            raise ValueError(f"fused matmul channel vectors must be float32, got {x.dtype}")
    for x, want in shapes:
        if x is not None and tuple(x.shape) != tuple(want):
            raise ValueError(f"fused matmul operand of shape {tuple(x.shape)}, want {tuple(want)}")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("fused matmul kernels need contiguous tensors")
        if x.data_ptr() % 16:
            raise ValueError("fused matmul kernels need 16-byte aligned storage")
    if k % 8 or n % 8:
        raise ValueError(f"fused matmul kernels need K and N multiples of 8, got K={k}, N={n}")
    if not 1 <= m <= _MAX_ROWS:
        raise ValueError(f"fused matmul kernels take 1..{_MAX_ROWS} rows, got {m}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_if(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _on_cpu_or_raise(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on cuda or cpu, got {x.device}")


def _sm_count(x: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def fwd_tile_walk(m: int, n: int, sm_count: int) -> list[list[tuple[int, int]]]:
    """K1's persistent walk: for each of its ``min(tiles, sm_count)`` CTAs,
    the ``(row, column)`` origins of the 128 x 256 output tiles it computes,
    in order. Tile ``i`` is row tile ``i % tiles_m`` of column band
    ``i // tiles_m`` (M first within a band of N), and CTA ``c`` takes tiles
    ``c, c + grid, c + 2 grid, ...``, as the kernel does."""
    tiles_m = -(-m // _FWD_TILE_M)
    tiles = tiles_m * -(-n // _FWD_TILE_N)
    grid = min(tiles, sm_count)
    return [[((i % tiles_m) * _FWD_TILE_M, (i // tiles_m) * _FWD_TILE_N)
             for i in range(c, tiles, grid)] for c in range(grid)]


def bn_relu_matmul_fwd(y2, s, t, w, res=None) -> torch.Tensor:
    """K1 on the card, or its plain version for CPU tensors."""
    if not y2.is_cuda:
        _on_cpu_or_raise(y2, "bn_relu_matmul_fwd")
        return bn_relu_matmul_fwd_reference(y2, s, t, w, res)
    m, k = y2.shape
    n = w.shape[1]
    check_kernel_inputs(m, k, n, bf16=(y2, w, res), f32=(s, t),
                        shapes=((w, (k, n)), (res, (m, k)), (s, (k,)), (t, (k,))))
    out = torch.empty((m, n), dtype=y2.dtype, device=y2.device)
    lib = _kernel()
    with torch.cuda.device(y2.device):
        rc = lib.dsst_bn_relu_matmul_fwd(
            y2.data_ptr(), _ptr(res), s.data_ptr(), t.data_ptr(), w.data_ptr(),
            out.data_ptr(), m, k, n, _sm_count(y2), _stream(y2))
    _raise_if(rc, "bn_relu_matmul_fwd")
    bn_relu_matmul_fwd.launches += 1
    return out


def da_tile_n(k: int) -> int:
    """K2's tile width, the wgmma N dimension: 64 channels at K <= 64, else
    128 (256-wide tiles ran slower at stages 3-4: PERF.md)."""
    return 64 if k <= 64 else 128


def da_tile_walk(m: int, k: int, bn: int, sm_count: int) -> list[list[tuple[int, int]]]:
    """K2's persistent walk: for each of its ``min(tiles, sm_count)`` CTAs,
    the ``(row, channel)`` origins of the 128 x ``bn`` tiles of gt it
    computes, in order. Tile ``i`` is channel band ``i % tiles_k`` of row
    tile ``i // tiles_k`` (the bands of an M band first), and CTA ``c`` takes
    tiles ``c, c + grid, ...``, as the kernel does. It is a fixed function of
    its arguments, so each CTA's row of channel sums is added in the same
    order on every run."""
    tiles_k = -(-k // bn)
    tiles = -(-m // _DA_TILE_M) * tiles_k
    grid = min(tiles, sm_count)
    return [[((i // tiles_k) * _DA_TILE_M, (i % tiles_k) * bn) for i in range(c, tiles, grid)]
            for c in range(grid)]


def bn_relu_matmul_bwd_da(g, w, y2, s, t, mean, inv, res=None):
    """K2 on the card (then its fixed-order second pass over the CTAs' rows
    of channel sums), or its plain version for CPU tensors."""
    if not g.is_cuda:
        _on_cpu_or_raise(g, "bn_relu_matmul_bwd_da")
        return bn_relu_matmul_bwd_da_reference(g, w, y2, s, t, mean, inv, res)
    m, k = y2.shape
    n = w.shape[1]
    check_kernel_inputs(m, k, n, bf16=(g, w, y2, res), f32=(s, t, mean, inv),
                        shapes=((g, (m, n)), (w, (k, n)), (res, (m, k)), (s, (k,)),
                                (t, (k,)), (mean, (k,)), (inv, (k,))))
    bn = da_tile_n(k)
    sm_count = _sm_count(y2)
    grid = min(-(-m // _DA_TILE_M) * -(-k // bn), sm_count)
    gt = torch.empty((m, k), dtype=y2.dtype, device=y2.device)
    partial = torch.empty((grid, 2 * k), dtype=torch.float32, device=y2.device)
    sums = torch.empty((2, k), dtype=torch.float32, device=y2.device)
    lib = _kernel()
    with torch.cuda.device(y2.device):
        rc = lib.dsst_bn_relu_matmul_bwd_da(
            g.data_ptr(), w.data_ptr(), y2.data_ptr(), _ptr(res), s.data_ptr(),
            t.data_ptr(), mean.data_ptr(), inv.data_ptr(), gt.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), m, k, n, bn, sm_count, _stream(y2))
    _raise_if(rc, "bn_relu_matmul_bwd_da")
    bn_relu_matmul_bwd_da.launches += 1
    return gt, sums[0], sums[1]


def dw_tile_k(k: int) -> int:
    """K3's output tile height, the channels of dW per CTA: 64 at K <= 64
    (the kernel's two warpgroups then share the tile, on alternate ring
    stages), else 128 (64 each)."""
    return 64 if k <= 64 else 128


def dw_plan(m: int, k: int, n: int, sm_count: int) -> tuple[int, int]:
    """``(splits, chunk)``: K3 sums M in ``splits`` runs of ``chunk`` rows,
    a multiple of its ring's 64-row depth (no ring stage crosses into the
    next run: TMA zero-fills only at the tensor's edge), for every
    ``dw_tile_k(k)`` x 256 output tile. As many runs as fill the SMs once
    with one CTA per (tile, run), at least one ring stage each."""
    tiles = -(-k // dw_tile_k(k)) * -(-n // _DW_TILE_N)
    splits = max(1, min(sm_count // tiles, -(-m // _DW_DEPTH)))
    chunk = -(-(-(-m // splits)) // _DW_DEPTH) * _DW_DEPTH
    return -(-m // chunk), chunk


def dw_work(m: int, k: int, n: int, sm_count: int) -> list[tuple[int, int, int, int]]:
    """K3's work items in CTA order: ``(channel, column, first row, end
    row)`` of each CTA's output tile and run of M, the tiles of one run
    neighbours, as the kernel reads ``blockIdx.x``."""
    splits, chunk = dw_plan(m, k, n, sm_count)
    tile_k = dw_tile_k(k)
    tiles_k = -(-k // tile_k)
    tiles = tiles_k * -(-n // _DW_TILE_N)
    return [((b % tiles % tiles_k) * tile_k, (b % tiles // tiles_k) * _DW_TILE_N,
             (b // tiles) * chunk, min(m, (b // tiles + 1) * chunk))
            for b in range(tiles * splits)]


def bn_relu_matmul_bwd_dw(y2, s, t, g, res=None) -> torch.Tensor:
    """K3 on the card (then its fixed-order second pass over the M runs),
    or its plain version for CPU tensors. Returns dW in f32."""
    if not y2.is_cuda:
        _on_cpu_or_raise(y2, "bn_relu_matmul_bwd_dw")
        return bn_relu_matmul_bwd_dw_reference(y2, s, t, g, res)
    m, k = y2.shape
    n = g.shape[1]
    check_kernel_inputs(m, k, n, bf16=(y2, g, res), f32=(s, t),
                        shapes=((g, (m, n)), (res, (m, k)), (s, (k,)), (t, (k,))))
    splits, chunk = dw_plan(m, k, n, _sm_count(y2))
    partial = torch.empty((splits, k, n), dtype=torch.float32, device=y2.device)
    dw = torch.empty((k, n), dtype=torch.float32, device=y2.device)
    lib = _kernel()
    with torch.cuda.device(y2.device):
        rc = lib.dsst_bn_relu_matmul_bwd_dw(
            y2.data_ptr(), _ptr(res), s.data_ptr(), t.data_ptr(), g.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), m, k, n, dw_tile_k(k), splits, chunk,
            _stream(y2))
    _raise_if(rc, "bn_relu_matmul_bwd_dw")
    bn_relu_matmul_bwd_dw.launches += 1
    return dw


bn_relu_matmul_fwd.launches = 0
bn_relu_matmul_bwd_da.launches = 0
bn_relu_matmul_bwd_dw.launches = 0


# ---------------------------------------------------------------------------
# The op: forward K1, backward K2 then K3 and the elementwise finish
# ---------------------------------------------------------------------------

class _BnReluMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y2, gamma, beta, mean, var, w, res2, eps, batch_stats, n_count, group):
        inv = torch.rsqrt(var + eps)
        s = gamma * inv
        t = beta - mean * s
        out = bn_relu_matmul_fwd(y2, s, t, w, res2)
        # Saved: y (the conv output, alive anyway for its own conv's
        # backward), the channel vectors, W and the residual; the
        # normalized activation is never materialized.
        ctx.save_for_backward(y2, s, t, mean, inv, w, res2)
        ctx.batch_stats = batch_stats
        ctx.n_count = float(n_count)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        y2, s, t, mean, inv, w, res2 = ctx.saved_tensors
        g = g.contiguous()
        gt, sum_g, sum_gx = bn_relu_matmul_bwd_da(g, w, y2, s, t, mean, inv, res2)
        dw = bn_relu_matmul_bwd_dw(y2, s, t, g, res2)
        # The finish reads the STORED gt (y.dtype), as JAX's does.
        gt32 = gt.float()
        if ctx.batch_stats:
            all_g, all_gx = reduce_grad_sums(sum_g, sum_gx, ctx.group)
            x_hat = (y2.float() - mean) * inv
            dy32 = s * (gt32 - (all_g + x_hat * all_gx) / ctx.n_count)
        else:
            dy32 = s * gt32
        dres = gt if res2 is not None else None
        return (dy32.to(y2.dtype), sum_gx, sum_g, None, None, dw.to(w.dtype), dres,
                None, None, None, None)


def bn_relu_matmul(
    y: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    kernel: torch.Tensor,
    *,
    eps: float = 1e-5,
    residual: torch.Tensor | None = None,
    global_count: int | None = None,
    batch_stats: bool = True,
    group=None,
) -> torch.Tensor:
    """``relu(BN(y)) @ W`` (a 1x1 conv) without materializing the
    normalized activation.

    ``y`` is the raw conv output ``[..., K]`` (NHWC or flattened);
    ``gamma``/``beta``/``mean``/``var`` are ``[K]`` (f32); ``kernel`` is
    ``[K, N]`` or the 1x1 conv's ``[1, 1, K, N]`` (HWIO, as in JAX).
    With ``batch_stats=True`` (training) ``mean``/``var`` must be the batch
    statistics of ``y``; their dependence on ``y`` is internalized by the
    backward. ``residual`` (shape of ``y``) is added before the ReLU.
    ``global_count`` overrides the statistics' row count. With ``group``
    (a process group; the JAX op's ``axis_name``) ``mean``/``var`` are the
    statistics of every rank's ``y``, K2's sums are all-reduced over it,
    and ``global_count`` is the row count of every rank together. Returns
    ``[..., N]`` in ``y.dtype``.
    """
    if kernel.ndim == 4:
        if tuple(kernel.shape[:2]) != (1, 1):
            raise ValueError(f"not a 1x1 kernel: {tuple(kernel.shape)}")
        kernel = kernel[0, 0]
    k, n = kernel.shape
    if y.shape[-1] != k:
        raise ValueError(f"y channels {y.shape[-1]} != kernel K {k}")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != y shape {tuple(y.shape)}")
    if y.is_cuda and not y.is_contiguous():
        # The [M, K] operand must be a view of y (a channels_last conv
        # output), never a copy.
        raise ValueError("bn_relu_matmul needs a contiguous channels-last y on the card")
    lead = y.shape[:-1]
    m = math.prod(lead)
    y2 = y.reshape(m, k)
    res2 = residual.reshape(m, k) if residual is not None else None
    out = _BnReluMatmul.apply(
        y2, gamma.float(), beta.float(), mean.float(), var.float(), kernel, res2,
        float(eps), bool(batch_stats), int(global_count if global_count is not None else m), group)
    return out.reshape(*lead, n)
