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
own 64 x 64 and masks ragged edges itself.

The gradient is the JAX function's custom VJP (``_flash_bwd``): the forward
saves ``(q, k, v)`` and the backward recomputes attention in query chunks of
``min(block_q, sq)`` rows, each differentiated on its own, so the backward
holds one chunk's ``chunk x sk`` scores at a time and never ``sq x sk``
(:func:`attention_backward`). JAX's backward is XLA, not Pallas, so the
port's is plain PyTorch on either device. ``launches`` counts the forward
kernel only.

Where one query tile per CTA would leave the card's SMs idle, as at every
serving bucket, :func:`split_plan` cuts the longest tiles' key ranges into
pieces that run in parallel; the kernel combines them in a fixed order.
:func:`split_attention_reference` is the plain version of that split and
combine.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

_NEG_INF = -1e30  # finite "minus infinity": avoids inf-inf NaNs in masking
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_KERNEL_HEAD_DIMS = (32, 64, 128)  # the kernel's tiles; narrower heads are zero-padded
_MAX_GRID_Y = 65535  # the f32 kernel puts batch*heads on grid.y
_Q_TILE, _K_TILE = 64, 64  # query rows of a bf16 kernel CTA; keys of a key tile
_CTAS_PER_SM = 2  # bf16 kernel CTAs resident on one SM (shared memory bounds it)
_MIN_PIECE = 2  # key tiles per split piece at least: shorter ones lose to the combine
# A query tile of at most this many key tiles is not split: the combine pass
# and the f32 partials cost more than the shorter chain saves. On an H100 the
# split lost at 8 tiles (causal s512) and won at 16 (s1024).
_MAX_UNSPLIT = 8

_lib = None
_plans: dict[tuple, tuple] = {}  # device copies of split plans, by shape and device
_plans_lock = threading.Lock()


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
    devices or dtypes, a dtype other than bf16/f32, a head_dim above 128,
    k and v of different shapes, non-contiguous or misaligned storage, or
    more than 65535 batch*heads. A head_dim under 128 that is not 32, 64
    or 128 is taken: :func:`_launch` pads it to the next of them."""
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes bfloat16 or float32, got {q.dtype}")
    if not 0 < q.shape[-1] <= _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(
            f"flash kernel takes head_dim 1..{_KERNEL_HEAD_DIMS[-1]}, got {q.shape[-1]} "
            "(wider heads are not ported)"
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


def visible_key_tiles(sq: int, sk: int, causal: bool) -> list[int]:
    """Key tiles of 64 that each 64-row query tile of the bf16 kernel
    walks: all of them, or with the causal mask those up to the tile's last
    row's last visible key (fully masked tiles are skipped)."""
    n_kt = -(-sk // _K_TILE)
    if not causal:
        return [n_kt] * -(-sq // _Q_TILE)
    return [min(n_kt, (min(q0 + _Q_TILE, sq) - 1 + sk - sq) // _K_TILE + 1)
            for q0 in range(0, sq, _Q_TILE)]


def split_plan(bh: int, sq: int, sk: int, causal: bool, sm_count: int):
    """How the bf16 kernel splits key ranges, or ``None`` for no split.

    One CTA per (head, query tile) leaves SMs idle when ``bh`` times the
    query tiles is under ``sm_count``, and a causal launch then lasts as
    long as its longest tile; where that tile is longer than
    ``_MAX_UNSPLIT`` key tiles, the plan cuts each tile's visible key range
    into pieces of at most ``chunk`` key tiles (sizes differing by at most
    one), with ``chunk`` the least, and at least ``_MIN_PIECE``, whose
    pieces of all heads still run in one wave of ``_CTAS_PER_SM`` CTAs per
    SM. No split when no tile is longer than ``chunk``.

    Returns ``(items, combine, n_slots)``: ``items`` are the work items
    ``(qt, kt_begin, kt_end, slot)`` in launch order, longest first
    (``slot = -1``: the piece is its tile's whole range and writes the
    output itself; else it writes partial slot ``slot``); ``combine`` lists
    ``(qt, first_slot, pieces)`` for each split tile, whose slots are
    consecutive and combined in slot order.
    """
    tiles = visible_key_tiles(sq, sk, causal)
    if bh * len(tiles) >= sm_count or max(tiles) <= _MAX_UNSPLIT:
        return None
    chunk = _MIN_PIECE
    slots = _CTAS_PER_SM * sm_count
    while chunk < max(tiles) and bh * sum(-(-n // chunk) for n in tiles) > slots:
        chunk += 1
    if max(tiles) <= chunk:
        return None
    items, combine, n_slots = [], [], 0
    for qt, n in enumerate(tiles):
        pieces = -(-n // chunk)
        if pieces == 1:
            items.append((qt, 0, n, -1))
            continue
        combine.append((qt, n_slots, pieces))
        base, extra = divmod(n, pieces)
        start = 0
        for i in range(pieces):
            size = base + (i < extra)
            items.append((qt, start, start + size, n_slots + i))
            start += size
        n_slots += pieces
    items.sort(key=lambda it: (it[1] - it[2], -it[0], it[1]))
    return items, combine, n_slots


def work_items(bh: int, sq: int, sk: int, causal: bool, sm_count: int):
    """The bf16 kernel's work items per head in launch order, as
    ``(qt, kt_begin, kt_end, slot)``: the split plan's, or without one each
    query tile whole, longest first (the kernel's own mapping)."""
    plan = split_plan(bh, sq, sk, causal, sm_count)
    if plan is not None:
        return plan[0]
    tiles = visible_key_tiles(sq, sk, causal)
    order = range(len(tiles) - 1, -1, -1) if causal else range(len(tiles))
    return [(qt, 0, tiles[qt], -1) for qt in order]


def split_attention_reference(q, k, v, *, causal: bool = False, plan) -> torch.Tensor:
    """Plain version of the bf16 kernel's split and combine, in f32.

    Each work item of ``plan`` (from :func:`split_plan`) takes softmax over
    its own key tiles: its output, normalized, and its log-sum-exp. A tile
    split in pieces combines them in slot order, each weighted by
    ``exp(lse - max lse)``. A row that sees no key of a piece (the causal
    diagonal) gets that piece's -1e30 scores at weight 1, as in the
    kernel; its log-sum-exp is then about -1e30 and its weight 0.
    """
    items, combine, _ = plan
    sq, sk = q.shape[-2], k.shape[-2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    parts = {}
    for qt, kb, ke, slot in items:
        r0, r1 = qt * _Q_TILE, min(qt * _Q_TILE + _Q_TILE, sq)
        c0, c1 = kb * _K_TILE, min(ke * _K_TILE, sk)
        s = torch.matmul(qf[..., r0:r1, :], kf[..., c0:c1, :].transpose(-1, -2)) * scale
        if causal:
            qi = torch.arange(r0, r1, device=q.device)[:, None] + (sk - sq)
            ki = torch.arange(c0, c1, device=q.device)[None, :]
            s = torch.where(qi >= ki, s, torch.full_like(s, _NEG_INF))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p, vf[..., c0:c1, :]) / l
        if slot < 0:
            out[..., r0:r1, :] = o
        else:
            parts[slot] = (o, m + torch.log(l))
    for qt, first, pieces in combine:
        r0, r1 = qt * _Q_TILE, min(qt * _Q_TILE + _Q_TILE, sq)
        lse = torch.stack([parts[first + i][1] for i in range(pieces)])
        w = torch.exp(lse - lse.amax(0))
        acc = sum(w[i] * parts[first + i][0] for i in range(pieces))
        out[..., r0:r1, :] = acc / w.sum(0)
    return out.to(q.dtype)


def _kernel():
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.dsst_flash_attention_fwd
        fn.argtypes = [p] * 4 + [i] * 6 + [p, i, p, i, p, p, i, p, ctypes.c_float]
        fn.restype = ctypes.c_int
        lib.dsst_flash_attention_smem_bytes.argtypes = [i]
        lib.dsst_flash_attention_smem_bytes.restype = i
        _lib = lib
    return _lib


def _device_plan(bh, sq, sk, causal, device):
    """The split plan on the device, made once per shape and device:
    ``(items, combine, n_items, n_combine, n_slots)``, or ``None``."""
    key = (bh, sq, sk, causal, device)
    with _plans_lock:
        if key in _plans:
            return _plans[key]
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    plan = split_plan(bh, sq, sk, causal, sm_count)
    if plan is not None:
        items, combine, n_slots = plan
        plan = (torch.tensor(items, dtype=torch.int32, device=device),
                torch.tensor([c + (0,) for c in combine], dtype=torch.int32, device=device),
                len(items), len(combine), n_slots)
    with _plans_lock:
        if len(_plans) >= 64:
            _plans.clear()
        _plans[key] = plan
    return plan


def padded_head_dim(d: int) -> int:
    """The kernel's head_dim for a head of ``d``: the least of 32, 64 and
    128 that holds it."""
    return next(w for w in _KERNEL_HEAD_DIMS if w >= d)


def _launch(q, k, v, causal: bool, split: bool = True) -> torch.Tensor:
    """Launch the kernel; ``split=False`` ignores the split plan (the
    measurement of what the plan buys uses it).

    A head_dim the kernel has no tile for is zero-padded to
    :func:`padded_head_dim` and the output sliced back: zero columns leave
    ``q @ k.T`` as it is and give zero output columns. The scale stays
    ``1/sqrt(d)`` of the true ``d``, passed to the kernel."""
    check_kernel_inputs(q, k, v)
    d_true = q.shape[-1]
    d_pad = padded_head_dim(d_true)
    if d_pad != d_true:
        q, k, v = (torch.nn.functional.pad(t, (0, d_pad - d_true)) for t in (q, k, v))
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lib = _kernel()
    plan = None
    if split and q.dtype == torch.bfloat16:
        plan = _device_plan(b * h, sq, k.shape[2], causal, q.device)
    args = (None, 0, None, 0, None, None, 0)  # no split
    if plan is not None:
        items, combine, n_items, n_combine, n_slots = plan
        part_o = torch.empty((b * h, n_slots, _Q_TILE, d), dtype=torch.float32, device=q.device)
        part_lse = torch.empty((b * h, n_slots, _Q_TILE), dtype=torch.float32, device=q.device)
        args = (items.data_ptr(), n_items, combine.data_ptr(), n_combine,
                part_o.data_ptr(), part_lse.data_ptr(), n_slots)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dsst_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, sq, k.shape[2], d, int(causal),
            int(q.dtype == torch.bfloat16), *args, stream, 1.0 / math.sqrt(d_true),
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out if d_pad == d_true else out[..., :d_true].contiguous()


def _masked_scores(q, k, start: int, sk: int, sq: int, causal: bool) -> torch.Tensor:
    """f32 scores of query rows ``[start, start + rows)`` against every key,
    scaled by ``1/sqrt(d)``, with the bottom-right causal mask."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        qi = torch.arange(start, start + q.shape[-2], device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(qi < ki, _NEG_INF)
    return s


def attention_backward(q, k, v, g, *, causal: bool, chunk: int):
    """``(dq, dk, dv)`` of attention at ``(q, k, v)`` for the output
    cotangent ``g``: the port of the JAX ``_flash_bwd``.

    Each chunk of ``chunk`` query rows is recomputed as ``_chunked_reference``
    computes it (f32 scores times ``1/sqrt(d)``, the bottom-right mask at
    ``start + sk - sq`` filled with -1e30, f32 softmax, ``P @ v`` in f32,
    the result cast to ``q.dtype``) and differentiated with
    ``torch.autograd.grad``. ``dk`` and ``dv`` are summed over the chunks in
    f32 and cast once; JAX sums them in the transpose of its ``lax.map``.
    Only one chunk's ``chunk x sk`` scores are alive at a time.
    """
    sq, sk = q.shape[-2], k.shape[-2]
    if sq % chunk:
        raise ValueError(f"sq={sq} is no multiple of the chunk {chunk}")
    kf = k.detach().float().requires_grad_()
    vf = v.detach().float().requires_grad_()
    dq = torch.empty_like(q)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for start in range(0, sq, chunk):
        with torch.enable_grad():
            qc = q[..., start:start + chunk, :].detach().float().requires_grad_()
            p = torch.softmax(_masked_scores(qc, kf, start, sk, sq, causal), dim=-1)
            out = torch.matmul(p, vf).to(q.dtype)
            dqc, dkc, dvc = torch.autograd.grad(out, (qc, kf, vf), g[..., start:start + chunk, :])
        dq[..., start:start + chunk, :] = dqc
        dk += dkc
        dv += dvc
        del p, out, dqc, dkc, dvc
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The kernel (or, for a CPU tensor, the plain version) forward and the
    chunked recompute backward, as the JAX ``_flash`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        if q.is_cuda:
            return _launch(q, k, v, causal)
        if q.device.type != "cpu":
            raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
        return attention_reference(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, g, causal=ctx.causal, chunk=ctx.chunk)
        return dq, dk, dv, None, None


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

    bf16 or f32 in, the same dtype out, f32 softmax statistics;
    differentiable (the backward recomputes in chunks of ``block_q`` rows).
    A CUDA tensor goes through the hand-written kernel (``launches`` counts
    each launch); a CPU tensor through :func:`attention_reference`.
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
    return _FlashAttention.apply(q, k, v, causal, block_q)


flash_attention.launches = 0
