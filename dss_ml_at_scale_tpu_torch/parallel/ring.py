"""Ring attention: the port of ``dss_ml_at_scale_tpu/parallel/ring.py``.

Exact attention over a sequence sharded across the ranks of a process
group. Each rank keeps its q shard; the k/v shards travel one hop round the
ring per step (:func:`..runtime.distributed.ring_shift`, whose gradient
takes the hop back), so the ring pays ``ranks - 1`` hops. Each step
attends the local q to the visiting chunk in f32 and returns the chunk's
normalized output and row log-sum-exp; the chunks merge with the
online-softmax rescaling, as in JAX. The chunk compute stays plain torch,
as JAX keeps it in plain XLA: the merge needs the log-sum-exp, which the
flash kernel does not return.

Each chunk is checkpointed (``torch.utils.checkpoint``, as
``jax.checkpoint``): the backward recomputes the chunk's scores instead of
keeping ``ranks`` score matrices. Causality is masked per (q shard, k/v
chunk) pair by global offsets: a fully masked chunk has ``lse ~ -1e30``
and merges with weight ``exp(-1e30 - lse) == 0``.

:func:`sharded_next_token_loss` is the next-token loss of a
sequence-sharded model: each rank's share of the global mean over
``b * (S - 1)`` positions, its last target taken from the next shard.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..runtime import distributed as rt

_NEG_INF = -1e30


def _chunk_attention(q, k, v, q_off: int, k_off: int, causal: bool):
    """``(out, lse)`` of the local q against one k/v chunk, in f32."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        qi = q_off + torch.arange(q.shape[2], device=q.device)[:, None]
        ki = k_off + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(qi < ki, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l
    return out, (m + torch.log(l))[..., 0]


def _merge(o1, lse1, o2, lse2):
    """Exact combination of two chunk-normalized outputs."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    out = (o1 * w1[..., None] + o2 * w2[..., None]) / denom[..., None]
    return out, m + torch.log(denom)


def _chunk(q, k, v, q_off, k_off, causal):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return checkpoint(_chunk_attention, q, k, v, q_off, k_off, causal,
                          use_reentrant=False)
    return _chunk_attention(q, k, v, q_off, k_off, causal)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention of this rank's shards ``[b, heads, S / ranks, d]``
    of q, k and v, the sequence split over ``group`` in rank order; returns
    this rank's shard of the output, in q's dtype."""
    if q.ndim != 4:
        raise ValueError(f"expected [batch, heads, seq, head_dim], got {tuple(q.shape)}")
    if q.shape[2] != k.shape[2]:
        raise ValueError("ring attention requires sq == sk (self-attention)")
    ranks, me = rt.group_size(group), rt.group_rank(group)
    s_local = q.shape[2]
    out, lse = _chunk(q, k, v, me * s_local, me * s_local, causal)
    kv = torch.stack((k, v))
    for i in range(1, ranks):
        # Hop first, then compute: the local chunk was taken above, so the
        # ring pays ranks - 1 hops.
        kv = rt.ring_shift(kv, group)
        src = (me - i) % ranks  # the global chunk visiting this step
        o_c, lse_c = _chunk(q, kv[0], kv[1], me * s_local, src * s_local, causal)
        out, lse = _merge(out, lse, o_c, lse_c)
    return out.to(q.dtype)


def sequence_shard(tokens: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's shard of ``[b, S]`` tokens (S split in rank order)."""
    ranks = rt.group_size(group)
    if tokens.shape[1] % ranks:
        raise ValueError(f"seq length {tokens.shape[1]} not divisible by the {ranks} ranks")
    s_local = tokens.shape[1] // ranks
    me = rt.group_rank(group)
    return tokens[:, me * s_local:(me + 1) * s_local]


def sharded_next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                            group=None) -> torch.Tensor:
    """This rank's share of ``next_token_loss`` over the whole sequence:
    ``logits`` ``[b, S / ranks, vocab]`` of its shard, ``tokens`` the whole
    ``[b, S]``. The shares of the ranks sum to the global mean."""
    b, seq = tokens.shape
    s_local = logits.shape[1]
    offset = rt.group_rank(group) * s_local
    n = min(s_local, seq - 1 - offset)  # the last position has no target
    logp = torch.log_softmax(logits[:, :n].float(), dim=-1)
    tgt = tokens[:, offset + 1:offset + 1 + n].long()
    return -logp.gather(-1, tgt[..., None]).sum() / (b * (seq - 1))
