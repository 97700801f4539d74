"""Decoder-only Transformer LM: port of ``dss_ml_at_scale_tpu/models/transformer.py``.

Same model, same numbers: RMSNorm pre-norm blocks, a dense tanh-GELU MLP,
learned position embeddings, and attention chosen by name ("flash" runs the
hand-written kernel of :mod:`..ops.flash_attention` on the card, "reference"
the plain version). Parameters are f32, as flax keeps them; each product
rounds where flax rounds:

- ``nn.Dense(dtype=bf16)`` casts its input and its f32 kernel (and bias) to
  bf16, and the bias is added after the product is rounded;
- ``nn.Embed(dtype=bf16)`` casts the table; the position table is cast and
  added in bf16;
- RMSNorm computes in f32 and casts to the model dtype;
- ``lm_head`` is an f32 product of the promoted bf16 input;
- GELU is flax's default, the tanh approximation.

The KV cache is a tuple of ``{"k", "v"}`` tensors per layer, shaped
``[batch, heads, len, head_dim]``. Where JAX returns a new cache, the port
writes the given one in place and returns it. A single-token decode step
takes ``pos`` as an int or as one position per row (the serving arena's
per-slot positions); nothing clamps an out-of-range position, so callers
bound it (``generate`` and the serving engine do).

``ffn="moe"`` swaps every block's MLP for the top-1 :class:`..moe.MoEMLP`
(in all three passes: full, prefill and decode). With ``expert_group`` a
full pass routes over the tokens of every rank of the group, and with
``shard_experts`` each rank computes its share of the experts; a cached
pass (generation) routes the process's own tokens.

``attention="ring"`` runs :func:`..parallel.ring.ring_attention` over
``group``: the model then takes this rank's shard of the sequence
(``[b, S / ranks]``, rank order) and places it at its global positions.
It does not decode, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import (
    BlockDivisibilityError,
    attention_reference,
    flash_attention,
)
from ..runtime import distributed as rt


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The RMSNorm expression in f32 (the result stays f32)."""
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return norm * scale


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps).to(self.dtype)


def _dense(x: torch.Tensor, linear: nn.Linear, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``; the bias is added to the rounded product."""
    y = F.linear(x.to(dtype), linear.weight.to(dtype))
    if linear.bias is not None:
        y = y + linear.bias.to(dtype)
    return y


def _select_attention(kind: str, group=None) -> Callable:
    if kind == "flash":
        return lambda q, k, v: flash_attention(q, k, v, causal=True)
    if kind == "flash_one_block":
        # One block per sequence: any length meets the block contract.
        return lambda q, k, v: flash_attention(
            q, k, v, causal=True, block_q=q.shape[2], block_k=k.shape[2])
    if kind == "reference":
        return lambda q, k, v: attention_reference(q, k, v, causal=True)
    if kind == "ring":
        if group is None:
            raise ValueError("attention='ring' needs group= (the ranks the sequence is sharded over)")
        from ..parallel.ring import ring_attention

        return lambda q, k, v: ring_attention(q, k, v, group=group, causal=True)
    raise ValueError(f"unknown attention backend {kind!r}")


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, device=None, *, ffn: str = "dense",
                 num_experts: int = 0, capacity_factor: float = 1.25,
                 router_noise: float = 0.0):
        super().__init__()
        if ffn not in ("dense", "moe"):
            raise ValueError(f"unknown ffn {ffn!r}: expected 'dense' or 'moe'")
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm1 = RMSNorm(dim, dtype=dtype, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
        self.proj = nn.Linear(dim, dim, bias=False, device=device)
        self.norm2 = RMSNorm(dim, dtype=dtype, device=device)
        if ffn == "moe":
            from .moe import MoEMLP

            self.moe = MoEMLP(dim, num_experts, mlp_ratio, capacity_factor, dtype,
                              router_noise, device=device)
        else:
            self.mlp_up = nn.Linear(dim, mlp_ratio * dim, device=device)
            self.mlp_down = nn.Linear(mlp_ratio * dim, dim, device=device)

    def forward(self, x, attention_fn=None, *, cache=None, pos=None, **moe_kw):
        """Full-context pass, or with ``cache``: a decode step (``x`` is
        ``[b, 1, dim]``, ``pos`` a LongTensor ``[b]``) or a pos-0 prefill
        writing the whole chunk's k/v into the cache. ``moe_kw`` goes to
        the MoE layer (``group``, ``shard_experts``, ``deterministic``,
        ``generator``)."""
        b, s, dim = x.shape
        head_dim = dim // self.num_heads

        h = self.norm1(x)
        q, k, v = _dense(h, self.qkv, self.dtype).split(dim, dim=-1)

        def heads(t):  # [b, s, dim] -> [b, heads, s, head_dim]
            return t.reshape(b, s, self.num_heads, head_dim).transpose(1, 2)

        if cache is not None and s == 1:
            # Decode step: write this token's k/v at each row's position,
            # then attend the single query over the cache with a <= pos
            # mask. Plain matmuls, as in JAX: at q_len 1 there is nothing
            # for a kernel to tile.
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, :, pos] = heads(k)[:, :, 0].to(cache["k"].dtype)
            cache["v"][rows, :, pos] = heads(v)[:, :, 0].to(cache["v"].dtype)
            k_all, v_all = cache["k"], cache["v"]
            scores = torch.matmul(
                heads(q).float(), k_all.float().transpose(-1, -2)
            ) / math.sqrt(head_dim)
            mask = torch.arange(k_all.shape[2], device=x.device)[None, :] <= pos[:, None]
            scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
            probs = torch.softmax(scores, dim=-1)
            attn = torch.matmul(probs, v_all.float()).to(self.dtype)
        else:
            if cache is not None:
                # Prefill (pos == 0, enforced by TransformerLM): the whole
                # prompt in one causal pass; its k/v land at [0, s).
                cache["k"][:, :, :s] = heads(k).to(cache["k"].dtype)
                cache["v"][:, :, :s] = heads(v).to(cache["v"].dtype)
            # The kernel takes contiguous [b, heads, s, head_dim] tensors.
            attn = attention_fn(*(heads(t).contiguous() for t in (q, k, v)))
        attn = attn.transpose(1, 2).reshape(b, s, dim)
        x = x + _dense(attn, self.proj, self.dtype)

        h = self.norm2(x)
        if hasattr(self, "moe"):
            return x + self.moe(h, **moe_kw)
        h = F.gelu(_dense(h, self.mlp_up, self.dtype), approximate="tanh")
        return x + _dense(h, self.mlp_down, self.dtype)


class TransformerLM(nn.Module):
    """Causal LM: token + learned position embeddings, N pre-norm blocks.

    ``attention``: "flash" (the hand-written kernel on the card),
    "reference", or "ring" (sequence-parallel over ``group``). ``ffn``:
    "dense", or "moe" with ``num_experts``, ``capacity_factor`` and
    ``router_noise`` (its routing over ``expert_group``, its experts split
    over it with ``shard_experts``). "moe" with "ring" routes over the ring
    ``group``: each rank's sequence shard takes its places in the global
    ``[b, S]`` batch's token order, as JAX routes it (:mod:`.moe`).
    """

    def __init__(self, vocab_size: int, dim: int = 512, num_heads: int = 8,
                 num_layers: int = 4, max_seq: int = 2048, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, attention: str = "flash",
                 ffn: str = "dense", device=None, *, num_experts: int = 0,
                 capacity_factor: float = 1.25, router_noise: float = 0.0,
                 group=None, expert_group=None, shard_experts: bool = False):
        super().__init__()
        if ffn not in ("dense", "moe"):
            raise ValueError(f"unknown ffn {ffn!r}: expected 'dense' or 'moe'")
        if ffn == "moe" and num_experts < 1:
            raise ValueError("ffn='moe' requires num_experts >= 1")
        if ffn == "moe" and attention == "ring" and expert_group not in (None, group):
            raise ValueError("a ring model's MoE routes over the ring group: pass no "
                             "expert_group, or the ring group")
        _select_attention(attention, group)  # fail at construction, not first use
        self.group = group
        self.expert_group = expert_group
        self.shard_experts = shard_experts
        self.ffn = ffn
        self.vocab_size = vocab_size
        self.dim = dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.max_seq = max_seq
        self.dtype = dtype
        self.attention = attention
        self.tok_embed = nn.Embedding(vocab_size, dim, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(max_seq, dim, device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio, dtype, device=device, ffn=ffn,
                             num_experts=num_experts, capacity_factor=capacity_factor,
                             router_noise=router_noise)
            for _ in range(num_layers)
        )
        self.norm = RMSNorm(dim, dtype=dtype, device=device)
        self.lm_head = nn.Linear(dim, vocab_size, bias=False, device=device)

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def forward(self, tokens: torch.Tensor, *, cache=None, pos=None,
                attention: str | None = None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """``[b, s]`` int tokens -> ``[b, s, vocab]`` f32 logits; with
        ``cache``/``pos``: ``(logits, cache)`` — one decode step on
        ``[b, 1]`` tokens (logits ``[b, vocab]``) or a pos-0 prefill of the
        whole prompt (logits ``[b, s, vocab]``). ``attention`` overrides
        the model's backend for this call (the retry of :func:`generate`
        at prompt lengths off the flash block contract). ``deterministic``
        False with a ``generator`` jitters the MoE routers
        (``router_noise``)."""
        b, s = tokens.shape
        decoding = cache is not None
        ring = (attention or self.attention) == "ring"
        if decoding and ring:
            raise ValueError(
                "KV-cache decode is single-process; a sequence-sharded (ring) model "
                "should decode with attention='flash' or 'reference' on the gathered "
                "sequence")
        # A ring model takes this rank's shard of the sequence.
        offset = rt.group_rank(self.group) * s if ring else 0
        length = s * rt.group_size(self.group) if ring else s
        if length > self.max_seq:
            raise ValueError(f"seq {length} > max_seq {self.max_seq}")
        if decoding and s > 1 and (not isinstance(pos, int) or pos != 0):
            # A multi-token cached pass attends only WITHIN the chunk;
            # continuing from a non-empty cache would silently ignore the
            # cached prefix. Prefill is pos=0 only.
            raise ValueError(
                "multi-token cached calls are prefill only (pos=0); "
                "continue from a prefilled cache one token at a time"
            )
        attention_fn = (
            None if decoding and s == 1
            else _select_attention(attention or self.attention, self.group)
        )
        x = F.embedding(tokens, self.tok_embed.weight).to(self.dtype)
        if decoding and s == 1:
            pos = _row_positions(pos, b, tokens.device)
            pos_emb = self.pos_embed[pos][:, None, :]
        else:
            pos_emb = self.pos_embed[None, offset:offset + s]
        x = x + pos_emb.to(self.dtype)
        moe_kw = {}
        if self.ffn == "moe":
            moe_kw = dict(group=None if decoding else self.group if ring else self.expert_group,
                          sequence=ring, shard_experts=self.shard_experts and not decoding,
                          deterministic=deterministic, generator=generator)
        for i, block in enumerate(self.blocks):
            x = block(x, attention_fn, cache=cache[i] if decoding else None,
                      pos=pos, **moe_kw)
        x = self.norm(x)
        # Logits in f32 for a stable softmax cross-entropy.
        logits = F.linear(x.float(), self.lm_head.weight.float())
        if decoding:
            return (logits[:, 0] if s == 1 else logits), cache
        return logits


def _row_positions(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.long, device=device)
    pos = torch.as_tensor(pos, dtype=torch.long, device=device)
    if pos.shape != (b,):
        raise ValueError(f"pos must be an int or one position per row, got {tuple(pos.shape)}")
    return pos


def init_kv_cache(model: TransformerLM, batch: int):
    """Zeroed per-layer K/V buffers sized ``[b, heads, max_seq, head_dim]``
    on the model's device."""
    head_dim = model.dim // model.num_heads
    shape = (batch, model.num_heads, model.max_seq, head_dim)
    return tuple(
        {"k": torch.zeros(shape, dtype=model.dtype, device=model.device),
         "v": torch.zeros(shape, dtype=model.dtype, device=model.device)}
        for _ in range(model.num_layers)
    )


def decode_step(model: TransformerLM, tokens, cache, pos):
    """One KV-cache decode step: ``[b, 1]`` tokens at ``pos`` -> logits."""
    return model(tokens, cache=cache, pos=pos)


@torch.inference_mode()
def generate(
    model: TransformerLM,
    prompt: torch.Tensor,  # [b, p] int
    n_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Autoregressive sampling: ``[b, p + n_tokens]`` continuations.

    A prefill of the whole prompt in one causal pass (flash attention
    applies), then single-token decode steps. ``temperature=0`` is greedy
    argmax; otherwise softmax sampling at the given temperature from
    ``generator``, optionally truncated to the ``top_k`` most likely
    tokens.
    """
    b, p = prompt.shape
    cache = init_kv_cache(model, b)
    # Cap against the cache slab: the write at ``pos`` is bounded by the
    # preallocated k/v length, and nothing else catches an overrun.
    max_len = cache[0]["k"].shape[2]
    total = p + int(n_tokens)
    if total > max_len:
        raise ValueError(
            f"prompt + n_tokens = {total} > max_seq {max_len} "
            "(the preallocated KV-cache capacity)"
        )

    def sample(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        scaled = logits / temperature
        if top_k is not None:
            kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
            scaled = torch.where(scaled < kth, torch.full_like(scaled, -1e30), scaled)
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    if n_tokens <= 0:
        return prompt
    prompt = prompt.to(model.device)
    try:
        prefill_logits, cache = model(prompt, cache=cache, pos=0)
    except BlockDivisibilityError:
        # Only the flash block contract gets a retry; every other error,
        # a kernel-input refusal on the card included, propagates. JAX
        # retries such a prompt with reference attention, and so does the
        # CPU here. The card's kernel masks ragged edges itself, so there
        # the retry launches it with one block per sequence. Either way the
        # retry rewrites the cache rows [0, p) the failed pass began.
        retry = "reference" if prompt.device.type == "cpu" else "flash_one_block"
        prefill_logits, cache = model(prompt, cache=cache, pos=0, attention=retry)
    # Prefill returns [b, vocab] for a 1-token prompt (the decode-step
    # shape) and [b, p, vocab] otherwise.
    logits = prefill_logits if p == 1 else prefill_logits[:, -1]
    out = []
    for i in range(n_tokens - 1):
        nxt = sample(logits)  # the token at position p + i
        out.append(nxt)
        logits, cache = decode_step(model, nxt[:, None], cache, p + i)
    out.append(sample(logits))
    return torch.cat([prompt, torch.stack(out, dim=1).to(prompt.dtype)], dim=1)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of positions 0..s-2 predicting tokens 1..s-1."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -logp.gather(-1, tgt[..., None])[..., 0].mean()
