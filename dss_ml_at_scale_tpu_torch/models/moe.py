"""Top-1 mixture-of-experts MLP: the port of ``dss_ml_at_scale_tpu/models/moe.py``.

Switch-Transformer routing, computed as JAX computes it:

- the router is an f32 product of the tokens upcast to f32; the softmax,
  the argmax (the first maximum wins in both frameworks) and the gate are
  f32;
- each expert takes at most ``C = max(1, ceil(tokens * capacity_factor /
  E))`` tokens; a token's place in its expert's queue is the running count
  of the tokens before it that chose the same expert, and a token at place
  ``C`` or later is dropped: its output is 0 and it rides the residual;
- the load-balance loss is ``E * sum_e fraction_e * mean_prob_e``, where
  ``fraction`` counts the argmax choices (before any drop) and
  ``mean_prob`` averages the router's probabilities;
- the experts are one batched product over ``[E, C, d]`` slots, in the
  model dtype, with the same roundings as JAX's ``einsum``s and bias adds;
  the gate is rounded to the model dtype before the combine.

JAX dispatches with ``[tokens, E, C]`` one-hot einsums. With one nonzero
term per slot those are exact gathers and scatters, so the port moves the
tokens by index: the same numbers, without the ``[t, E, C]`` tensor
(1.34 GB and ~1.4 TFLOP per block at the full-width LM's 16,384 tokens).
:func:`moe_dense_reference` keeps the one-hot form as the plain version
that the tests and ``chip_smoke.py`` hold the index dispatch to.

Across ranks (``group``), JAX's sharded program routes the global batch:
capacity, places and the aux loss's ``fraction`` are taken over every
rank's tokens in the global batch's order. The port all-gathers each
rank's per-expert counts (one small collective per layer) to place its
tokens in the global queues, and forms the aux term as the global
``fraction`` times the local ``mean_prob``: averaged over the ranks, as
DDP averages gradients (or summed at ``1/ranks`` each, as the sequence
layout sums them), that is the global loss and its gradient. A batch
split by rows (data parallelism) is rank-major: rank ``k``'s tokens follow
every token of the ranks before it. A batch split along the sequence
(``sequence``, a ring model: rank ``k`` holds columns ``[k S/n, (k+1)
S/n)`` of every row) is row-major: the token at row ``r`` follows every
token of the rows before ``r`` on every rank, then row ``r``'s tokens on
the ranks before ``k``; the ranks gather their per-row counts ``[b, E]``. With ``shard_experts`` (the group's size
divides E) each rank computes only its own E / size experts: its slots go
to their owners through one ``all_to_all``, and the outputs come back
through another. The parameters stay whole on every rank, as the JAX
trainer keeps them; an expert's gradient is nonzero only on its owner, so
DDP's mean is the global gradient.

The aux loss of the last pass is kept on the module, as flax sows it;
:func:`collect_aux_loss` sums a model's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..runtime import distributed as rt


@dataclasses.dataclass
class Routing:
    """Where each of a rank's ``t`` tokens goes."""

    expert: torch.Tensor  # [t] long, the argmax
    gate: torch.Tensor  # [t] f32, the chosen probability
    position: torch.Tensor  # [t] long, the place in the expert's global queue
    kept: torch.Tensor  # [t] bool, position < capacity
    capacity: int
    aux_loss: torch.Tensor  # 0-d f32 (with the router's graph)


def route(tokens: torch.Tensor, router_weight: torch.Tensor, num_experts: int,
          capacity_factor: float, *, group=None, noise: torch.Tensor | None = None,
          rows: int | None = None) -> Routing:
    """Top-1 routing of ``tokens`` ``[t, d]`` (JAX ``moe.py:71-113``), over
    the tokens of every rank of ``group`` when it has more than one.
    ``rows``: the tokens are ``rows`` rows of a sequence that ``group``
    shards, placed in the global batch's row-major order (module
    docstring); else the ranks' tokens are in rank order."""
    e = num_experts
    logits = F.linear(tokens.float(), router_weight.float())
    if noise is not None:
        logits = logits + noise
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    one_hot = F.one_hot(expert, e).float()
    if rows is not None and rt.group_size(group) > 1:
        position, counts, total = _sequence_places(expert, one_hot, rows, group)
    else:
        position, counts, total = _rank_places(expert, one_hot, group)
    capacity = max(1, math.ceil(total * capacity_factor / e))
    fraction = counts / total
    aux = e * torch.sum(fraction * probs.mean(dim=0))
    return Routing(expert=expert, gate=gate, position=position.long(),
                   kept=position < capacity, capacity=capacity, aux_loss=aux)


def _rank_places(expert, one_hot, group) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Each token's place in its expert's global queue (f32), the global
    per-expert counts and token count, the ranks' tokens in rank order:
    rank ``k``'s after every token of the ranks before it."""
    t, e = one_hot.shape
    counts = one_hot.sum(dim=0)
    offset = torch.zeros_like(counts)
    total = t
    if rt.group_size(group) > 1:
        mine = torch.cat([counts, counts.new_tensor([t])]).double()
        parts = [torch.empty_like(mine) for _ in range(rt.group_size(group))]
        dist.all_gather(parts, mine, group=group)
        table = torch.stack(parts)
        offset = table[:rt.group_rank(group), :e].sum(dim=0).float()
        counts = table[:, :e].sum(dim=0).float()
        total = int(table[:, e].sum().item())
    # JAX's (cumsum(one_hot) - 1) at each token's expert, exact in f32 below
    # 2^24 tokens. The running count is taken along the contiguous token axis
    # of the [E, t] transpose: a scan over the outer axis of [t, E] runs a
    # few columns at a time (~2.5 ms a block at 16,384 tokens on the card).
    running = torch.cumsum(one_hot.t().contiguous(), dim=1)
    return running.gather(0, expert[None, :])[0] - 1.0 + offset[expert], counts, total


def _sequence_places(expert, one_hot, rows: int,
                     group) -> tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`_rank_places` for tokens that are ``rows`` rows of a sequence
    sharded over ``group``, in the global batch's row-major order: the
    per-row counts of every rank, gathered, place the token at row ``r``
    after the rows before ``r`` on every rank, then row ``r``'s tokens on
    the ranks before this one."""
    t, e = one_hot.shape
    s = t // rows
    per_row = one_hot.view(rows, s, e)
    mine = per_row.sum(dim=1)  # [b, E]
    parts = [torch.empty_like(mine) for _ in range(rt.group_size(group))]
    dist.all_gather(parts, mine, group=group)
    table = torch.stack(parts)  # [ranks, b, E]
    row_totals = table.sum(dim=0)
    before = (torch.cumsum(row_totals, dim=0) - row_totals
              + table[:rt.group_rank(group)].sum(dim=0))  # [b, E]
    # The running count within each row, along the contiguous token axis.
    running = torch.cumsum(per_row.transpose(1, 2).contiguous(), dim=2)  # [b, E, s]
    local = running.gather(1, expert.view(rows, 1, s)).reshape(t) - 1.0
    row = torch.arange(t, device=expert.device) // s
    return local + before[row, expert], row_totals.sum(dim=0), t * rt.group_size(group)


def expert_ffn(x: torch.Tensor, w_up, b_up, w_down, b_down, dtype) -> torch.Tensor:
    """``[E, C, d]`` slots through their experts' tanh-GELU MLPs, in
    ``dtype``: each product rounded, then its bias added (JAX's einsum,
    then ``+ b``)."""
    h = F.gelu(torch.bmm(x, w_up.to(dtype)) + b_up.to(dtype), approximate="tanh")
    return torch.bmm(h, w_down.to(dtype)) + b_down.to(dtype)


class MoEMLP(nn.Module):
    """Top-1 routed MLP over ``num_experts`` experts; ``[b, s, d]`` in and
    out. Parameters as flax names them: ``router.weight`` (the transposed
    kernel), ``w_up [E, d, h]``, ``b_up [E, 1, h]``, ``w_down [E, h, d]``,
    ``b_down [E, 1, d]``."""

    def __init__(self, dim: int, num_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, dtype=torch.bfloat16,
                 router_noise: float = 0.0, device=None):
        super().__init__()
        if num_experts < 1:
            raise ValueError("ffn='moe' requires num_experts >= 1")
        e, h = num_experts, mlp_ratio * dim
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router_noise = router_noise
        self.router = nn.Linear(dim, e, bias=False, device=device)
        self.w_up = nn.Parameter(torch.zeros(e, dim, h, device=device))
        self.b_up = nn.Parameter(torch.zeros(e, 1, h, device=device))
        self.w_down = nn.Parameter(torch.zeros(e, h, dim, device=device))
        self.b_down = nn.Parameter(torch.zeros(e, 1, dim, device=device))
        self.aux_loss: torch.Tensor | None = None
        # The experts whose FFN the last pass ran on this rank: [first, last).
        self.computed_experts = (0, e)

    def forward(self, x: torch.Tensor, *, group=None, sequence: bool = False,
                shard_experts: bool = False, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``group``: route over every rank's tokens (``sequence``: ``x``
        is this rank's shard of the sequence, else of the rows);
        ``shard_experts``: and compute only this rank's experts.
        ``router_noise`` applies when ``deterministic`` is False and draws
        from ``generator``."""
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        noise = None
        if self.router_noise > 0.0 and not deterministic:
            if generator is None:
                raise ValueError("router_noise at train time needs a generator")
            noise = self.router_noise * torch.randn(
                (b * s, self.num_experts), generator=generator, device=x.device)
        r = route(tokens, self.router.weight, self.num_experts, self.capacity_factor,
                  group=group, noise=noise, rows=b if sequence else None)
        self.aux_loss = r.aux_loss
        return self._index_dispatch(tokens, r, group, shard_experts).reshape(b, s, d)

    def _experts(self, x: torch.Tensor, first: int, last: int) -> torch.Tensor:
        self.computed_experts = (first, last)
        return expert_ffn(x, self.w_up[first:last], self.b_up[first:last],
                          self.w_down[first:last], self.b_down[first:last], self.dtype)

    def _index_dispatch(self, tokens, r: Routing, group, shard_experts: bool) -> torch.Tensor:
        e, c, d, dtype = self.num_experts, r.capacity, tokens.shape[1], self.dtype
        rows = torch.nonzero(r.kept)[:, 0]
        slots = r.expert[rows] * c + r.position[rows]
        expert_in = torch.zeros(e * c, d, dtype=dtype, device=tokens.device).index_copy(
            0, slots, tokens[rows].to(dtype)).view(e, c, d)
        ranks = rt.group_size(group)
        if shard_experts and ranks > 1:
            if e % ranks:
                raise ValueError(f"shard_experts needs the group's {ranks} ranks to divide "
                                 f"num_experts={e}")
            per = e // ranks
            first = rt.group_rank(group) * per
            # Every rank's slots of this rank's experts; the ranks' slots are
            # disjoint, so the sum is exact.
            mine = rt.all_to_all(expert_in.view(ranks, per, c, d), group).sum(dim=0)
            out_mine = self._experts(mine, first, first + per)
            expert_out = rt.all_to_all(
                out_mine.unsqueeze(0).expand(ranks, per, c, d).contiguous(), group)
        else:
            expert_out = self._experts(expert_in, 0, e)
        picked = expert_out.reshape(e * c, d).index_select(0, slots)
        combined = r.gate[rows].to(dtype)[:, None] * picked
        return torch.zeros(tokens.shape[0], d, dtype=dtype, device=tokens.device).index_copy(
            0, rows, combined)


def moe_dense_reference(tokens: torch.Tensor, r: Routing, moe: MoEMLP) -> torch.Tensor:
    """The plain version of the dispatch: JAX's ``[t, E, C]`` one-hot
    einsums (``moe.py:104-145``) on one process's ``tokens`` ``[t, d]``,
    routed by :func:`route`, through ``moe``'s experts."""
    e, c, dtype = moe.num_experts, r.capacity, moe.dtype
    place = F.one_hot(r.position.clamp(max=c - 1), c).float() * r.kept[:, None].float()
    dispatch = F.one_hot(r.expert, e).float()[:, :, None] * place[:, None, :]
    combine = dispatch * r.gate[:, None, None]
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype), tokens.to(dtype))
    expert_out = moe._experts(expert_in, 0, e)
    return torch.einsum("tec,ecd->td", combine.to(dtype), expert_out)


def collect_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of every MoE layer's aux loss from the model's last pass
    (0 for a model without one, as JAX's empty ``intermediates``)."""
    total = torch.zeros((), dtype=torch.float32)
    for m in model.modules():
        if isinstance(m, MoEMLP) and m.aux_loss is not None:
            total = total.to(m.aux_loss.device) + m.aux_loss
    return total
