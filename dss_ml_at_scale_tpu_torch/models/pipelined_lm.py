"""Pipeline-parallel Transformer LM: the port of
``dss_ml_at_scale_tpu/models/pipelined_lm.py``.

The ``TransformerBlock``s are the stages of
:func:`..parallel.pipeline.spmd_pipeline`, one block per pipe rank, with
reference attention and f32 by default, as in JAX. The token and position
tables, the final RMSNorm scale and the (untied) head are held whole on
every rank and run outside the pipeline. Batches are microbatched:
``tokens`` ``[n_micro, micro_batch, seq]``.

Parameters keep the JAX names: ``tok [vocab, dim]``, ``pos [max_seq,
dim]``, ``norm_scale [dim]``, ``head [dim, vocab]`` (the logits are
``rms_norm(y) @ head``), and ``block.*``, this rank's stage. A checkpoint
holds the stages stacked as ``block.* [n_stages, ...]``. As in JAX a
``vocab_size``, ``max_seq`` or ``dim`` equal to the stage count is
refused: a stacked checkpoint tells stage tensors by that leading size.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..parallel.pipeline import PipeGrid, PipelineTaskBase, spmd_pipeline
from .convert import _init_tensor
from .transformer import TransformerBlock, _select_attention, next_token_loss, rms_norm


class PipelinedLM(nn.Module):
    """Decoder-only LM with its layer stack pipelined over ``grid``'s pipe
    ranks: ``grid.n_stages`` blocks, block ``grid.stage`` on this rank,
    held on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, vocab_size: int, dim: int, num_heads: int, grid: PipeGrid,
                 max_seq: int = 512, mlp_ratio: int = 4, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.n_stages = grid.n_stages
        for name, val in (("vocab_size", vocab_size), ("max_seq", max_seq), ("dim", dim)):
            if val == self.n_stages:
                raise ValueError(
                    f"{name}={val} equals the pipe stage count; pick a different size "
                    "(stage-dim detection would collide)")
        self.grid = grid
        self.vocab_size, self.dim, self.max_seq, self.dtype = vocab_size, dim, max_seq, dtype
        self.tok = nn.Parameter(torch.zeros(vocab_size, dim, device=device))
        self.pos = nn.Parameter(torch.zeros(max_seq, dim, device=device))
        self.norm_scale = nn.Parameter(torch.ones(dim, device=device))
        self.head = nn.Parameter(torch.zeros(dim, vocab_size, device=device))
        self.block = TransformerBlock(dim, num_heads, mlp_ratio, dtype, device=device)
        attention = _select_attention("reference")
        block = self.block
        self._run = spmd_pipeline(
            lambda p, x: functional_call(block, p, (x, attention)), grid)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``[n_micro, mb, seq]`` int -> ``[n_micro, mb, seq, vocab]`` f32."""
        s = tokens.shape[2]
        if s > self.max_seq:
            raise ValueError(f"seq {s} > max_seq {self.max_seq}")
        x = F.embedding(tokens, self.tok.to(self.dtype)) + self.pos[:s].to(self.dtype)
        y = self._run(dict(self.block.named_parameters()), x)
        return rms_norm(y.float(), self.norm_scale) @ self.head


def init_pipelined_lm_state(model: PipelinedLM, seed: int) -> dict[str, torch.Tensor]:
    """Seeded weights for ``model``, as an f32 CPU ``state_dict`` the same
    on every rank but for its stage: ``tok``, ``pos`` and ``head``
    normal(0.02) as the JAX init draws them, then every stage's block with
    :func:`..convert.init_lm_state`'s rules, of which this rank keeps its
    own."""
    gen = torch.Generator().manual_seed(int(seed))
    state = {k: torch.randn(tuple(p.shape), generator=gen) * 0.02
             for k, p in (("tok", model.tok), ("pos", model.pos), ("head", model.head))}
    state["norm_scale"] = torch.ones(model.dim)
    for stage in range(model.n_stages):
        block = {f"block.{k}": _init_tensor(k, tuple(p.shape), gen)
                 for k, p in model.block.state_dict().items()}
        if stage == model.grid.stage:
            state.update(block)
    return state


class PipelinedLMTask(PipelineTaskBase):
    """Trainer task: the next-token loss of a :class:`PipelinedLM`, Adam at
    ``learning_rate``; ``tokens`` batches ``[n_micro, micro_batch, seq]``,
    the micro_batch rows split over the data columns."""

    throughput_unit = "tokens"
    batch_key = "tokens"

    def __init__(self, model: PipelinedLM, learning_rate: float = 3e-4):
        self._setup(model, model.grid, learning_rate)

    def _is_stage(self, name: str) -> bool:
        return name.startswith("block.")

    def batch_units(self, batch) -> int:
        super().batch_units(batch)
        return math.prod(batch["tokens"].shape)

    def _loss(self, batch) -> torch.Tensor:
        tokens = self.column(batch["tokens"])
        logits = self.model(tokens)
        m, mb, s, v = logits.shape
        return next_token_loss(logits.reshape(m * mb, s, v), tokens.reshape(m * mb, s))

    def compute_update(self, batch) -> dict[str, torch.Tensor]:
        self.model.train()
        loss = self._loss(batch)
        grad_norm = self._update_from(loss)
        loss = self._column_mean(loss)
        return {"train_loss": loss, "train_ppl": torch.exp(loss), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, batch) -> dict[str, torch.Tensor]:
        self.model.eval()
        loss = self._column_mean(self._loss(batch))
        return {"val_loss": loss, "val_ppl": torch.exp(loss)}
