"""Pipeline parallelism: the port of ``dss_ml_at_scale_tpu/parallel/pipeline.py``.

A GPipe schedule with one stage per rank. The ranks form a grid of
``n_stages`` pipe rows by ``n_data`` data columns, numbered as the JAX
mesh ``("pipe", "data")`` numbers its devices (rank = stage * n_data +
column): each column pipelines its own share of the batch (PP x DP).

JAX runs every stage on every one of the ``n_micro + n_stages - 1`` ticks
and masks the bubbles; their outputs are never banked, so their gradients
are zero. The port runs each stage only on its real microbatches, in
order: stage ``i`` takes microbatch ``m`` (from the batch at stage 0, else
from stage ``i - 1``), applies itself and passes the result on, or banks
it at the last stage. Point-to-point sends between neighbours carry the
activations forward and, in the backward, the gradients back; the stage is
recomputed in the backward from its saved input (JAX's
``jax.checkpoint`` of the stage). The last stage's outputs are broadcast
over the pipe (JAX's masked ``psum``), so the output is replicated over
the pipe ranks, as is whatever the caller computes from it; the backward
takes the mean of the pipe ranks' cotangents, and the gradient of the
input, formed at stage 0, is broadcast back over the pipe.

:class:`PipelinedTask` is the MSE regression task of the JAX module under
the port's ``Trainer`` (layout ``"pipeline"``): each rank holds its stage's
parameters only, the gradients are averaged over the data column, and the
``pipeline_utilization`` gauge reads ``n_micro / (n_micro + n_stages - 1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from .. import telemetry
from ..runtime import distributed as rt

__all__ = [
    "PipeGrid",
    "PipelinedTask",
    "pipe_grid",
    "pipeline_utilization",
    "spmd_pipeline",
    "stack_stage_params",
]


@dataclasses.dataclass(frozen=True)
class PipeGrid:
    """This rank's place in the (pipe x data) grid and its two groups."""

    n_stages: int
    n_data: int
    stage: int
    column: int
    pipe_group: Any = None  # this column's ranks, stage order
    data_group: Any = None  # this stage's ranks, column order

    def pipe_rank(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's column."""
        return stage * self.n_data + self.column


def pipe_grid(n_stages: int | None = None) -> PipeGrid:
    """The grid of the process group: ``n_stages`` pipe rows (default:
    every rank) by ``ranks / n_stages`` data columns. Every rank must call
    it (it creates the groups)."""
    world = rt.process_count()
    n_stages = world if n_stages is None else n_stages
    if n_stages < 1 or world % n_stages:
        raise ValueError(f"{world} ranks do not split into {n_stages} pipe stages")
    n_data = world // n_stages
    rank = rt.process_index()
    if world == 1:
        return PipeGrid(1, 1, 0, 0)
    pipe = data = None
    for c in range(n_data):  # every rank creates every group, in one order
        g = dist.new_group([s * n_data + c for s in range(n_stages)])
        if rank % n_data == c:
            pipe = g
    for s in range(n_stages):
        g = dist.new_group([s * n_data + c for c in range(n_data)])
        if rank // n_data == s:
            data = g
    return PipeGrid(n_stages, n_data, rank // n_data, rank % n_data, pipe, data)


def stack_stage_params(init_fn: Callable[[int], dict], seed: int, n_stages: int) -> dict:
    """``n_stages`` stages' params from ``init_fn(stage_seed)``, stacked on
    a leading stage axis (the layout of a pipeline's checkpoint)."""
    stages = [init_fn(seed * 1_000_003 + i) for i in range(n_stages)]
    return {k: torch.stack([s[k] for s in stages]) for k in stages[0]}


def pipeline_utilization(n_micro: int, n_stages: int) -> float:
    """GPipe bubble accounting: the fraction of ticks doing useful work."""
    return n_micro / (n_micro + n_stages - 1)


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid: PipeGrid, stage_fn, names, xs, *values):
        params = dict(zip(names, values))
        first, last = grid.stage == 0, grid.stage == grid.n_stages - 1
        inputs, ys = [], torch.zeros_like(xs)
        for m in range(xs.shape[0]):
            x = xs[m] if first else rt.recv(xs[m], grid.pipe_rank(grid.stage - 1))
            inputs.append(x)
            y = stage_fn(params, x)
            if last:
                ys[m] = y
            else:
                rt.send(y, grid.pipe_rank(grid.stage + 1))
        if grid.n_stages > 1:
            dist.broadcast(ys, grid.pipe_rank(grid.n_stages - 1), group=grid.pipe_group)
        ctx.grid, ctx.stage_fn, ctx.names = grid, stage_fn, names
        ctx.save_for_backward(*values, *inputs)
        return ys

    @staticmethod
    def backward(ctx, gys):
        grid, stage_fn, names = ctx.grid, ctx.stage_fn, ctx.names
        saved = ctx.saved_tensors
        values, inputs = saved[:len(names)], saved[len(names):]
        first, last = grid.stage == 0, grid.stage == grid.n_stages - 1
        gys = gys.contiguous()
        if grid.n_stages > 1:
            # The output is replicated over the pipe: its cotangent is the
            # mean of the pipe ranks'.
            gys = gys.clone()
            dist.all_reduce(gys, group=grid.pipe_group)
            gys /= grid.n_stages
        leaves = [v.detach().requires_grad_() for v in values]
        params = dict(zip(names, leaves))
        grads = [torch.zeros_like(v) for v in values]
        gxs = torch.zeros_like(gys)
        for m in reversed(range(len(inputs))):
            g = gys[m] if last else rt.recv(gys[m], grid.pipe_rank(grid.stage + 1))
            x = inputs[m].detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(params, x)
            gx, *gp = torch.autograd.grad(y, [x, *leaves], g, allow_unused=True)
            for acc, gi in zip(grads, gp):
                if gi is not None:
                    acc += gi
            if first:
                gxs[m] = gx
            else:
                rt.send(gx, grid.pipe_rank(grid.stage - 1))
        if grid.n_stages > 1:
            dist.broadcast(gxs, grid.pipe_rank(0), group=grid.pipe_group)
        return (None, None, None, gxs, *grads)


def spmd_pipeline(stage_fn: Callable[[dict, torch.Tensor], torch.Tensor], grid: PipeGrid):
    """Build ``run(params, xs) -> ys``: ``params`` this rank's stage
    (a dict of tensors), ``xs`` ``[n_micro, micro_batch, ...]`` this column's
    microbatches; ``ys`` has the same shape, every microbatch through every
    stage in order, on every rank of the column. ``stage_fn(params, x)``
    must keep the shape (the GPipe regime)."""

    def run(params: dict, xs: torch.Tensor) -> torch.Tensor:
        names = list(params)
        return _Schedule.apply(grid, stage_fn, names, xs, *(params[n] for n in names))

    return run


class _Stage(torch.nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        self.params = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v.clone()) for k, v in params.items()})


class PipelineTaskBase:
    """What the pipeline tasks share under the port's ``Trainer``: the
    layout, Adam over this rank's parameters (stage and replicated), the
    data column's share of each batch and the gradients averaged over the
    column, and the stacked checkpoint."""

    layout = "pipeline"
    default_best_metric = "val_loss"
    default_best_mode = "min"
    batch_key = "x"

    def _setup(self, model: torch.nn.Module, grid: PipeGrid, learning_rate) -> None:
        from .trainer import _adam

        self.model = self.net = model
        self.grid = grid
        self.learning_rate = learning_rate
        self.optimizer, self.scheduler = _adam(model, learning_rate)
        self.step = 0

    def shard_optimizer(self) -> None:
        raise ValueError("a pipeline task keeps each stage's Adam state on its own rank; "
                         "shard_opt_state does not apply")

    def batch_units(self, batch) -> int:
        """Examples per batch (n_micro x micro_batch); publishes the
        schedule's utilization, as JAX's ``batch_size_of``."""
        x = batch[self.batch_key]
        telemetry.gauge(
            "pipeline_utilization",
            "GPipe schedule utilization n_micro/(n_micro+n_stages-1)",
        ).set(pipeline_utilization(int(x.shape[0]), self.grid.n_stages))
        return int(x.shape[0]) * int(x.shape[1])

    def column(self, t: torch.Tensor) -> torch.Tensor:
        """This data column's share of a ``[n_micro, micro_batch, ...]``
        batch tensor (its micro_batch rows split in column order)."""
        if t.shape[1] % self.grid.n_data:
            raise ValueError(f"micro batch {t.shape[1]} not divisible by the "
                             f"{self.grid.n_data} data columns")
        n = t.shape[1] // self.grid.n_data
        return t[:, self.grid.column * n:(self.grid.column + 1) * n]

    def _column_mean(self, value: torch.Tensor) -> torch.Tensor:
        value = value.detach().clone()
        if self.grid.n_data > 1:
            dist.all_reduce(value, group=self.grid.data_group)
            value /= self.grid.n_data
        return value

    def _update_from(self, loss: torch.Tensor) -> torch.Tensor:
        from .trainer import _backward

        return _backward(self.model, self.optimizer, loss, self.grid.data_group, mean=True)

    def train_step(self, batch) -> dict[str, torch.Tensor]:
        metrics = self.compute_update(batch)
        self.commit_update()
        return metrics

    def commit_update(self) -> None:
        from .trainer import _update

        _update(self.optimizer, self.scheduler)
        self.step += 1

    # -- checkpoints: stage tensors stacked [n_stages, ...] -----------------

    def _is_stage(self, name: str) -> bool:
        raise NotImplementedError

    def checkpoint_state(self) -> tuple[dict | None, dict | None]:
        """``(model, optimizer)`` state with every stage tensor stacked over
        the stages, on rank 0 (``None`` elsewhere); a collective of every
        rank. Adam's moments are keyed by parameter name."""
        named = dict(self.model.named_parameters())
        index = {p: i for i, p in enumerate(self.model.parameters())}
        opt = self.optimizer.state_dict()
        local = {
            "model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
            "optimizer": {n: {k: (v.cpu() if torch.is_tensor(v) else v)
                              for k, v in opt["state"].get(index[p], {}).items()}
                          for n, p in named.items()},
        }
        parts = [None] * rt.process_count() if rt.process_index() == 0 else None
        if rt.process_count() > 1:
            dist.gather_object(local, parts, dst=0)
        else:
            parts = [local]
        if rt.process_index() != 0:
            return None, None
        # Column 0 of each stage, in stage order.
        stages = [parts[self.grid.pipe_rank(s) - self.grid.column] for s in range(self.grid.n_stages)]

        def stacked(get):
            return {k: (torch.stack([get(st)[k] for st in stages]) if self._is_stage(k)
                        else get(stages[0])[k]) for k in get(stages[0])}

        model = stacked(lambda st: st["model"])
        moments = {n: {k: (torch.stack([st["optimizer"][n][k] for st in stages])
                           if self._is_stage(n) and torch.is_tensor(v) and v.ndim else v)
                       for k, v in stages[0]["optimizer"][n].items()}
                   for n in named if stages[0]["optimizer"][n]}
        return model, {"moments": moments, "param_groups": opt["param_groups"]}

    def load_checkpoint_state(self, model: dict, optimizer: dict) -> None:
        """Restore :meth:`checkpoint_state`'s stacked state: each rank
        takes its own stage's slice."""
        s = self.grid.stage
        self.model.load_state_dict({k: (v[s] if self._is_stage(k) else v)
                                    for k, v in model.items()})
        named = dict(self.model.named_parameters())
        index = {p: i for i, p in enumerate(self.model.parameters())}
        state = {index[named[n]]: {k: (v[s] if self._is_stage(n) and torch.is_tensor(v)
                                       and v.ndim else v) for k, v in m.items()}
                 for n, m in optimizer["moments"].items()}
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": optimizer["param_groups"]})


class PipelinedTask(PipelineTaskBase):
    """Pipeline-parallel regression: ``{"x", "y"}`` batches of
    ``[n_micro, micro_batch, d]``, the MSE of the pipeline's output against
    ``y``. ``init_stage_fn(seed)`` makes one stage's params (a dict of
    tensors); stage ``i`` is drawn from ``seed * 1000003 + i``. The params
    live on ``device`` (the card unless the caller asks for the CPU)."""

    throughput_unit = "examples"

    def __init__(self, stage_fn: Callable[[dict, torch.Tensor], torch.Tensor],
                 init_stage_fn: Callable[[int], dict], grid: PipeGrid,
                 learning_rate: float = 1e-2, seed: int = 0, device="cuda"):
        params = stack_stage_params(init_stage_fn, seed, grid.n_stages)
        own = {k: v[grid.stage].to(device) for k, v in params.items()}
        self._setup(_Stage(own), grid, learning_rate)
        self.run = spmd_pipeline(stage_fn, grid)

    def _is_stage(self, name: str) -> bool:
        return True

    def _loss(self, batch) -> torch.Tensor:
        xs, ys = self.column(batch["x"]), self.column(batch["y"])
        params = dict(self.model.params.items())
        return torch.mean((self.run(params, xs) - ys) ** 2)

    def compute_update(self, batch) -> dict[str, torch.Tensor]:
        loss = self._loss(batch)
        grad_norm = self._update_from(loss)
        return {"train_loss": self._column_mean(loss), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(self, batch) -> dict[str, torch.Tensor]:
        return {"val_loss": self._column_mean(self._loss(batch))}
