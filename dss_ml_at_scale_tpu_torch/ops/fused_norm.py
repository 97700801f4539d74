"""Fused train-mode BatchNorm + ReLU (+ residual add) with a hand-written
minimal-residual backward.

Port of ``dss_ml_at_scale_tpu/ops/fused_norm.py``. There is no kernel here:
the JAX module is plain XLA around a custom VJP, and this one is plain torch
around a ``torch.autograd.Function``. What is hand-written is the backward:
it saves only ``(x, mean, inv, scale, bias[, residual])`` (``x`` is the conv
output, alive anyway for its conv's weight gradient) and recomputes x_hat
and the ReLU mask in its two passes:

    pass 1 (reads x, g):          sum(g), sum(g * x_hat)   -> dbeta, dgamma
    pass 2 (reads x, g, writes):  dx = scale * inv * (g - (sum(g) + x_hat * sum(g * x_hat)) / n)

Semantics are flax's ``BatchNorm`` in train mode: statistics over every
axis but the last (channels last), accumulated in f32 whatever the input
dtype; the variance is E[x^2] - mean^2 (biased), and that same variance
normalizes and feeds the running average, at momentum 0.9
(``ra = 0.9 * ra + 0.1 * batch``). ``torch.nn.functional.batch_norm`` keeps
the unbiased variance and the opposite momentum convention, so it is not
used.

Across ranks (``group``, the counterpart of the JAX package's GSPMD sync
BN) the statistics are global: the forward all-reduces the per-channel
sums of x and x^2 with the row count, and the backward all-reduces
``sum(g)`` and ``sum(g * x_hat)`` and divides by the global count. dgamma
and dbeta stay the rank's own sums: data parallelism averages them over the
ranks, as it does every parameter gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..runtime.distributed import stats_group


def batch_stats(x32: torch.Tensor, group=None):
    """``(mean, var, count)`` over every axis but the last: local, or over
    every rank of ``group`` (sums and the row count all-reduced in one
    call; the count is an f32 tensor, exact to 2^24 rows)."""
    axes = tuple(range(x32.ndim - 1))
    if group is None:
        mean = x32.mean(axes)
        return mean, x32.square().mean(axes) - mean.square(), float(x32.numel() // x32.shape[-1])
    k = x32.shape[-1]
    count = torch.full((1,), float(x32.numel() // k), device=x32.device)
    buf = torch.cat([x32.sum(axes), x32.square().sum(axes), count])
    dist.all_reduce(buf, group=group)
    n = buf[2 * k]
    mean = buf[:k] / n
    return mean, buf[k:2 * k] / n - mean.square(), n


def reduce_grad_sums(sum_g: torch.Tensor, sum_gx: torch.Tensor, group=None):
    """``sum(g)`` and ``sum(g * x_hat)`` over every rank of ``group`` (one
    all-reduce), or as they are without one."""
    if group is None:
        return sum_g, sum_gx
    buf = torch.cat([sum_g, sum_gx])
    dist.all_reduce(buf, group=group)
    return buf[:sum_g.numel()], buf[sum_g.numel():]


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps, relu, group):
        x32 = x.float()
        mean, var, n = batch_stats(x32, group)
        inv = torch.rsqrt(var + eps)
        pre = (x32 - mean) * (inv * scale) + bias
        if residual is not None:
            pre = pre + residual.float()
        out = torch.clamp_min(pre, 0.0) if relu else pre
        ctx.save_for_backward(x, mean, inv, scale, bias, residual)
        ctx.relu = relu
        ctx.group = group
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        # The statistics feed the running averages only (stop-gradient, as
        # in flax): their cotangents are dropped.
        x, mean, inv, scale, bias, residual = ctx.saved_tensors
        axes = tuple(range(x.ndim - 1))
        x_hat = (x.float() - mean) * inv
        g32 = g_out.float()
        if ctx.relu:
            pre = x_hat * scale + bias
            if residual is not None:
                pre = pre + residual.float()
            g32 = torch.where(pre > 0, g32, torch.zeros_like(g32))
        sum_g = g32.sum(axes)
        sum_gx = (g32 * x_hat).sum(axes)
        all_g, all_gx = reduce_grad_sums(sum_g, sum_gx, ctx.group)
        dx = (scale * inv) * (g32 - (all_g + x_hat * all_gx) / ctx.n)
        dres = g32.to(residual.dtype) if residual is not None else None
        return dx.to(x.dtype), sum_gx, sum_g, dres, None, None, None


def bn_act(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-5,
    relu: bool = False,
    residual: torch.Tensor | None = None,
    group=None,
):
    """Fused train-mode BN(+relu)(+residual add) over the last axis.

    Returns ``(out, mean, var)``: ``out`` in ``x.dtype``, the biased ``var``
    and ``mean`` in f32. No gradient flows through the returned statistics.
    With ``group`` the statistics are those of the batch of every rank.
    """
    return _BnAct.apply(x, scale, bias, residual, float(eps), bool(relu), group)


class BatchNorm(nn.Module):
    """The port of the JAX package's fused ``BatchNorm`` module.

    Channels last: reduces over every axis but the last. ``act`` ("relu" or
    None) and an optional ``residual`` are applied inside the fused op.
    Train or eval follows ``self.training`` (flax's
    ``use_running_average = not train``). Parameters and buffers carry
    torchvision's names: ``weight`` (flax ``scale``), ``bias``,
    ``running_mean`` and ``running_var``. In a run of several processes
    the training statistics, and so the running averages, are those of
    the global batch (:func:`..runtime.stats_group`).
    """

    def __init__(self, features: int, *, momentum: float = 0.9, eps: float = 1e-5,
                 act: str | None = None, zero_init: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.zeros(features) if zero_init else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def forward(self, x, residual=None, *, stats_only: bool = False):
        if stats_only:
            # The fused-matmul path: statistics here, plain torch, with the
            # running averages updated as the applying path does; the
            # consuming kernel applies normalize + ReLU in its prologue.
            if not self.training:
                return self.weight, self.bias, self.running_mean, self.running_var
            with torch.no_grad():
                mean, var, _ = batch_stats(x.float(), stats_group())
            self._update_running(mean, var)
            return self.weight, self.bias, mean, var
        relu = self.act == "relu"
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            pre = (x.float() - self.running_mean) * (inv * self.weight) + self.bias
            if residual is not None:
                pre = pre + residual.float()
            out = torch.clamp_min(pre, 0.0) if relu else pre
            return out.to(x.dtype)
        out, mean, var = bn_act(x, self.weight, self.bias, eps=self.eps, relu=relu,
                                residual=residual, group=stats_group())
        self._update_running(mean, var)
        return out
