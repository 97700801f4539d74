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
"""

from __future__ import annotations

import torch
from torch import nn


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps, relu):
        axes = tuple(range(x.ndim - 1))
        x32 = x.float()
        mean = x32.mean(axes)
        var = x32.square().mean(axes) - mean.square()
        inv = torch.rsqrt(var + eps)
        pre = (x32 - mean) * (inv * scale) + bias
        if residual is not None:
            pre = pre + residual.float()
        out = torch.clamp_min(pre, 0.0) if relu else pre
        ctx.save_for_backward(x, mean, inv, scale, bias, residual)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        # The statistics feed the running averages only (stop-gradient, as
        # in flax): their cotangents are dropped.
        x, mean, inv, scale, bias, residual = ctx.saved_tensors
        axes = tuple(range(x.ndim - 1))
        n = float(x.numel() // x.shape[-1])
        x_hat = (x.float() - mean) * inv
        g32 = g_out.float()
        if ctx.relu:
            pre = x_hat * scale + bias
            if residual is not None:
                pre = pre + residual.float()
            g32 = torch.where(pre > 0, g32, torch.zeros_like(g32))
        sum_g = g32.sum(axes)
        sum_gx = (g32 * x_hat).sum(axes)
        dx = (scale * inv) * (g32 - (sum_g + x_hat * sum_gx) / n)
        dres = g32.to(residual.dtype) if residual is not None else None
        return dx.to(x.dtype), sum_gx, sum_g, dres, None, None


def bn_act(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-5,
    relu: bool = False,
    residual: torch.Tensor | None = None,
):
    """Fused train-mode BN(+relu)(+residual add) over the last axis.

    Returns ``(out, mean, var)``: ``out`` in ``x.dtype``, the biased ``var``
    and ``mean`` in f32. No gradient flows through the returned statistics.
    """
    return _BnAct.apply(x, scale, bias, residual, float(eps), bool(relu))


class BatchNorm(nn.Module):
    """The port of the JAX package's fused ``BatchNorm`` module.

    Channels last: reduces over every axis but the last. ``act`` ("relu" or
    None) and an optional ``residual`` are applied inside the fused op.
    Train or eval follows ``self.training`` (flax's
    ``use_running_average = not train``). Parameters and buffers carry
    torchvision's names: ``weight`` (flax ``scale``), ``bias``,
    ``running_mean`` and ``running_var``.
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
                axes = tuple(range(x.ndim - 1))
                x32 = x.float()
                mean = x32.mean(axes)
                var = x32.square().mean(axes) - mean.square()
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
                                residual=residual)
        self._update_running(mean, var)
        return out
