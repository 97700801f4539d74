"""ResNet in PyTorch: the port of ``dss_ml_at_scale_tpu/models/resnet.py``.

The public input is NHWC, as in JAX. Inside, every convolution sees an NCHW
view of a ``channels_last`` tensor (``permute`` of the NHWC tensor, no copy)
and gives one back, so the BatchNorm ops and the fused-matmul site work on
contiguous channels-last data and ``y.reshape(M, K)`` is a view. Compute is
in ``dtype`` (bf16 by default) with f32 parameters; the head is an f32
linear over the spatial mean, which is taken in ``dtype`` (as ``jnp.mean``
of a bf16 tensor returns bf16).

``fused_bn`` chooses the BatchNorm level, as in JAX:
``False`` flax's ``BatchNorm`` semantics with plain autograd; ``True`` the
fused BN + ReLU (+ residual) of :mod:`..ops.fused_norm`; ``"pallas"``
(bottleneck blocks only) additionally the middle BN's apply fused into the
third 1x1 conv (:func:`..ops.fused_matmul.bn_relu_matmul`, kernels K1-K3).

Padding. ``torch_padding=False`` is XLA's ``SAME``: asymmetric on stride 2
with even inputs (the 7x7 stem on 224 pads (2, 3), a 3x3 stride-2 conv
(0, 1), the 3x3 stride-2 max-pool (0, 1) with -inf), done with an explicit
pad; ``torch_padding=True`` pads ``(k - 1) // 2`` on each side.

Names follow torchvision's ``state_dict`` (``conv1``, ``bn1``,
``layer1.0.conv3``, ``layer1.0.downsample.0``, ``fc``, ...; there is no
``num_batches_tracked``). The last BN of each block starts at zero scale.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_matmul import bn_relu_matmul
from ..ops.fused_norm import BatchNorm as FusedBatchNorm


class PlainBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (no activation), channels last: f32 statistics
    with the variance ``max(0, E[x^2] - mean^2)``, ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` returned in ``x.dtype``, gradients
    by autograd through the statistics, running averages at momentum 0.9."""

    def __init__(self, features: int, *, momentum: float = 0.9, eps: float = 1e-5,
                 zero_init: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(features) if zero_init else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        x32 = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x32.mean(axes)
            var = torch.clamp_min(x32.square().mean(axes) - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class _Net(nn.Module):
    """What every block shares: the compute dtype, the padding rule and the
    BN level."""

    def __init__(self, dtype, torch_padding: bool, fused):
        super().__init__()
        self.dtype = dtype
        self.torch_padding = torch_padding
        self.fused = fused

    def norm(self, features: int, *, act: str | None = None, zero_init: bool = False):
        if self.fused:
            return FusedBatchNorm(features, act=act, zero_init=zero_init)
        return PlainBatchNorm(features, zero_init=zero_init)

    def norm_relu(self, bn: nn.Module, y: torch.Tensor) -> torch.Tensor:
        """norm-then-relu; the fused BN applies the ReLU itself."""
        return bn(y) if self.fused else F.relu(bn(y))

    def _pad(self, x: torch.Tensor, k: int, stride: int, value: float = 0.0):
        """``(x padded, conv padding)`` for a k x k window over NHWC ``x``."""
        if self.torch_padding:
            return x, (k - 1) // 2
        (hl, hh), (wl, wh) = (_same_pad(x.shape[1], k, stride),
                              _same_pad(x.shape[2], k, stride))
        if hl == hh and wl == wh and value == 0.0:
            return x, (hl, wl)
        return F.pad(x, (0, 0, wl, wh, hl, hh), value=value), 0

    def conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """NHWC in, NHWC out; the NCHW views in between are channels_last."""
        k, stride = conv.kernel_size[0], conv.stride[0]
        x, padding = self._pad(x.to(self.dtype), k, stride)
        w = conv.weight.to(self.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    def max_pool(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = self._pad(x, 3, 2, value=float("-inf"))
        if isinstance(padding, int) and padding:
            x = F.pad(x, (0, 0, padding, padding, padding, padding), value=float("-inf"))
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, bias=False)


class BottleneckBlock(_Net):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, *, dtype=torch.bfloat16,
                 torch_padding: bool = False, fused=False):
        super().__init__(dtype, torch_padding, fused)
        cout = filters * 4
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = self.norm(filters, act="relu")
        self.conv2 = _conv(filters, filters, 3, stride)
        # At the pallas level bn2 only computes statistics; the kernel
        # applies them.
        self.bn2 = self.norm(filters, act=None if fused == "pallas" else "relu")
        self.conv3 = _conv(filters, cout, 1)
        self.bn3 = self.norm(cout, act="relu", zero_init=True)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), self.norm(cout))

    def forward(self, x):
        residual = x
        y = self.norm_relu(self.bn1, self.conv(self.conv1, x))
        y = self.conv(self.conv2, y)
        if self.fused == "pallas":
            scale, bias, mean, var = self.bn2(y, stats_only=True)
            n_out, k = self.conv3.weight.shape[:2]
            w = self.conv3.weight.reshape(n_out, k).t().contiguous().to(self.dtype)
            # Eval / frozen BN: the statistics are constants, and the
            # backward's statistics correction must not apply.
            y = bn_relu_matmul(y, scale, bias, mean, var, w, eps=self.bn2.eps,
                               batch_stats=self.training)
        else:
            y = self.conv(self.conv3, self.norm_relu(self.bn2, y))
        if self.downsample is not None:
            residual = self.downsample[1](self.conv(self.downsample[0], residual))
        if self.fused:
            return self.bn3(y, residual=residual)
        return F.relu(residual + self.bn3(y))


class ResNetBlock(_Net):
    """Basic 3x3 -> 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, *, dtype=torch.bfloat16,
                 torch_padding: bool = False, fused=False):
        super().__init__(dtype, torch_padding, fused)
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = self.norm(filters, act="relu")
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = self.norm(filters, act="relu", zero_init=True)
        self.downsample = None
        if cin != filters or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride), self.norm(filters))

    def forward(self, x):
        residual = x
        y = self.norm_relu(self.bn1, self.conv(self.conv1, x))
        y = self.conv(self.conv2, y)
        if self.downsample is not None:
            residual = self.downsample[1](self.conv(self.downsample[0], residual))
        if self.fused:
            return self.bn2(y, residual=residual)
        return F.relu(residual + self.bn2(y))


class ResNet(_Net):
    """Configurable ResNet; ``stage_sizes=[3,4,6,3]`` + bottleneck = ResNet-50.

    Takes NHWC images and returns f32 logits. Train or eval follows
    ``self.training`` (JAX's ``train=`` argument).
    """

    def __init__(self, stage_sizes, block_cls=BottleneckBlock, num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16, fused_bn=False,
                 torch_padding: bool = False):
        if fused_bn not in (False, True, "pallas"):
            raise ValueError(f"fused_bn must be False, True or 'pallas', got {fused_bn!r}")
        if fused_bn == "pallas" and block_cls is not BottleneckBlock:
            # Only the bottleneck block has the 1x1-conv site the kernel
            # fuses; silently running the plain fused path would measure
            # the wrong program.
            raise ValueError(
                "fused_bn='pallas' requires block_cls=BottleneckBlock "
                "(ResNet-50/101); use fused_bn=True for basic-block models")
        super().__init__(dtype, torch_padding, fused_bn)
        self.stage_sizes = list(stage_sizes)
        self.num_classes = num_classes
        self.conv1 = _conv(3, num_filters, 7, 2)
        self.bn1 = self.norm(num_filters, act="relu")
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            blocks = []
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(cin, filters, 2 if i > 0 and j == 0 else 1,
                                        dtype=dtype, torch_padding=torch_padding,
                                        fused=fused_bn))
                cin = filters * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.norm_relu(self.bn1, self.conv(self.conv1, x.to(self.dtype)))
        x = self.max_pool(x)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        x = x.float().mean((1, 2)).to(self.dtype)
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)
