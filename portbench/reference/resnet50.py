"""Plain float32 ResNet-50 (He et al., arXiv:1512.03385; the torchvision
``resnet50`` layout, stride on the 3x3 conv), trained as the configuration
states, from its own equations:

- every convolution with TensorFlow's SAME padding (the odd pixel on the
  high side), the 3x3 stride-2 max-pool too, with -inf;
- BatchNorm in training mode over (N, H, W): the batch mean and the biased
  variance normalize; the running averages move as
  ``r = 0.9 r + 0.1 batch`` (flax's momentum convention, the biased
  variance); eps 1e-5;
- bottleneck blocks ``relu(bn3(conv3(relu(bn2(conv2(relu(bn1(conv1 x))))))) + shortcut)``
  with a projection shortcut (1x1 conv and BN) where the shape changes;
- global average pooling, a linear head, mean softmax cross-entropy.

With a lower :class:`~portbench.reference._plain.Precision` the
convolutions and the activations round where the configuration keeps
bfloat16; the statistics and the head stay float32.

Parameter and buffer names are torchvision's, which the port's ResNet
keeps, so one ``state_dict`` loads into both. The weights are drawn as
torchvision initialises them (:func:`weight_specs`): convolutions normal
with std ``sqrt(2 / fan_out)``, BN scales one and shifts zero (no
zero-initialised last scale, so every layer's gradient is nonzero), the
head normal with std ``1 / sqrt(fan_in)`` and a zero bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ._plain import Precision, same_pad


class _BN(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x, momentum: float, eps: float):
        mean = x.mean((0, 2, 3))
        var = (x - mean[:, None, None]).square().mean((0, 2, 3))
        with torch.no_grad():
            self.running_mean.mul_(momentum).add_((1 - momentum) * mean)
            self.running_var.mul_(momentum).add_((1 - momentum) * var)
        inv = torch.rsqrt(var + eps)
        return ((x - mean[:, None, None]) * (inv * self.weight)[:, None, None]
                + self.bias[:, None, None])


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, device=None):
        super().__init__()
        self.stride, self.k = stride, k
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))

    def forward(self, x, prec: Precision):
        (hl, hh), (wl, wh) = (same_pad(x.shape[2], self.k, self.stride),
                              same_pad(x.shape[3], self.k, self.stride))
        if hl or hh or wl or wh:
            x = F.pad(x, (wl, wh, hl, hh))
        return prec.conv2d(x, self.weight, stride=self.stride)


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, expansion: int, device=None):
        super().__init__()
        cout = width * expansion
        self.conv1, self.bn1 = _Conv(cin, width, 1, device=device), _BN(width, device)
        self.conv2, self.bn2 = _Conv(width, width, 3, stride, device=device), _BN(width, device)
        self.conv3, self.bn3 = _Conv(width, cout, 1, device=device), _BN(cout, device)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.ModuleList([_Conv(cin, cout, 1, stride, device=device),
                                             _BN(cout, device)])

    def forward(self, x, prec, m, eps):
        y = prec.act(F.relu(self.bn1(self.conv1(x, prec), m, eps)))
        y = prec.act(F.relu(self.bn2(self.conv2(y, prec), m, eps)))
        y = self.bn3(self.conv3(y, prec), m, eps)
        short = x if self.downsample is None else prec.act(self.downsample[1](
            self.downsample[0](x, prec), m, eps))
        return prec.act(F.relu(y + short))


class Reference(nn.Module):
    """The configuration's ResNet: NHWC float images in, float32 logits out."""

    def __init__(self, config: dict, crop: int, precision: str | None = None, device=None):
        super().__init__()
        self.prec = Precision(precision)
        self.momentum, self.eps = float(config["bn_momentum"]), float(config["bn_eps"])
        w0, exp = int(config["num_filters"]), int(config["expansion"])
        self.conv1 = _Conv(3, w0, int(config["stem_kernel"]), 2, device=device)
        self.bn1 = _BN(w0, device)
        cin = w0
        for i, count in enumerate(config["stage_sizes"]):
            width = w0 * 2 ** i
            blocks = []
            for j in range(count):
                blocks.append(_Bottleneck(cin, width, 2 if i > 0 and j == 0 else 1, exp, device))
                cin = width * exp
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.n_stages = len(config["stage_sizes"])
        self.fc = nn.Linear(cin, int(config["num_classes"]), device=device)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        m, eps = self.momentum, self.eps
        x = self.prec.act(F.relu(self.bn1(self.conv1(x, self.prec), m, eps)))
        (hl, hh), (wl, wh) = same_pad(x.shape[2], 3, 2), same_pad(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")), 3, 2)
        for i in range(self.n_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, self.prec, m, eps)
        return F.linear(self.prec.act(x.mean((2, 3))), self.fc.weight, self.fc.bias)


def weight_specs(config: dict, crop: int) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, init)`` of every tensor of the training state."""
    specs = []
    for name, t in Reference(config, crop, device="meta").state_dict().items():
        shape = tuple(t.shape)
        if name == "fc.weight":
            init = ("normal", 1.0 / math.sqrt(shape[1]))
        elif name.endswith(".weight") and len(shape) == 4:
            init = ("normal", math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])))
        elif name.endswith((".weight", "running_var")):
            init = ("const", 1.0)
        else:
            init = ("const", 0.0)
        specs.append((name, shape, init))
    return specs
