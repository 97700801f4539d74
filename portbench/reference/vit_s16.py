"""Plain float32 ViT-S/16 (Dosovitskiy et al., arXiv:2010.11929; DeiT-S,
arXiv:2012.12877), trained as the configuration states, from its own
equations:

- a stride-16 16x16 convolution patchifies the NHWC image; a learned class
  token is put first and a learned position table added (sized by the
  crop: ``(crop / 16)^2 + 1`` rows);
- pre-LN encoder blocks: LayerNorm (eps 1e-6, the biased variance), q, k
  and v projections with biases, softmax attention over every token with
  the scale ``1 / sqrt(head_dim)``, an output projection, the residual;
  LayerNorm, an MLP of exact (erf) GELU, the residual;
- a final LayerNorm and a linear head on the class token; mean softmax
  cross-entropy.

With a lower :class:`~portbench.reference._plain.Precision` the dense
layers, the patch projection and the activations round where the
configuration keeps bfloat16; LayerNorm's arithmetic, attention's products
and softmax, and the head stay float32.

Names are those of the port's ViT ``state_dict`` (``blocks.<i>.q``,
``attn_out``, ``mlp_in``...), so one state loads into both. Weights
(:func:`weight_specs`) are drawn as DeiT initialises them: linear weights,
the position table and the class token normal with std 0.02, the patch
kernel LeCun-normal, biases zero, LayerNorm scales one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ._plain import Precision


class _LN(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x, eps: float):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * self.weight + self.bias


class _Block(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int, device=None):
        super().__init__()
        self.heads = heads
        self.ln_attn = _LN(d, device)
        self.q, self.k, self.v, self.attn_out = (nn.Linear(d, d, device=device) for _ in range(4))
        self.ln_mlp = _LN(d, device)
        self.mlp_in = nn.Linear(d, mlp, device=device)
        self.mlp_out = nn.Linear(mlp, d, device=device)

    def forward(self, x, prec: Precision, eps: float):
        b, n, d = x.shape

        def heads(t):
            return t.view(b, n, self.heads, d // self.heads).transpose(1, 2)

        h = prec.act(self.ln_attn(x, eps))
        q, k, v = (heads(prec.linear(h, lin.weight, lin.bias)) for lin in (self.q, self.k, self.v))
        # Attention's products and softmax in float32, as the configuration states.
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // self.heads)
        o = torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, n, d)
        x = prec.act(x + prec.linear(prec.act(o), self.attn_out.weight, self.attn_out.bias))
        h = prec.linear(prec.act(self.ln_mlp(x, eps)), self.mlp_in.weight, self.mlp_in.bias)
        return prec.act(x + prec.linear(prec.act(F.gelu(h)), self.mlp_out.weight,
                                        self.mlp_out.bias))


class Reference(nn.Module):
    """The configuration's ViT at ``crop`` pixels a side: NHWC float images
    in, float32 logits out."""

    def __init__(self, config: dict, crop: int, precision: str | None = None, device=None):
        super().__init__()
        self.prec = Precision(precision)
        d, p = int(config["hidden_size"]), int(config["patch_size"])
        if crop % p:
            raise ValueError(f"crop {crop} is not a multiple of the patch {p}")
        self.patch, self.dim, self.eps = p, d, float(config["layer_norm_eps"])
        self.patch_embed = nn.Conv2d(3, d, p, stride=p, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, (crop // p) ** 2 + 1, d, device=device))
        self.blocks = nn.ModuleList(
            _Block(d, int(config["num_heads"]), int(config["mlp_dim"]), device)
            for _ in range(int(config["num_layers"])))
        self.ln_final = _LN(d, device)
        self.head = nn.Linear(d, int(config["num_classes"]), device=device)

    def forward(self, images):
        b = images.shape[0]
        x = self.prec.conv2d(images.permute(0, 3, 1, 2), self.patch_embed.weight,
                             self.patch_embed.bias, stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        cls = self.prec.act(self.cls_token).expand(b, 1, self.dim)
        x = self.prec.act(torch.cat([cls, x], dim=1) + self.prec.act(self.pos_embed))
        for block in self.blocks:
            x = block(x, self.prec, self.eps)
        x = self.prec.act(self.ln_final(x, self.eps))
        return F.linear(x[:, 0], self.head.weight, self.head.bias)


def weight_specs(config: dict, crop: int) -> list[tuple[str, tuple, tuple]]:
    """``(name, shape, init)`` of every tensor of the training state."""
    specs = []
    for name, t in Reference(config, crop, device="meta").state_dict().items():
        shape = tuple(t.shape)
        if name == "patch_embed.weight":
            init = ("normal", 1.0 / math.sqrt(shape[1] * shape[2] * shape[3]))
        elif name in ("pos_embed", "cls_token") or (name.endswith(".weight") and len(shape) == 2):
            init = ("normal", 0.02)
        elif name.endswith(".weight"):  # LayerNorm scales
            init = ("const", 1.0)
        else:
            init = ("const", 0.0)
        specs.append((name, shape, init))
    return specs
