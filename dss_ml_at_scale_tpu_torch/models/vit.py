"""Vision Transformer classifier: the port of ``dss_ml_at_scale_tpu/models/vit.py``.

The second image-model family beside the ResNet, computed as the flax
model computes it:

- the patchify is one stride-``patch`` convolution over NHWC images, its
  kernel in torch's OIHW layout (flax's HWIO transposed);
- a learned ``cls_token`` (zeros at init) and a position table
  ``pos_embed`` of ``(image_size / patch)^2 + 1`` rows (normal(0.02)),
  sized by the crop the model is built for;
- pre-LN encoder blocks: flax's ``LayerNorm`` (eps 1e-6, mean and variance
  as ``E[x^2] - E[x]^2`` in f32, the normalized value in f32, rounded to
  the model dtype), separate q/k/v projections, bidirectional attention
  through :func:`..ops.flash_attention.attention_reference` (f32 scores
  and softmax, as the JAX model: no kernel runs here), exact (erf) GELU;
- every projection as flax's ``Dense(dtype=bf16)``: input, kernel and
  bias rounded to the model dtype, the bias added to the rounded product;
  parameters stay f32; the head is an f32 product of the CLS token.

No BatchNorm: the model has no running statistics and is the same in
train and eval mode. Parameter names follow flax's modules
(``blocks.<i>`` for ``block_<i>``); :func:`..models.pretrained.convert_torchvision_vit`
maps torchvision's ``VisionTransformer`` layout onto them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import attention_reference
from .transformer import _dense


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``: f32 statistics and arithmetic,
    the result rounded to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)


class ViTBlock(nn.Module):
    """Pre-LN encoder block: LN -> MHA -> residual, LN -> MLP -> residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.ln_attn = LayerNorm(dim, dtype=dtype, device=device)
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)
        self.attn_out = nn.Linear(dim, dim, device=device)
        self.ln_mlp = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp_in = nn.Linear(dim, dim * mlp_ratio, device=device)
        self.mlp_out = nn.Linear(dim * mlp_ratio, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [b, n, dim]
        b, n, _ = x.shape

        def heads(t):  # [b, n, dim] -> [b, heads, n, head_dim]
            return t.view(b, n, self.num_heads, self.dim // self.num_heads).transpose(1, 2)

        h = self.ln_attn(x)
        q, k, v = (heads(_dense(h, lin, self.dtype)) for lin in (self.q, self.k, self.v))
        out = attention_reference(q, k, v, causal=False)
        out = out.transpose(1, 2).reshape(b, n, self.dim)
        x = x + _dense(out, self.attn_out, self.dtype)
        h = F.gelu(_dense(self.ln_mlp(x), self.mlp_in, self.dtype))  # exact (erf)
        return x + _dense(h, self.mlp_out, self.dtype)


class ViT(nn.Module):
    """Vision Transformer over NHWC images of ``image_size`` pixels a side:
    ``[b, h, w, 3]`` in, ``[b, num_classes]`` f32 logits out."""

    def __init__(self, num_classes: int, image_size: int = 224, patch: int = 16,
                 dim: int = 192, depth: int = 12, num_heads: int = 3, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image {image_size}x{image_size} not divisible by patch {patch}")
        self.num_classes, self.image_size, self.patch = num_classes, image_size, patch
        self.dim, self.depth, self.num_heads, self.dtype = dim, depth, num_heads, dtype
        n = (image_size // patch) ** 2
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim, device=device))
        self.blocks = nn.ModuleList(
            ViTBlock(dim, num_heads, mlp_ratio, dtype, device=device) for _ in range(depth))
        self.ln_final = LayerNorm(dim, dtype=dtype, device=device)
        self.head = nn.Linear(dim, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        if h % self.patch or w % self.patch:
            raise ValueError(f"image {h}x{w} not divisible by patch {self.patch}")
        n = (h // self.patch) * (w // self.patch)
        if n + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"image {h}x{w} gives {n} patches; the position table was "
                             f"built for {self.image_size}x{self.image_size}")
        conv = self.patch_embed
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), conv.weight.to(self.dtype),
                     stride=self.patch)
        x = y.flatten(2).transpose(1, 2) + conv.bias.to(self.dtype)  # [b, n, dim]
        cls = self.cls_token.to(self.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        return F.linear(x[:, 0].float(), self.head.weight, self.head.bias)


def vit_t16(num_classes: int, **kw) -> ViT:
    """ViT-Ti/16: 192 dim, 12 blocks, 3 heads (~5.7M params)."""
    return ViT(num_classes, patch=16, dim=192, depth=12, num_heads=3, **kw)


def vit_s16(num_classes: int, **kw) -> ViT:
    """ViT-S/16: 384 dim, 12 blocks, 6 heads (~22M params)."""
    return ViT(num_classes, patch=16, dim=384, depth=12, num_heads=6, **kw)


def vit_tiny(num_classes: int, **kw) -> ViT:
    """The CI-sized geometry of the JAX factory's ``vit-tiny``: patch 8,
    32 dim, 2 blocks, 2 heads."""
    return ViT(num_classes, patch=8, dim=32, depth=2, num_heads=2, **kw)
