"""The ViT-S/16 image feature extractor (DINO), averaged over scales.

Counterpart of ``sndepth_tpu/models/vit.py``, under DINO's (timm's)
state_dict names (``cls_token``, ``pos_embed``, ``patch_embed.proj``,
``blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``,
``norm``), so that ``convert_dino_vit`` maps a state_dict of the port to the
JAX package's parameters: patch 16, depth 12, width 384, 6 heads. The
position embeddings of the 14 x 14 grid (224 x 224 inputs) are resized to
the input's token grid as ``jax.image.resize`` "bilinear" resizes (half-pixel
centres, antialiased where it shrinks); the final-norm class embedding is
the feature. :class:`MultiScaleImageFeatureExtractor` normalises with the
ImageNet statistics and averages that feature over the scales 1, 1/2 and
1/3.

As in JAX: LayerNorm at epsilon 1e-6; the MLP's GELU in its exact (erf)
form; the query scaled before the attention product. Everything runs in
float32, as in ``models.vae``. Images NCHW; their sides multiples of 16.
:func:`init_weights` gives seeded weights for a run without a checkpoint.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.attention import dot_product_attention
from sndepth_tpu_torch.ops import layers
from sndepth_tpu_torch.ops.resize import resize_bilinear_antialias

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads,
                                      d // self.heads).unbind(2)
        return self.proj(dot_product_attention(q, k, v).reshape(b, n, d))


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, 3, H, W) -> the final-norm class embedding (B, dim), float32."""

    def __init__(self, patch: int = 16, dim: int = 384, depth: int = 12,
                 heads: int = 6, base_grid: int = 14):
        super().__init__()
        self.patch, self.dim, self.base_grid = patch, dim, base_grid
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            0.02 * torch.randn(1, base_grid * base_grid + 1, dim))
        self.blocks = nn.ModuleList(_Block(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        gh, gw = h // self.patch, w // self.patch
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        grid_pos = grid_pos.reshape(1, self.base_grid, self.base_grid,
                                    self.dim).permute(0, 3, 1, 2)
        grid_pos = resize_bilinear_antialias(grid_pos, gh, gw)
        tokens = tokens + grid_pos.flatten(2).transpose(1, 2)
        cls = (self.cls_token + cls_pos).expand(b, 1, self.dim)
        x = torch.cat([cls, tokens], 1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)[:, 0]


class MultiScaleImageFeatureExtractor(nn.Module):
    """ImageNet-normalise (B, 3, H, W) in [0, 1], then average the ViT's
    class embedding over ``scale_factors``, each scale's sides floored to
    a multiple of 16 (at least 16)."""

    def __init__(self, scale_factors: Sequence[float] = (1.0, 1.0 / 2,
                                                         1.0 / 3)):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        self.net = ViT()

    def forward(self, image_rgb: torch.Tensor) -> torch.Tensor:
        mean = torch.tensor(IMAGENET_MEAN, dtype=image_rgb.dtype,
                            device=image_rgb.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, dtype=image_rgb.dtype,
                           device=image_rgb.device)[:, None, None]
        img = (image_rgb - mean) / std
        h, w = img.shape[2:]
        total = None
        for s in self.scale_factors:
            inp = img
            if s != 1.0:
                nh = max((int(h * s) // 16) * 16, 16)
                nw = max((int(w * s) // 16) * 16, 16)
                inp = resize_bilinear_antialias(img, nh, nw)
            feat = self.net(inp)
            total = feat if total is None else total + feat
        return total / len(self.scale_factors)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """:func:`sndepth_tpu_torch.ops.layers.init_weights`, then each ViT's
    position embedding normal with deviation 0.02 and its class token zero,
    drawn from ``generator``."""
    layers.init_weights(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, ViT):
                m.pos_embed.normal_(0.0, 0.02, generator=generator)
                m.cls_token.zero_()
