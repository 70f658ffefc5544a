"""Alternate disparity networks, kept for the reference's model surface.

Counterpart of ``sndepth_tpu/models/dispnet_alt.py`` (NCHW here):

* :class:`DispNet`: the reference ``models/DispNet.py:46`` variant of
  DispNetS, one convolution an encoder level, the same decoder, skips and
  ``alpha * sigmoid + beta`` heads;
* :class:`DispUNet`: the reference ``models/DispUnet.py`` U-Net generator
  (``define_G``): ``num_downs`` 4x4 stride-2 halvings with leaky ReLU and
  instance norm, optional Gaussian noise at the bottleneck, transposed
  convolutions back up with skips, a tanh output.

Neither is on a training or serving path, in the reference or here.
:func:`~sndepth_tpu_torch.utils.weights.dispnet_alt_state_dict_from_jax`
and :func:`~sndepth_tpu_torch.utils.weights.dispunet_state_dict_from_jax`
carry the JAX parameters across.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.dispnet import (DispNetS, _crop_like, conv,
                                              conv_transpose)
from sndepth_tpu_torch.ops.norm import GroupNorm


class DispNet(DispNetS):
    """DispNetS with one stride-2 convolution an encoder level
    (``conv{i}.0``); input (B, 3, H, W), output (disp1, ..., disp4)."""

    def __init__(self, alpha: float = 10.0, beta: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__(alpha, beta, dtype=dtype)
        c_in = 3
        for i, (planes, k) in enumerate(zip(
                (32, 64, 128, 256, 512, 512, 512), (7, 5, 3, 3, 3, 3, 3))):
            setattr(self, f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(c_in, planes, k, 2, (k - 1) // 2), nn.ReLU()))
            c_in = planes

    def _head(self, t: int, x: torch.Tensor) -> torch.Tensor:
        # The JAX variant's heads run in float32 whatever ``dtype`` is.
        d = conv(getattr(self, f"predict_disp{t}")[0], x.float(),
                 torch.float32)
        return self.alpha * torch.sigmoid(d) + self.beta

    def _encode(self, x: torch.Tensor) -> list:
        feats, h = [], x
        for i in range(7):
            h = F.relu(conv(getattr(self, f"conv{i + 1}")[0], h, self.dtype))
            feats.append(h)
        return feats


class GaussianNoiseLayer(nn.Module):
    """Adds ``noise`` (unit Gaussian, drawn by the caller) where given."""

    def forward(self, x: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        return x if noise is None else x + noise.to(x.dtype)


class DispUNet(nn.Module):
    """forward(x, noise=None): x (B, 3, H, W) -> (B, out_channels, H, W)
    in (-1, 1); ``noise`` has the bottleneck's shape (B, min(2^(n-1) base,
    8 base), H / 2^n, W / 2^n), n = ``num_downs``."""

    def __init__(self, out_channels: int = 1, base: int = 64,
                 num_downs: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_downs, self.dtype = num_downs, dtype
        widths = [min(base * 2 ** i, 8 * base) for i in range(num_downs)]
        c_in = 3
        for i, c in enumerate(widths):
            setattr(self, f"down{i}", nn.Conv2d(c_in, c, 4, 2, 1))
            if i != num_downs - 1:
                setattr(self, f"down_norm{i}", GroupNorm(c, c))
            c_in = c
        self.noise = GaussianNoiseLayer()
        for i in reversed(range(num_downs)):
            c = widths[i - 1] if i > 0 else base
            setattr(self, f"up{i}", nn.ConvTranspose2d(c_in, c, 3, 2, 1, 1))
            if i > 0:
                setattr(self, f"up_norm{i}", GroupNorm(c, c))
                c = 2 * c
            c_in = c
        self.out = nn.Conv2d(c_in, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        skips, h = [], x
        for i in range(self.num_downs):
            h = F.leaky_relu(conv(getattr(self, f"down{i}"), h, dt), 0.2)
            if i != self.num_downs - 1:
                h = getattr(self, f"down_norm{i}")(h)
            skips.append(h)
        h = self.noise(h, noise)
        for i in reversed(range(self.num_downs)):
            target = skips[i - 1] if i > 0 else x
            h = conv_transpose(getattr(self, f"up{i}"), F.relu(h), dt)
            h = _crop_like(h, target)
            if i > 0:
                h = torch.cat([getattr(self, f"up_norm{i}")(h),
                               skips[i - 1]], 1)
        return torch.tanh(conv(self.out, h.float(), torch.float32))
