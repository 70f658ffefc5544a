"""DispNetS: multi-scale disparity encoder-decoder (NCHW).

Counterpart of :class:`sndepth_tpu.models.dispnet.DispNetS` on its default
path, with the reference's module names
(reference `models/DispNetS.py:42-136`) so that a reference
state_dict loads as it is: ``conv{i}.0/.2`` (stride-2 then stride-1 conv of
encoder level i), ``upconv{i}.0`` (``ConvTranspose2d(k3, s2, p1, op1)``),
``iconv{i}.0`` and ``predict_disp{i}.0``. Heads are
``alpha * sigmoid(d) + beta`` computed in float32.

Parameters stay float32; ``dtype`` is the type the convolutions run in (the
JAX model's ``dtype``), so bfloat16 casts weights and activations at each
layer as flax does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Apply ``layer`` in ``dtype`` with its float32 parameters cast."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                    layer.stride, layer.padding)


def conv_transpose(layer: nn.ConvTranspose2d, x: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype),
                              layer.bias.to(dtype), layer.stride,
                              layer.padding, layer.output_padding)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Xavier-uniform weights and zero biases, as the JAX models' init,
    drawn from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            rf = m.weight[0, 0].numel()
            fan = (m.weight.shape[0] + m.weight.shape[1]) * rf
            bound = (6.0 / fan) ** 0.5
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()


def _crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x[..., :ref.shape[2], :ref.shape[3]]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of an NCHW tensor, half-pixel centres
    (``jax.image.resize(..., "bilinear")`` for an upsample)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class DispNetS(nn.Module):
    """Input (B, 3, H, W) in [-1, 1]; returns (disp1, disp2, disp3, disp4),
    each (B, 1, H/2^s, W/2^s) float32, finest first."""

    def __init__(self, alpha: float = 10.0, beta: float = 0.01,
                 enc_planes: Sequence[int] = (32, 64, 128, 256, 512, 512, 512),
                 dec_planes: Sequence[int] = (512, 512, 256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alpha, self.beta, self.dtype = alpha, beta, dtype
        ep, dp = tuple(enc_planes), tuple(dec_planes)
        kernels = (7, 5, 3, 3, 3, 3, 3)
        c_in = 3
        for i, (planes, k) in enumerate(zip(ep, kernels)):
            p = (k - 1) // 2
            setattr(self, f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(c_in, planes, k, 2, p), nn.ReLU(),
                nn.Conv2d(planes, planes, k, 1, p), nn.ReLU()))
            c_in = planes
        # Decoder index i (JAX _UpConv_i / _IConv_i) is torch level 7 - i.
        up_in = (ep[6],) + dp[:6]
        skip = (ep[5], ep[4], ep[3], ep[2], ep[1] + 1, ep[0] + 1, 1)
        for i in range(7):
            t = 7 - i
            setattr(self, f"upconv{t}", nn.Sequential(
                nn.ConvTranspose2d(up_in[i], dp[i], 3, 2, 1, 1), nn.ReLU()))
            setattr(self, f"iconv{t}", nn.Sequential(
                nn.Conv2d(dp[i] + skip[i], dp[i], 3, 1, 1), nn.ReLU()))
        for t, planes in ((4, dp[3]), (3, dp[4]), (2, dp[5]), (1, dp[6])):
            setattr(self, f"predict_disp{t}", nn.Sequential(
                nn.Conv2d(planes, 1, 3, 1, 1), nn.Sigmoid()))

    def _up(self, t: int, x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, f"upconv{t}")[0]
        return _crop_like(F.relu(conv_transpose(layer, x, self.dtype)), ref)

    def _iconv(self, t: int, *xs: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, f"iconv{t}")[0]
        return F.relu(conv(layer, torch.cat(xs, 1), self.dtype))

    def _head(self, t: int, x: torch.Tensor) -> torch.Tensor:
        d = conv(getattr(self, f"predict_disp{t}")[0], x, self.dtype)
        return self.alpha * torch.sigmoid(d.float()) + self.beta

    def forward(self, x: torch.Tensor):
        dt = self.dtype
        x = x.to(dt)
        feats, h = [], x
        for i in range(7):
            block = getattr(self, f"conv{i + 1}")
            h = F.relu(conv(block[0], h, dt))
            h = F.relu(conv(block[2], h, dt))
            feats.append(h)
        c1, c2, c3, c4, c5, c6, c7 = feats

        i7 = self._iconv(7, self._up(7, c7, c6), c6)
        i6 = self._iconv(6, self._up(6, i7, c5), c5)
        i5 = self._iconv(5, self._up(5, i6, c4), c4)
        i4 = self._iconv(4, self._up(4, i5, c3), c3)
        disp4 = self._head(4, i4)

        d4_up = _crop_like(upsample2x(disp4), c2).to(dt)
        i3 = self._iconv(3, self._up(3, i4, c2), c2, d4_up)
        disp3 = self._head(3, i3)

        d3_up = _crop_like(upsample2x(disp3), c1).to(dt)
        i2 = self._iconv(2, self._up(2, i3, c1), c1, d3_up)
        disp2 = self._head(2, i2)

        d2_up = _crop_like(upsample2x(disp2), x).to(dt)
        i1 = self._iconv(1, self._up(1, i2, x), d2_up)
        disp1 = self._head(1, i1)
        return disp1, disp2, disp3, disp4
