"""Surface-normal decoder with uncertainty heads, test mode (NCHW inside).

Counterpart of :class:`sndepth_tpu.models.normal_decoder.NormalDecoder`
with ``mode="test"`` (reference `submodules/decoder.py`,
`submodules/submodules.py`): ``UpSample`` skip blocks of two
convolution + norm + leaky-ReLU stages (weight-standardised convolutions
and GroupNorm in the ``"GN"`` architecture, the reference's default;
convolutions and BatchNorm in ``"BN"``), a 4-channel head (normal xyz and
kappa) at 1/8 of the encoder's input, and three pointwise refinement MLPs
run densely at 1/4, 1/2 and 1/1, each output normalised by
:func:`norm_normalize`.

Module names are the reference's, so that ``sndepth_tpu.utils.
convert_weights.convert_normal_decoder`` maps this module's state_dict into
JAX params: ``conv2``, ``up{1..4}._net.{0,1,3,4}``, ``out_conv_res8``,
``out_conv_res{4,2,1}.{0,2,4,6}`` (``Conv1d`` of kernel 1, applied densely
as 1x1 convolutions). The train-mode point sampler (``sample_points``,
``selection_mask``, ``gather_points``/``scatter_points``) comes with NNET
training. Parameters stay float32; ``dtype`` is the type the blocks and the
MLPs' hidden layers run in, the heads run in float32, as in the JAX module.
The outputs are channel-last, (B, h, w, 4), as the JAX module returns them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.ops.norm import BatchNorm2d, GroupNorm
from sndepth_tpu_torch.ops.resize import resize_bilinear_align_corners

MIN_KAPPA = 0.01


def norm_normalize(out: torch.Tensor) -> torch.Tensor:
    """L2-normalise xyz; kappa -> elu(kappa) + 1 + 0.01
    (`submodules.py:64-70`). out: (B, 4, H, W)."""
    xyz, kappa = out[:, :3], out[:, 3:]
    norm = torch.sqrt((xyz * xyz).sum(1, keepdim=True)) + 1e-10
    kappa = F.elu(kappa) + 1.0 + MIN_KAPPA
    return torch.cat([xyz / norm, kappa], 1)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
         weight: torch.Tensor | None = None) -> torch.Tensor:
    """``layer`` (stride 1, odd kernel, symmetric padding) in ``dtype``."""
    w = layer.weight if weight is None else weight
    return F.conv2d(x.to(dtype), w.to(dtype), layer.bias.to(dtype), 1,
                    layer.padding, layer.dilation)


class WSConv2d(nn.Conv2d):
    """3x3 convolution with weight standardisation (`submodules.py:46-60`):
    each output channel's kernel, over its full extent, minus its mean and
    over its Bessel-corrected standard deviation plus 1e-5, formed at apply
    time."""

    def standardized(self) -> torch.Tensor:
        w = self.weight
        centred = w - w.mean((1, 2, 3), keepdim=True)
        n = w[0].numel()
        var = centred.var((1, 2, 3), unbiased=False, keepdim=True)
        std = torch.sqrt(var * n / (n - 1))
        return centred / (std + 1e-5)


class UpSampleBlock(nn.Module):
    """Bilinear (align-corners) upsample to the skip's size, concatenate,
    then two convolution + norm + leaky-ReLU stages (`submodules.py:10-42`).
    """

    def __init__(self, in_ch: int, features: int, architecture: str = "GN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if architecture not in ("GN", "BN"):
            raise ValueError(f"architecture {architecture!r}: GN or BN")
        self.architecture = architecture
        self.dtype = dtype
        if architecture == "GN":
            # GroupNorm at flax's epsilon, 1e-6.
            layers = [WSConv2d(in_ch, features, 3, padding=1),
                      GroupNorm(8, features, dtype=dtype), nn.LeakyReLU(0.01),
                      WSConv2d(features, features, 3, padding=1),
                      GroupNorm(8, features, dtype=dtype), nn.LeakyReLU(0.01)]
        else:
            # flax's BatchNorm epsilon, 1e-5 (the encoder's is 1e-3).
            layers = [nn.Conv2d(in_ch, features, 3, padding=1),
                      BatchNorm2d(features, dtype=dtype), nn.LeakyReLU(0.01),
                      nn.Conv2d(features, features, 3, padding=1),
                      BatchNorm2d(features, dtype=dtype), nn.LeakyReLU(0.01)]
        self._net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = resize_bilinear_align_corners(x, skip.shape[2], skip.shape[3])
        h = torch.cat([up, skip.to(up.dtype)], 1)
        for i in (0, 3):
            layer = self._net[i]
            w = (layer.standardized() if isinstance(layer, WSConv2d)
                 else None)
            h = conv(layer, h, self.dtype, w)
            h = F.leaky_relu(self._net[i + 1](h), 0.01)
        return h


def point_mlp(mlp: nn.Sequential, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The shared pointwise refinement head (`decoder.py:36-57`) applied
    densely: three kernel-1 layers with ReLU in ``dtype``, the last layer
    (4 outputs) in float32."""
    h = x.to(dtype)
    layers = [mlp[i] for i in (0, 2, 4, 6)]
    for layer in layers[:3]:
        h = F.relu(F.conv2d(h, layer.weight[..., None].to(dtype),
                            layer.bias.to(dtype)))
    last = layers[3]
    return F.conv2d(h.float(), last.weight[..., None], last.bias)


class NormalDecoder(nn.Module):
    """``decoder(features)`` -> the (B, h_s, w_s, 4) normal + kappa maps at
    1/8, 1/4, 1/2 and 1/1 of the encoder's input, float32, channel-last.

    ``channels`` are the widths of the encoder features ``stage0``,
    ``stage1``, ``stage2``, ``stage4`` and ``head`` (EfficientNet-B5's by
    default)."""

    def __init__(self, channels: dict | None = None, architecture: str = "GN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = channels or {"stage0": 24, "stage1": 40, "stage2": 64,
                          "stage4": 176, "head": 2048}
        self.dtype = dtype
        self.conv2 = nn.Conv2d(ch["head"], 2048, 1)
        self.up1 = UpSampleBlock(2048 + ch["stage4"], 1024, architecture,
                                 dtype)
        self.up2 = UpSampleBlock(1024 + ch["stage2"], 512, architecture, dtype)
        self.up3 = UpSampleBlock(512 + ch["stage1"], 256, architecture, dtype)
        self.up4 = UpSampleBlock(256 + ch["stage0"], 128, architecture, dtype)
        self.out_conv_res8 = nn.Conv2d(512, 4, 3, padding=1)
        for r, width in ((4, 512), (2, 256), (1, 128)):
            setattr(self, f"out_conv_res{r}", nn.Sequential(
                nn.Conv1d(width + 4, 128, 1), nn.ReLU(),
                nn.Conv1d(128, 128, 1), nn.ReLU(),
                nn.Conv1d(128, 128, 1), nn.ReLU(),
                nn.Conv1d(128, 4, 1)))

    def forward(self, features: dict) -> list[torch.Tensor]:
        dt = self.dtype
        x_d0 = conv(self.conv2, features["head"], dt)
        x_d1 = self.up1(x_d0, features["stage4"])
        x_d2 = self.up2(x_d1, features["stage2"])
        x_d3 = self.up3(x_d2, features["stage1"])
        x_d4 = self.up4(x_d3, features["stage0"])
        out = norm_normalize(conv(self.out_conv_res8, x_d2.float(),
                                  torch.float32))
        outs = [out]
        for feat, mlp in ((x_d2, self.out_conv_res4),
                          (x_d3, self.out_conv_res2),
                          (x_d4, self.out_conv_res1)):
            h, w = 2 * out.shape[2], 2 * out.shape[3]
            up = resize_bilinear_align_corners(out, h, w)
            feat_up = resize_bilinear_align_corners(feat, h, w)
            dense_in = torch.cat([feat_up.float(), up], 1)
            out = norm_normalize(point_mlp(mlp, dense_in, dt))
            outs.append(out)
        return [o.permute(0, 2, 3, 1) for o in outs]
