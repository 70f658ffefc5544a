"""EfficientNet feature encoder (NCHW), the NNET normal stack's backbone.

Counterpart of :class:`sndepth_tpu.models.efficientnet.EfficientNetEncoder`
(the reference's ``tf_efficientnet_b5_ap``, `submodules/encoder.py:6-30`):
MBConv blocks with squeeze-excitation at the B5 scaling (width 1.6, depth
2.2; stage channels 24, 40, 64, 128, 176, 304, 512, depths 3, 5, 5, 7, 7, 9,
3; stem 48, head 2048). Module names are timm's, so that a reference
state_dict loads as it is and ``sndepth_tpu.utils.convert_weights.
convert_efficientnet`` maps this module's state_dict into JAX params:
``conv_stem``, ``bn1``, ``blocks.{stage}.{i}`` (stage 0, expand 1:
``conv_dw``, ``bn1``, ``se``, ``conv_pw``, ``bn2``; the others:
``conv_pw``, ``bn1``, ``conv_dw``, ``bn2``, ``se``, ``conv_pwl``, ``bn3``),
``conv_head``, ``bn2``.

Convolutions pad as TensorFlow's and flax's ``"SAME"``: at stride 2 the
total padding ``max((ceil(n / 2) - 1) 2 + k - n, 0)`` splits with the
smaller half before (0 before and 1 after for k = 3 on an even side), which
a symmetric ``padding=`` would not give. BatchNorm epsilon 1e-3 (TF's),
inference statistics. Squeeze-excitation is as wide as a quarter of the
block's input channels. Parameters stay float32; ``dtype`` is the type the
layers run in, as the JAX module's ``dtype``. The JAX package's
``ShiftDepthwise`` is a TPU layout of the depthwise convolution and has no
counterpart: depthwise convolutions are grouped ``nn.Conv2d``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.ops.norm import BatchNorm2d

BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    in_ch: int
    out_ch: int
    kernel: int
    stride: int
    expand: int
    repeats: int
    se_ratio: float = 0.25


def _round_filters(ch: int, width_mult: float, divisor: int = 8) -> int:
    ch *= width_mult
    new_ch = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new_ch < 0.9 * ch:
        new_ch += divisor
    return int(new_ch)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def b5_blocks() -> tuple[BlockSpec, ...]:
    base = [  # (in, out, k, stride, expand, repeats): the B0 plan
        (32, 16, 3, 1, 1, 1),
        (16, 24, 3, 2, 6, 2),
        (24, 40, 5, 2, 6, 2),
        (40, 80, 3, 2, 6, 3),
        (80, 112, 5, 1, 6, 3),
        (112, 192, 5, 2, 6, 4),
        (192, 320, 3, 1, 6, 1),
    ]
    w, d = 1.6, 2.2
    return tuple(
        BlockSpec(_round_filters(i, w), _round_filters(o, w), k, s, e,
                  _round_repeats(r, d))
        for i, o, k, s, e, r in base)


def same_pad(x: torch.Tensor, k: int, stride: int, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """Pad the last two axes of ``x`` as ``"SAME"`` does for a window of
    ``k`` taps at ``stride``: the smaller half of the total before."""
    span = (k - 1) * dilation + 1
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + span - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


def conv_same(layer: nn.Conv2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``layer`` with ``"SAME"`` padding, in ``dtype`` with its float32
    parameters cast."""
    k, s, d = layer.kernel_size[0], layer.stride[0], layer.dilation[0]
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(same_pad(x.to(dtype), k, s, d), layer.weight.to(dtype),
                    bias, s, 0, d, layer.groups)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(conv_same(self.conv_reduce, s, dtype))
        s = conv_same(self.conv_expand, s, dtype)
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """One block of ``spec`` taking ``in_ch`` channels at ``stride``:
    timm's DepthwiseSeparableConv where ``spec.expand == 1``, else its
    InvertedResidual; the residual where the shape is kept."""

    def __init__(self, spec: BlockSpec, stride: int, in_ch: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.expand = spec.expand
        self.residual = stride == 1 and in_ch == spec.out_ch
        mid = in_ch * spec.expand
        se = SqueezeExcite(mid, max(1, int(in_ch * spec.se_ratio)))
        dw = nn.Conv2d(mid, mid, spec.kernel, stride, groups=mid, bias=False)
        if spec.expand == 1:
            self.conv_dw, self.bn1, self.se = dw, BatchNorm2d(mid, BN_EPS), se
            self.conv_pw = nn.Conv2d(mid, spec.out_ch, 1, bias=False)
            self.bn2 = BatchNorm2d(spec.out_ch, BN_EPS)
        else:
            self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.bn1 = BatchNorm2d(mid, BN_EPS)
            self.conv_dw, self.bn2, self.se = dw, BatchNorm2d(mid, BN_EPS), se
            self.conv_pwl = nn.Conv2d(mid, spec.out_ch, 1, bias=False)
            self.bn3 = BatchNorm2d(spec.out_ch, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.expand == 1:
            norms = (self.bn1, self.bn2)
            h = x
            project = self.conv_pw
        else:
            norms = (self.bn2, self.bn3)
            h = F.silu(self.bn1(conv_same(self.conv_pw, x, dt)).to(dt))
            project = self.conv_pwl
        h = F.silu(norms[0](conv_same(self.conv_dw, h, dt)).to(dt))
        h = self.se(h, dt)
        h = norms[1](conv_same(project, h, dt)).to(dt)
        return h + x if self.residual else h


class EfficientNetEncoder(nn.Module):
    """Input (B, 3, H, W); returns the feature dict ``stem`` (1/2),
    ``stage0`` .. ``stage6``, ``head`` (``head_ch`` channels, 1/32), each
    NCHW in ``dtype``."""

    def __init__(self, blocks: Sequence[BlockSpec] | None = None,
                 stem_ch: int = 48, head_ch: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_specs = tuple(blocks or b5_blocks())
        self.dtype = dtype
        self.conv_stem = nn.Conv2d(3, stem_ch, 3, 2, bias=False)
        self.bn1 = BatchNorm2d(stem_ch, BN_EPS)
        stages, in_ch = [], stem_ch
        for spec in self.block_specs:
            stage = []
            for ri in range(spec.repeats):
                stage.append(MBConv(spec, spec.stride if ri == 0 else 1,
                                    in_ch, dtype))
                in_ch = spec.out_ch
            stages.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = nn.Conv2d(in_ch, head_ch, 1, bias=False)
        self.bn2 = BatchNorm2d(head_ch, BN_EPS)

    def channels(self) -> dict:
        """Channels of each feature the decoder reads."""
        specs = self.block_specs
        return {"stage0": specs[0].out_ch, "stage1": specs[1].out_ch,
                "stage2": specs[2].out_ch, "stage4": specs[4].out_ch,
                "head": self.conv_head.out_channels}

    def forward(self, x: torch.Tensor) -> dict:
        dt = self.dtype
        feats = {}
        h = F.silu(self.bn1(conv_same(self.conv_stem, x, dt)).to(dt))
        feats["stem"] = h
        for si, stage in enumerate(self.blocks):
            h = stage(h)
            feats[f"stage{si}"] = h
        h = F.silu(self.bn2(conv_same(self.conv_head, h, dt)).to(dt))
        feats["head"] = h
        return feats


# The feature keys the normal decoder consumes, mirroring the reference's
# features[4]/[5]/[6]/[8]/[11] selection (`submodules/decoder.py:60`).
DECODER_FEATURE_KEYS = ("stage0", "stage1", "stage2", "stage4", "head")
