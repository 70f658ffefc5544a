"""Motion segmentation: MotionFusionNet (NCHW).

Counterpart of ``sndepth_tpu/models/motionseg.py`` (reference
`models/MotionFusionNet.py`, `MotionFeatureNet.py`, `SemanticFeatureNet.py`
and the unit factory `utils/motion_split/build_unit.py`): a flow-image tower
(512 channels at 1/16), an RGB tower (2048 channels at 1/16), their
concatenation through eight fusion units, a 1x1 convolution and a stride-16
transposed convolution to 3-class logits, each convolution followed by a
BatchNorm.

One :class:`ResidualUnit` covers the reference's four unit shapes: the plain
bottleneck (``layer_1.{0,3,6}`` with its BatchNorms at ``{1,4,7}``, the
shortcut projection ``layer_2.{0,1}``) and the dual-dilated one
(``initial_conv``, ``branch1``, ``branch2``, ``final_conv``, the projection
``down_conv``). Module names are the reference's, so that its ``best.pt``
state_dict loads as it is and ``sndepth_tpu.utils.convert_weights.
convert_motionfusion`` maps this module's state_dict into JAX variables.

Every convolution has a bias and pads as flax's ``"SAME"`` (at stride 2 the
smaller half of the padding before: 2 and 3 for the 7x7 stem, 0 and 1 for
the flow tower's 3x3); the 2x2 max pools are VALID (odd sides floor). The
head's transposed convolution (``layer3.0``, weight (in, out, 16, 16)) and
its BatchNorm run in float32, as the JAX module's (in float64 where the net
does, which the tests' float64 evaluations use); the rest in ``dtype``, with
float32 parameters. BatchNorm: epsilon 1e-5, flax's momentum, batch
statistics in train mode (:class:`~sndepth_tpu_torch.ops.norm.BatchNorm2d`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.efficientnet import conv_same
from sndepth_tpu_torch.ops.norm import BatchNorm2d


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    """One residual unit. ``branch_dilations=None`` is the plain bottleneck;
    otherwise a dual-dilated 3x3 branch pair ``branch_width`` channels wide
    in all. ``project`` adds a 1x1 convolution + BatchNorm shortcut, with a
    ReLU where ``project_relu``."""
    in_ch: int
    mid_ch: int
    out_ch: int
    stride: int = 1
    branch_width: int = 0
    branch_dilations: tuple[int, int] | None = None
    project: bool = False
    project_relu: bool = False


_u = UnitSpec

# The tower plans of the JAX package (the reference's option lists).
MOTION_UNITS: Sequence[UnitSpec] = (
    _u(64, 64, 256, stride=1, project=True, project_relu=True),
    _u(256, 64, 256),
    _u(256, 64, 256),
    _u(256, 256, 512, stride=2, project=True, project_relu=True),
    _u(512, 128, 512),
    _u(512, 256, 512, stride=2, project=True, project_relu=True),
)

SEMANTIC_UNITS: Sequence[UnitSpec] = (
    _u(64, 64, 256, stride=1, project=True, project_relu=True),
    _u(256, 64, 256),
    _u(256, 64, 256),
    _u(256, 256, 512, stride=2, project=True, project_relu=True),
    _u(512, 128, 512),
    _u(512, 128, 512),
    _u(512, 128, 512, branch_width=64, branch_dilations=(1, 2)),
    _u(512, 768, 1024, stride=2, project=True, project_relu=True),
    _u(1024, 256, 1024),
    _u(1024, 256, 1024, branch_width=256, branch_dilations=(1, 2)),
    _u(1024, 256, 1024, branch_width=256, branch_dilations=(1, 4)),
    _u(1024, 256, 1024, branch_width=256, branch_dilations=(1, 8)),
    _u(1024, 256, 1024, branch_width=256, branch_dilations=(1, 16)),
    _u(1024, 512, 2048, branch_width=256, branch_dilations=(2, 4),
       project=True),
    _u(2048, 512, 2048, branch_width=512, branch_dilations=(2, 8)),
    _u(2048, 512, 2048, branch_width=512, branch_dilations=(2, 16)),
)

FUSION_UNITS: Sequence[UnitSpec] = (
    _u(2560, 128, 512, stride=1, project=True, project_relu=True),
    _u(512, 128, 512),
    _u(512, 128, 512),
    _u(512, 256, 1024, branch_width=128, branch_dilations=(1, 2),
       project=True),
    _u(1024, 256, 1024, branch_width=128, branch_dilations=(1, 4)),
    _u(1024, 256, 1024, branch_width=128, branch_dilations=(1, 8)),
    _u(1024, 512, 2048, branch_width=256, branch_dilations=(4, 16),
       project=True),
    _u(2048, 512, 2048, branch_width=256, branch_dilations=(4, 16)),
)


def _cbr(c_in: int, c_out: int, k: int, stride: int = 1,
         dilation: int = 1, relu: bool = True) -> list[nn.Module]:
    """Convolution, BatchNorm and (where ``relu``) ReLU, as a Sequential's
    children."""
    layers = [nn.Conv2d(c_in, c_out, k, stride, dilation=dilation),
              BatchNorm2d(c_out)]
    return layers + [nn.ReLU()] if relu else layers


def cbr(seq: nn.Sequential, i: int, x: torch.Tensor, dtype: torch.dtype,
        relu: bool = True) -> torch.Tensor:
    """``seq[i]`` ("SAME" convolution in ``dtype``), ``seq[i + 1]``
    (BatchNorm) and a ReLU where ``relu``."""
    h = seq[i + 1](conv_same(seq[i], x, dtype))
    return F.relu(h) if relu else h


class ResidualUnit(nn.Module):
    def __init__(self, spec: UnitSpec, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = self.spec = spec
        self.dtype = dtype
        if s.branch_dilations is None:
            self.layer_1 = nn.Sequential(
                *_cbr(s.in_ch, s.mid_ch, 1, s.stride),
                *_cbr(s.mid_ch, s.mid_ch, 3),
                *_cbr(s.mid_ch, s.out_ch, 1))
            if s.project:
                self.layer_2 = nn.Sequential(*_cbr(
                    s.in_ch, s.out_ch, 1, s.stride, relu=s.project_relu))
        else:
            p, d = s.branch_dilations
            half = s.branch_width // 2
            self.initial_conv = nn.Sequential(
                *_cbr(s.in_ch, s.mid_ch, 1, s.stride))
            self.branch1 = nn.Sequential(*_cbr(s.mid_ch, half, 3, 1, p))
            self.branch2 = nn.Sequential(*_cbr(s.mid_ch, half, 3, 1, d))
            self.final_conv = nn.Sequential(
                *_cbr(s.branch_width, s.out_ch, 1))
            if s.project:
                self.down_conv = nn.Sequential(*_cbr(
                    s.in_ch, s.out_ch, 1, s.stride, relu=s.project_relu))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, dt = self.spec, self.dtype
        if s.branch_dilations is None:
            h = x
            for i in (0, 3, 6):
                h = cbr(self.layer_1, i, h, dt)
            project = self.layer_2 if s.project else None
        else:
            h = cbr(self.initial_conv, 0, x, dt)
            h = torch.cat([cbr(self.branch1, 0, h, dt),
                           cbr(self.branch2, 0, h, dt)], 1)
            h = cbr(self.final_conv, 0, h, dt)
            project = self.down_conv if s.project else None
        shortcut = (x if project is None
                    else cbr(project, 0, x, dt, relu=s.project_relu))
        return F.relu(h + shortcut)


class MotionFeatureNet(nn.Module):
    """Flow-image tower (B, 3, H, W) -> 512 channels at 1/16."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer1 = nn.Sequential(*_cbr(3, 64, 3, 2))
        self.layer3 = nn.Sequential(*(ResidualUnit(s, dtype)
                                      for s in MOTION_UNITS))

    def forward(self, flow: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(cbr(self.layer1, 0, flow, self.dtype), 2, 2)
        return self.layer3(x)


class SemanticFeatureNet(nn.Module):
    """RGB tower (B, 3, H, W) -> 2048 channels at 1/16."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer1 = nn.Sequential(*_cbr(3, 32, 3), *_cbr(32, 64, 7, 2))
        self.layer3 = nn.Sequential(*(ResidualUnit(s, dtype)
                                      for s in SEMANTIC_UNITS))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = cbr(self.layer1, 0, image, self.dtype)
        x = F.max_pool2d(cbr(self.layer1, 3, x, self.dtype), 2, 2)
        return self.layer3(x)


class MotionFusionNet(nn.Module):
    """``net(image, flow)``: images (B, 3, H, W) in [0, 1], H and W
    multiples of 16 -> float32 logits of the 3 classes (B, 3, H, W)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.motionFeatureNet = MotionFeatureNet(dtype)
        self.semanticFeatureNet = SemanticFeatureNet(dtype)
        self.layer1 = nn.Sequential(*(ResidualUnit(s, dtype)
                                      for s in FUSION_UNITS))
        self.layer2 = nn.Sequential(*_cbr(2048, 2048, 1))
        self.layer3 = nn.Sequential(
            nn.ConvTranspose2d(2048, 3, 16, 16), BatchNorm2d(3))

    def forward(self, image: torch.Tensor, flow: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([self.motionFeatureNet(flow),
                       self.semanticFeatureNet(image)], 1)
        x = cbr(self.layer2, 0, self.layer1(x), self.dtype)
        deconv = self.layer3[0]
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = F.conv_transpose2d(x, deconv.weight.to(x.dtype),
                               deconv.bias.to(x.dtype), 16)
        return self.layer3[1](x)


# The standard deviation of a unit normal truncated at +-2.
TRUNC_STD = 0.87962566103423978


def _trunc_normal_(w: torch.Tensor, std: float,
                   generator: torch.Generator) -> None:
    """A normal truncated at +-2 standard deviations, by redrawing the
    entries outside (fewer than 5% a round; ``nn.init.trunc_normal_``'s
    inverse error function takes seconds for this net on a CPU)."""
    w.normal_(0.0, 1.0, generator=generator)
    outside = w.abs() > 2.0
    while bool(outside.any()):
        w[outside] = torch.randn(int(outside.sum()), generator=generator)
        outside = w.abs() > 2.0
    w.mul_(std)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator`` in module order, as the JAX
    module's initialisers: kernels from a normal truncated at two standard
    deviations, of variance 2 / fan_out (fan_out = out channels x taps),
    zero biases, BatchNorm at identity."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            out_ch = (w.shape[1] if isinstance(m, nn.ConvTranspose2d)
                      else w.shape[0])
            # variance_scaling's truncated normal: the std corrected for
            # the truncation.
            std = math.sqrt(2.0 / (out_ch * w[0, 0].numel())) / TRUNC_STD
            with torch.no_grad():
                _trunc_normal_(w, std, generator)
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
