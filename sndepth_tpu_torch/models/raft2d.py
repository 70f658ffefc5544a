"""RAFT optical flow (2-D), in two variants.

Counterpart of ``sndepth_tpu/models/raft2d.py``:

* :class:`RAFT2D`, the lighter flow net built from the RAFT3D blocks of
  :mod:`sndepth_tpu_torch.models.raft3d` (feature and context encoders, the
  streaming correlation lookup :func:`corr_lookup_dot`, the dual-dilation
  ConvGRU, convex upsampling); it launches no hand-written kernel;
* :class:`RAFT2DLarge`, torchvision's ``raft_large`` under torchvision's
  state_dict names: an instance-norm feature encoder, a BatchNorm context
  encoder on its running statistics, the separable ConvGRU, the all-pairs
  volume pooled into a pyramid (:func:`tv_corr_pyramid`) and its windowed
  lookup (:func:`tv_corr_lookup`), which samples every level through
  :func:`sndepth_tpu_torch.ops.warp.bilinear_sampler_zero_pad`: the gather
  kernel (K5) on a CUDA tensor, 4 levels x 12 iterations = 48 launches a
  frame.

As in the JAX package, the convolutions before a norm carry no bias
(torchvision's do; :func:`sndepth_tpu_torch.utils.weights.
raft2d_large_checkpoint` drops them from a torchvision file as the JAX
converter does). Images (B, 3, H, W), H and W multiples of 8; both nets
return the upsampled flow channel-last, (B, H, W, 2), as the JAX nets do.
Parameters stay float32; ``dtype`` is the type the encoders and the update
block's convolutions run in; correlation, lookup and the heads' last
convolutions are float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.raft3d import (BasicEncoder, ConvGRU,
                                             _batch_norm, _conv,
                                             _instance_norm, corr_lookup_dot,
                                             cvx_upsample, grad_clip,
                                             pool_fmap_pyramid)
from sndepth_tpu_torch.ops import projective as pops
from sndepth_tpu_torch.ops.warp import bilinear_sampler_zero_pad


def _coords0(b: int, h8: int, w8: int, like: torch.Tensor) -> torch.Tensor:
    x, y = pops.pixel_axes(h8, w8, like)
    return torch.stack([x, y], -1).expand(b, h8, w8, 2)


# ----------------------------------------------------------------------
# RAFT2D: the RAFT3D blocks
# ----------------------------------------------------------------------

class _FlowUpdate(nn.Module):
    """One iteration's layers (JAX ``_FlowIteration``): the correlation and
    flow encoders, the GRU and the delta and mask heads."""

    def __init__(self, hidden_dim: int, corr_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.corr1 = nn.Conv2d(corr_channels, 256, 1)
        self.corr2 = nn.Conv2d(256, 192, 3, 1, 1)
        self.flow1 = nn.Conv2d(2, 128, 7, 1, 3)
        self.flow2 = nn.Conv2d(128, 64, 3, 1, 1)
        self.motion = nn.Conv2d(192 + 64, 3 * hidden_dim, 3, 1, 1)
        self.gru = ConvGRU(hidden_dim, dtype=dtype)
        for name, out_ch in (("delta", 2), ("mask", 64 * 9)):
            setattr(self, name, nn.Sequential(
                nn.Conv2d(hidden_dim, 256, 3, 1, 1), nn.ReLU(),
                nn.Conv2d(256, out_ch, 1)))

    def _head(self, head: nn.Sequential, net: torch.Tensor) -> torch.Tensor:
        h = F.relu(_conv(head[0], net, self.dtype))
        return grad_clip(_conv(head[2], h.float(), torch.float32))

    def forward(self, net, inp, corr, flow):
        """net, inp (B, C, H, W), corr (B, L (2r+1)^2, H, W), flow
        (B, 2, H, W) -> (net, delta (B, 2, H, W), mask (B, 576, H, W))."""
        d = self.dtype
        cor = F.relu(_conv(self.corr1, corr, d))
        cor = F.relu(_conv(self.corr2, cor, d))
        flo = F.relu(_conv(self.flow1, flow, d))
        flo = F.relu(_conv(self.flow2, flo, d))
        motion = _conv(self.motion, torch.cat([cor, flo], 1), d)
        net = self.gru(net, inp, motion)
        return net, self._head(self.delta, net), self._head(self.mask, net)


class RAFT2D(nn.Module):
    """forward(image1, image2, iters) -> the upsampled flow (B, H, W, 2), or
    with ``train_mode`` the 1/8 flow (B, H/8, W/8, 2) and the upsampled
    one."""

    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.fnet = BasicEncoder(256, dtype)
        self.cnet = BasicEncoder(2 * hidden_dim, dtype)
        self.inp_conv = nn.Conv2d(hidden_dim, 3 * hidden_dim, 1)
        self.update = _FlowUpdate(
            hidden_dim, corr_levels * (2 * corr_radius + 1) ** 2, dtype)

    def forward(self, image1, image2, iters: int = 12,
                train_mode: bool = False):
        hdim = self.hidden_dim
        b, _, ht, wd = image1.shape
        fmap1 = self.fnet(image1).float()
        fmap2 = self.fnet(image2).float()
        f2_pyramid = pool_fmap_pyramid(fmap2, self.corr_levels)
        net_inp = self.cnet(image1)
        net = torch.tanh(net_inp[:, :hdim]).float()
        inp = _conv(self.inp_conv, F.relu(net_inp[:, hdim:]).float(),
                    torch.float32)
        coords0 = _coords0(b, ht // 8, wd // 8, fmap1)
        flow = torch.zeros_like(coords0)
        for _ in range(iters):
            corr = corr_lookup_dot(fmap1, f2_pyramid, coords0 + flow,
                                   self.corr_radius)
            net, delta, mask = self.update(net, inp, corr,
                                           flow.permute(0, 3, 1, 2))
            flow = flow + delta.permute(0, 2, 3, 1)
        flow_up = cvx_upsample(8.0 * flow, mask.permute(0, 2, 3, 1))
        return (flow, flow_up) if train_mode else flow_up


# ----------------------------------------------------------------------
# RAFT2DLarge: torchvision raft_large
# ----------------------------------------------------------------------

class _ConvNormAct(nn.Sequential):
    """torchvision ``Conv2dNormActivation``: index 0 the convolution, index
    1 the BatchNorm where there is one; an instance norm has no parameters
    and no index. The convolution has a bias only without a norm."""

    def __init__(self, c_in: int, c_out: int, kernel, stride: int = 1,
                 norm: str | None = None, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        layers = [nn.Conv2d(c_in, c_out, (kh, kw), stride, (kh // 2, kw // 2),
                            bias=norm is None)]
        if norm == "batch":
            layers.append(nn.BatchNorm2d(c_out))
        super().__init__(*layers)
        self.norm, self.act, self.dtype = norm, act, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self[0], x, self.dtype)
        if self.norm == "instance":
            h = _instance_norm(h)
        elif self.norm == "batch":
            h = _batch_norm(self[1], h)
        return F.relu(h) if self.act else h


class _ResidualBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, norm: str,
                 dtype: torch.dtype):
        super().__init__()
        self.convnormrelu1 = _ConvNormAct(c_in, c_out, 3, stride, norm,
                                          dtype=dtype)
        self.convnormrelu2 = _ConvNormAct(c_out, c_out, 3, 1, norm,
                                          dtype=dtype)
        self.downsample = (_ConvNormAct(c_in, c_out, 1, stride, norm, False,
                                        dtype)
                           if stride != 1 or c_in != c_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convnormrelu2(self.convnormrelu1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class FeatureEncoder(nn.Module):
    """torchvision ``FeatureEncoder(layers=(64, 64, 96, 128, 256))`` with
    ``norm`` "instance" or "batch": (B, 3, H, W) -> (B, 256, H/8, W/8) in
    ``dtype``."""

    def __init__(self, norm: str, output_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convnormrelu = _ConvNormAct(3, 64, 7, 2, norm, dtype=dtype)
        c_in = 64
        for i, (c_out, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                _ResidualBlock(c_in, c_out, stride, norm, dtype),
                _ResidualBlock(c_out, c_out, 1, norm, dtype)))
            c_in = c_out
        self.conv = nn.Conv2d(c_in, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.convnormrelu(x)
        h = self.layer3(self.layer2(self.layer1(h)))
        return _conv(self.conv, h, self.dtype)


def tv_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                    num_levels: int = 4) -> list[torch.Tensor]:
    """All-pairs correlation over sqrt(C), pooled 2x2 into a pyramid.

    fmap1, fmap2: (B, C, H, W). Level i: (B H W, 1, H / 2^i, W / 2^i), one
    plane a query pixel; odd sizes lose their last row or column (VALID
    pooling), as in JAX."""
    b, c, h, w = fmap1.shape
    corr = torch.matmul(fmap1.float().flatten(2).transpose(1, 2),
                        fmap2.float().flatten(2))
    vol = corr.reshape(b * h * w, 1, h, w) / torch.sqrt(
        torch.tensor(float(c)))
    pyramid = [vol]
    for _ in range(num_levels - 1):
        vol = F.avg_pool2d(vol, 2, 2)
        pyramid.append(vol)
    return pyramid


def tv_corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor,
                   radius: int = 4) -> torch.Tensor:
    """Windowed bilinear lookup, zero padding, ``align_corners=True``
    pixel arithmetic, on each level of :func:`tv_corr_pyramid`.

    coords: (B, H, W, 2), (x, y) in level-0 pixels, halved level by level.
    Returns (B, levels (2r+1)^2, H, W), level-major. Within a level the
    window is dx-major (torchvision's ``meshgrid(d, d, indexing="ij")``
    flattened): channel i (2r+1) + j samples (x + d_i, y + d_j), unlike
    RAFT3D's dy-major window. Each level is one call of the gather over
    the B H W query planes with a (2r+1) x (2r+1) target."""
    b, h, w, _ = coords.shape
    side = 2 * radius + 1
    d = torch.linspace(-radius, radius, side, dtype=torch.float32,
                       device=coords.device)
    dx, dy = torch.meshgrid(d, d, indexing="ij")
    offsets = torch.stack([dx, dy], 0)[None]                       # 1,2,s,s
    cc = coords.float().reshape(b * h * w, 2, 1, 1)
    out = []
    for vol in pyramid:
        sampled = bilinear_sampler_zero_pad(vol, cc + offsets)
        out.append(sampled.reshape(b, h, w, side * side))
        cc = cc / 2
    return torch.cat(out, -1).permute(0, 3, 1, 2)


class _MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int, dtype: torch.dtype):
        super().__init__()
        self.convcorr1 = _ConvNormAct(corr_channels, 256, 1, dtype=dtype)
        self.convcorr2 = _ConvNormAct(256, 192, 3, dtype=dtype)
        self.convflow1 = _ConvNormAct(2, 128, 7, dtype=dtype)
        self.convflow2 = _ConvNormAct(128, 64, 3, dtype=dtype)
        self.conv = _ConvNormAct(192 + 64, 126, 3, dtype=dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        co = self.convcorr2(self.convcorr1(corr))
        fl = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([co, fl], 1)).float(), flow], 1)


class _SepConvGRU(nn.Module):
    """A ConvGRU stage with a (1, 5) or (5, 1) kernel."""

    def __init__(self, kernel: tuple[int, int], hidden: int, c_in: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        pad = (kernel[0] // 2, kernel[1] // 2)
        for gate in ("convz", "convr", "convq"):
            setattr(self, gate, nn.Conv2d(hidden + c_in, hidden, kernel, 1,
                                          pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(_conv(self.convz, hx, self.dtype))
        r = torch.sigmoid(_conv(self.convr, hx, self.dtype))
        q = torch.tanh(_conv(self.convq, torch.cat([r * h, x], 1),
                             self.dtype))
        return (1.0 - z) * h + z * q


class _RecurrentBlock(nn.Module):
    def __init__(self, hidden: int, c_in: int, dtype: torch.dtype):
        super().__init__()
        self.convgru1 = _SepConvGRU((1, 5), hidden, c_in, dtype)
        self.convgru2 = _SepConvGRU((5, 1), hidden, c_in, dtype)


class _FlowHead(nn.Module):
    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(128, 256, 3, 1, 1)
        self.conv2 = nn.Conv2d(256, 2, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_conv(self.conv1, x, self.dtype))
        return _conv(self.conv2, h.float(), torch.float32)


class _UpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, dtype: torch.dtype):
        super().__init__()
        self.motion_encoder = _MotionEncoder(corr_channels, dtype)
        self.recurrent_block = _RecurrentBlock(128, 256, dtype)
        self.flow_head = _FlowHead(dtype)


class _MaskPredictor(nn.Module):
    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.convrelu = _ConvNormAct(128, 256, 3, dtype=dtype)
        self.conv = nn.Conv2d(256, 64 * 9, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 0.25 * _conv(self.conv, self.convrelu(x).float(), torch.float32)


class RAFT2DLarge(nn.Module):
    """torchvision ``raft_large``: forward(image1, image2, iters) -> the
    upsampled flow (B, H, W, 2), or with ``train_mode`` the 1/8 flow
    (B, H/8, W/8, 2) and the upsampled one."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.feature_encoder = FeatureEncoder("instance", dtype=dtype)
        self.context_encoder = FeatureEncoder("batch", dtype=dtype)
        self.update_block = _UpdateBlock(
            corr_levels * (2 * corr_radius + 1) ** 2, dtype)
        self.mask_predictor = _MaskPredictor(dtype)

    def iteration(self, coords1, hidden, pyramid, context, coords0):
        """One update: the lookup at ``coords1`` (B, h, w, 2), the motion
        encoder, the two GRU stages and the heads -> (coords1, hidden,
        mask (B, h, w, 576))."""
        ub = self.update_block
        corr = tv_corr_lookup(pyramid, coords1, self.corr_radius)
        flow = (coords1 - coords0).permute(0, 3, 1, 2)
        motion = ub.motion_encoder(flow, corr)
        x = torch.cat([context, motion], 1)
        hidden = ub.recurrent_block.convgru1(hidden, x)
        hidden = ub.recurrent_block.convgru2(hidden, x)
        delta = ub.flow_head(hidden)
        mask = self.mask_predictor(hidden)
        return (coords1 + delta.permute(0, 2, 3, 1), hidden,
                mask.permute(0, 2, 3, 1))

    def forward(self, image1, image2, iters: int = 12,
                train_mode: bool = False):
        b, _, ht, wd = image1.shape
        both = self.feature_encoder(torch.cat([image1, image2], 0))
        pyramid = tv_corr_pyramid(both[:b].float(), both[b:].float(),
                                  self.corr_levels)
        cnet = self.context_encoder(image1)
        hidden = torch.tanh(cnet[:, :128]).float()
        context = F.relu(cnet[:, 128:]).float()
        coords0 = _coords0(b, ht // 8, wd // 8, hidden)
        coords1 = coords0
        for _ in range(iters):
            coords1, hidden, mask = self.iteration(coords1, hidden, pyramid,
                                                   context, coords0)
        flow = coords1 - coords0
        flow_up = cvx_upsample(8.0 * flow, mask)
        return (flow, flow_up) if train_mode else flow_up
