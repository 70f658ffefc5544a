"""BEVFormer encoder and decoder.

Counterpart of ``sndepth_tpu/models/bevformer.py`` (reference
`transformer_modules/encoder.py`, `decoder.py`, `transformer.py`):

* :func:`bev_pillar_points` and :func:`project_points_to_cams`: pillar
  reference points over the BEV grid, projected into every camera by its
  ``lidar2img``; ``bev_mask`` marks the points in front of a camera and
  inside its image;
* :class:`BEVFormerEncoder`: layers of temporal self-attention, spatial
  cross-attention and FFN, each followed by a LayerNorm; with ``remat``
  each of the three runs under ``torch.utils.checkpoint`` in training, so
  that its backward recomputes it (the JAX ``nn.remat`` of each sublayer);
* :class:`DetectionTransformerDecoder`: self-attention, deformable
  attention over the BEV and FFN, with the boxes' reference points refined
  in sigmoid space after every layer (and detached);
* :func:`shift_prev_bev`: the ego-motion shift and rotation of the previous
  BEV as one resample by the gather kernel K5 (``zero_pad``).

Module names are the reference's state_dict names: ``layers.{i}`` with
``attentions.{0,1}``, ``ffns.0.layers.{0.0,1}`` and ``norms.{0,1,2}``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from sndepth_tpu_torch.models.deformable import (CustomMSDeformableAttention,
                                                 SpatialCrossAttention,
                                                 TemporalSelfAttention,
                                                 _constant)
from sndepth_tpu_torch.ops.layers import (Dense, LayerNorm, MultiheadAttention,
                                          at_least_f32)
from sndepth_tpu_torch.ops.warp import bilinear_sampler_zero_pad


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def _centres(n: int, device) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n


def bev_pillar_points(bev_h: int, bev_w: int, num_z: int,
                      pc_range: Sequence[float], device=None
                      ) -> torch.Tensor:
    """(num_z, bev_h bev_w, 3) pillar points in lidar coordinates."""
    zs, xs, ys = (_centres(n, device) for n in (num_z, bev_w, bev_h))
    xg = xs[None, :].expand(bev_h, bev_w).reshape(-1)
    yg = ys[:, None].expand(bev_h, bev_w).reshape(-1)
    x0, y0, z0, x1, y1, z1 = pc_range
    px = x0 + xg * (x1 - x0)
    py = y0 + yg * (y1 - y0)
    pz = z0 + zs[:, None] * (z1 - z0)
    n = bev_h * bev_w
    return torch.stack([px[None].expand(num_z, n), py[None].expand(num_z, n),
                        pz.expand(num_z, n)], -1)


def project_points_to_cams(points: torch.Tensor, lidar2img: torch.Tensor,
                           img_h: int, img_w: int):
    """points (D, nq, 3); lidar2img (B, cams, 4, 4). Returns the points in
    each camera's normalised image coordinates (cams, B, nq, D, 2) and
    ``bev_mask`` (cams, B, nq, D): in front of the camera and inside its
    image."""
    d, nq, _ = points.shape
    hom = torch.cat([points, points.new_ones(d, nq, 1)], -1)
    l2i = at_least_f32(lidar2img)
    proj = torch.einsum("bcij,dnj->bcdni", l2i, hom.to(l2i.dtype))
    eps = 1e-5
    z = proj[..., 2]
    xy = proj[..., :2] / torch.clamp(z[..., None], min=eps)
    xy = xy / _constant((float(img_w), float(img_h)), xy.device)
    inside = ((xy[..., 0] > 0.0) & (xy[..., 0] < 1.0)
              & (xy[..., 1] > 0.0) & (xy[..., 1] < 1.0))
    mask = (z > eps) & inside
    return xy.permute(1, 0, 3, 2, 4), mask.permute(1, 0, 3, 2)


class FFN(nn.Module):
    """x + Linear(ReLU(Linear(x))), mmcv's ``FFN`` names."""

    def __init__(self, embed_dims: int = 256, feedforward: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Dense(embed_dims, feedforward, dtype=dtype),
                          nn.ReLU()),
            Dense(feedforward, embed_dims, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layers(x)


def _run(module, remat: bool, *args):
    """``module(*args)``, recomputed in the backward pass where ``remat``
    asks for it and a gradient is being taken."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class _EncoderLayer(nn.Module):
    def __init__(self, embed_dims, num_cams, num_levels, dtype):
        super().__init__()
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(embed_dims, dtype=dtype),
            SpatialCrossAttention(embed_dims, num_cams, num_levels,
                                  dtype=dtype)])
        self.ffns = nn.ModuleList([FFN(embed_dims, 512, dtype)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims, dtype=dtype)
                                    for _ in range(3)])


class BEVFormerEncoder(nn.Module):
    """The stack of BEVFormer layers that builds the BEV feature map."""

    def __init__(self, bev_h: int = 200, bev_w: int = 200,
                 embed_dims: int = 256, num_layers: int = 6,
                 num_cams: int = 6, num_levels: int = 4,
                 num_points_in_pillar: int = 4,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.num_points_in_pillar = num_points_in_pillar
        self.pc_range = tuple(pc_range)
        self.remat = remat
        self.layers = nn.ModuleList([
            _EncoderLayer(embed_dims, num_cams, num_levels, dtype)
            for _ in range(num_layers)])

    def forward(self, bev_queries, value, lidar2img, img_hw, spatial_shapes,
                prev_bev=None, bev_pos=None):
        """bev_queries (B, bev_h bev_w, C); value (cams, B, keys, C);
        lidar2img (B, cams, 4, 4). Returns the BEV (B, bev_h bev_w, C)."""
        b = bev_queries.shape[0]
        nq = self.bev_h * self.bev_w
        dev = bev_queries.device
        pillar = bev_pillar_points(self.bev_h, self.bev_w,
                                   self.num_points_in_pillar, self.pc_range,
                                   dev)
        ref_cam, bev_mask = project_points_to_cams(pillar, lidar2img,
                                                   img_hw[0], img_hw[1])
        xg = _centres(self.bev_w, dev)[None, :].expand(self.bev_h, self.bev_w)
        yg = _centres(self.bev_h, dev)[:, None].expand(self.bev_h, self.bev_w)
        ref_2d = torch.stack([xg, yg], -1).reshape(1, nq, 1, 2).expand(
            b, nq, 1, 2)
        shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        bev_shape = ((self.bev_h, self.bev_w),)
        bev = bev_queries
        for layer in self.layers:
            # Each sublayer's arguments are bound now: a backward pass that
            # recomputes it runs after the loop has moved on.
            tsa, sca = layer.attentions
            bev = _run(lambda q, p, pos, m=tsa: m(q, p, ref_2d, bev_shape,
                                                  pos),
                       self.remat, bev, prev_bev, bev_pos)
            bev = layer.norms[0](bev)
            bev = _run(lambda q, v, pos, m=sca: m(q, v, ref_cam, bev_mask,
                                                  shapes, pos),
                       self.remat, bev, value, bev_pos)
            bev = layer.norms[1](bev)
            bev = _run(layer.ffns[0], self.remat, bev)
            bev = layer.norms[2](bev)
        return bev


class _SelfAttention(nn.Module):
    """mmcv's ``MultiheadAttention`` wrapper: the attention as ``attn``."""

    def __init__(self, embed_dims, heads, dtype):
        super().__init__()
        self.attn = MultiheadAttention(embed_dims, heads, dtype)


class _DecoderLayer(nn.Module):
    def __init__(self, embed_dims, heads, dtype):
        super().__init__()
        self.attentions = nn.ModuleList([
            _SelfAttention(embed_dims, heads, dtype),
            CustomMSDeformableAttention(embed_dims, dtype=dtype)])
        self.ffns = nn.ModuleList([FFN(embed_dims, 512, dtype)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims, dtype=dtype)
                                    for _ in range(3)])


class DetectionTransformerDecoder(nn.Module):
    """DETR decoder over the BEV map with iterative refinement of the
    reference points. Returns the per-layer query states (L, B, nq, C) and
    reference points (L, B, nq, 3)."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 6,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList([
            _DecoderLayer(embed_dims, num_heads, dtype)
            for _ in range(num_layers)])

    def forward(self, query, bev, reference_points, bev_hw, query_pos,
                reg_branches=None):
        """query (B, nq, C); bev (B, bev_h bev_w, C); reference_points
        (B, nq, 3) in sigmoid space; ``reg_branches(q, layer)`` the box
        regression of a layer's output."""
        shape = ((int(bev_hw[0]), int(bev_hw[1])),)
        states, refs = [], []
        ref = reference_points
        for li, layer in enumerate(self.layers):
            q = query + (query_pos if query_pos is not None else 0.0)
            # The value is the query before its positional embedding.
            sa = layer.attentions[0].attn(q, q, query)
            query = layer.norms[0](query + sa)
            query = _run(lambda x, r, pos, m=layer.attentions[1]: m(
                x, bev, r, shape, pos), self.remat, query, ref[..., :2],
                query_pos)
            query = layer.norms[1](query)
            query = layer.ffns[0](query)
            query = layer.norms[2](query)
            if reg_branches is not None:
                delta = reg_branches(query, li)
                new_xy = torch.sigmoid(delta[..., :2]
                                       + inverse_sigmoid(ref[..., :2]))
                new_z = torch.sigmoid(delta[..., 4:5]
                                      + inverse_sigmoid(ref[..., 2:3]))
                ref = torch.cat([new_xy, new_z], -1).detach()
            states.append(query)
            refs.append(ref)
        return torch.stack(states), torch.stack(refs)


def shift_prev_bev(prev_bev: torch.Tensor, bev_h: int, bev_w: int,
                   delta_xy: torch.Tensor,
                   rotation_deg: torch.Tensor | None = None) -> torch.Tensor:
    """Translate the previous BEV (B, bev_h bev_w, C) by ``delta_xy`` (B, 2)
    grid fractions, after rotating it by ``rotation_deg`` (B,) about the
    grid centre: one K5 resample of the (B, C, bev_h, bev_w) plane."""
    b, _, c = prev_bev.shape
    dev = prev_bev.device
    gx = torch.arange(bev_w, dtype=torch.float32, device=dev)[None, :].expand(
        bev_h, bev_w)
    gy = torch.arange(bev_h, dtype=torch.float32, device=dev)[:, None].expand(
        bev_h, bev_w)
    x, y = gx[None].expand(b, bev_h, bev_w), gy[None].expand(b, bev_h, bev_w)
    if rotation_deg is not None:
        theta = (at_least_f32(rotation_deg) * (math.pi / 180.0)).reshape(
            b, 1, 1)
        cx, cy = (bev_w - 1) / 2.0, (bev_h - 1) / 2.0
        xc, yc = x - cx, y - cy
        x = torch.cos(theta) * xc - torch.sin(theta) * yc + cx
        y = torch.sin(theta) * xc + torch.cos(theta) * yc + cy
    shift = at_least_f32(delta_xy).reshape(b, 2, 1, 1) * _constant(
        (float(bev_w), float(bev_h)), dev).reshape(1, 2, 1, 1)
    coords = torch.stack([x, y], 1) + shift
    prev = at_least_f32(prev_bev).reshape(b, bev_h, bev_w, c).permute(
        0, 3, 1, 2)
    out = bilinear_sampler_zero_pad(prev, coords)
    return out.permute(0, 2, 3, 1).reshape(b, bev_h * bev_w, c)
