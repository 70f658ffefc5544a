"""Multi-scale deformable attention and the modulated deformable convolution
(DCNv2), on the gather kernel K5.

Counterpart of ``sndepth_tpu/models/deformable.py`` (reference mmcv
``ms_deform_attn`` and ``ModulatedDeformConv2d``):

* :func:`ms_deformable_attention`: per level, the value as (B heads,
  head_dim, h, w) planes sampled by K5 (``zero_pad``) at ``loc * (w, h) -
  0.5`` laid out (B heads, 2, nq, P), weighted and summed over the P
  points, then over the levels in order (JAX's ``_msda_core``, natural
  (nq, P) layout). The value reaches the sampler in float32 (a float64
  evaluation, on the CPU, stays float64);
* :class:`MSDeformableAttention3D`, :class:`SpatialCrossAttention` (every
  camera attends for every query, masked by ``bev_mask`` and averaged over
  the cameras that see it), :class:`TemporalSelfAttention` (the stacked
  [prev, cur] BEV) and :class:`CustomMSDeformableAttention` (the decoder's);
* :class:`DeformConv2d`: a convolution predicts each tap's (dy, dx) and a
  sigmoid mask (flax ``SAME`` padding, its windows centred where flax puts
  them), K5 samples the input at the 9 deformed taps of every output pixel
  (targets (ho wo, 9)), and one matrix product contracts the taps and input
  channels with the (Cout, Cin, 3, 3) kernel.

Autograd runs the kernel's backward: K5b for the coordinates, K6 for the
value. The JAX package's TPU layouts (``SNDEPTH_MSDA_COORDS``) and its
query-chunked ``lax.map`` are memory devices of the TPU, exact per query:
here every query runs at once. Parameter names are the reference's
(``sampling_offsets``, ``attention_weights``, ``value_proj``,
``output_proj``; ``weight`` and ``conv_offset``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.ops.layers import Dense, at_least_f32
from sndepth_tpu_torch.ops.warp import bilinear_sampler_zero_pad


@functools.lru_cache(maxsize=256)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``values`` on ``device``, made once: a copy from
    the host in every call would wait for the card's queue."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _level_norm(spatial_shapes, like: torch.Tensor) -> torch.Tensor:
    """(L, 2) tensor of each level's (w, h)."""
    return _constant(tuple((float(w), float(h)) for h, w in spatial_shapes),
                     like.device)


def ms_deformable_attention(value: torch.Tensor,
                            spatial_shapes: Sequence[tuple],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, keys, heads, head_dim), the levels' keys concatenated;
    ``spatial_shapes`` the levels' (h, w); sampling_locations (B, nq, heads,
    L, P, 2) in [0, 1]; attention_weights (B, nq, heads, L, P). Returns
    (B, nq, heads head_dim), float32 (or float64)."""
    b, _, heads, dim = value.shape
    _, nq, _, _, p, _ = sampling_locations.shape
    wh = _level_norm(spatial_shapes, value)
    out = None
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w]                  # B, hw, H, D
        start += h * w
        v = at_least_f32(v.permute(0, 2, 3, 1).reshape(b * heads, dim, h, w))
        loc = at_least_f32(sampling_locations[:, :, :, lvl])  # B, nq, H, P, 2
        px = loc * wh[lvl] - 0.5
        px = px.permute(0, 2, 4, 1, 3).reshape(b * heads, 2, nq, p)
        sampled = bilinear_sampler_zero_pad(v, px)         # BH, D, nq, P
        wgt = at_least_f32(attention_weights[:, :, :, lvl])  # B, nq, H, P
        wgt = wgt.permute(0, 2, 1, 3).reshape(b * heads, 1, nq, p)
        term = (sampled * wgt).sum(-1)                     # BH, D, nq
        out = term if out is None else out + term
    return out.reshape(b, heads, dim, nq).permute(0, 3, 1, 2).reshape(
        b, nq, heads * dim)


def _offsets_and_weights(d_off: Dense, d_wgt: Dense, query: torch.Tensor,
                         h: int, L: int, P: int):
    """Sampling offsets (B, nq, h, L, P, 2) and the softmax over each
    head's L P points (B, nq, h, L, P), both float32 (or float64)."""
    b, nq = query.shape[:2]
    q32 = at_least_f32(query)
    offsets = d_off(q32).reshape(b, nq, h, L, P, 2)
    weights = torch.softmax(d_wgt(q32).reshape(b, nq, h, L * P), -1)
    return offsets, weights.reshape(b, nq, h, L, P)


class MSDeformableAttention3D(nn.Module):
    """Offsets and weights from the query; the P points spread over the D
    pillar reference points (P a multiple of D). No output projection: the
    outer :class:`SpatialCrossAttention` owns it."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h, self.L, self.P = num_heads, num_levels, num_points
        n = num_heads * num_levels * num_points
        self.sampling_offsets = Dense(embed_dims, 2 * n)
        self.attention_weights = Dense(embed_dims, n)
        self.value_proj = Dense(embed_dims, embed_dims, dtype=dtype)

    def forward(self, query, value, reference_points, spatial_shapes):
        """query (B, nq, C); value (B, keys, C); reference_points (B, nq,
        D, 2) normalised. Returns (B, nq, C)."""
        b, nq, c = query.shape
        h, L, P = self.h, self.L, self.P
        offsets, weights = _offsets_and_weights(
            self.sampling_offsets, self.attention_weights, query, h, L, P)
        v = self.value_proj(value).reshape(b, -1, h, c // h)
        d = reference_points.shape[2]
        ref = at_least_f32(reference_points[:, :, None, None, :, None, :])
        off = offsets.reshape(b, nq, h, L, d, P // d, 2)
        norm = _level_norm(spatial_shapes, query).reshape(1, 1, 1, L, 1, 1, 2)
        loc = (ref + off / norm).reshape(b, nq, h, L, P, 2)
        return ms_deformable_attention(v, spatial_shapes, loc, weights)


class SpatialCrossAttention(nn.Module):
    """Every camera samples its multi-level features for every BEV query;
    contributions are masked by ``bev_mask`` and averaged over the cameras
    that see the query; then ``output_proj`` and the residual."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 num_levels: int = 4, num_points: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_cams = num_cams
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims, num_levels=num_levels, num_points=num_points,
            dtype=dtype)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype)

    def forward(self, query, value, reference_points_cam, bev_mask,
                spatial_shapes, query_pos=None):
        """query (B, nq, C); value (cams, B, keys, C);
        reference_points_cam (cams, B, nq, D, 2); bev_mask (cams, B, nq, D)
        bool."""
        residual = query
        if query_pos is not None:
            query = query + query_pos
        b, nq, c = query.shape
        cams = self.num_cams
        flat_q = query[None].expand(cams, b, nq, c).reshape(cams * b, nq, c)
        out = self.deformable_attention(
            flat_q, value.reshape(cams * b, -1, c),
            reference_points_cam.reshape(cams * b, nq, -1, 2),
            spatial_shapes).reshape(cams, b, nq, c)
        seen = bev_mask.any(-1)                             # cams, B, nq
        out = torch.where(seen[..., None], out, torch.zeros_like(out))
        count = torch.clamp(seen.sum(0).float(), min=1.0)[..., None]
        slots = out.sum(0) / count
        return self.output_proj(slots) + residual


class TemporalSelfAttention(nn.Module):
    """Deformable attention of the current BEV over the stacked [prev, cur]
    value; the two branches' outputs are averaged."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h, self.L, self.P = num_heads, num_levels, num_points
        n = num_heads * num_levels * num_points
        self.sampling_offsets = Dense(2 * embed_dims, 2 * n)
        self.attention_weights = Dense(2 * embed_dims, n)
        self.value_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype)

    def forward(self, query, prev_value, reference_points, spatial_shapes,
                query_pos=None):
        """query, the current BEV (B, nq, C); prev_value (B, nq, C) or None
        (then the current BEV); reference_points (B, nq, 1, 2)."""
        residual = query
        if query_pos is not None:
            query = query + query_pos
        b, nq, c = query.shape
        h, L, P = self.h, self.L, self.P
        if prev_value is None:
            prev_value = residual
        values = torch.cat([prev_value, residual], 0)
        q2 = torch.cat([torch.cat([prev_value, query], -1),
                        torch.cat([residual, query], -1)], 0)
        offsets, weights = _offsets_and_weights(
            self.sampling_offsets, self.attention_weights, q2, h, L, P)
        v = self.value_proj(values).reshape(2 * b, -1, h, c // h)
        ref = at_least_f32(reference_points.repeat(2, 1, 1, 1))
        norm = _level_norm(spatial_shapes, query).reshape(1, 1, 1, L, 1, 2)
        loc = ref[:, :, None, None, :, :] + offsets / norm
        out = ms_deformable_attention(v, spatial_shapes, loc, weights)
        out = 0.5 * (out[:b] + out[b:])
        return self.output_proj(out) + residual


class CustomMSDeformableAttention(nn.Module):
    """The decoder's deformable attention over the BEV, with its output
    projection and the residual."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h, self.L, self.P = num_heads, num_levels, num_points
        n = num_heads * num_levels * num_points
        self.sampling_offsets = Dense(embed_dims, 2 * n)
        self.attention_weights = Dense(embed_dims, n)
        self.value_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype)

    def forward(self, query, value, reference_points, spatial_shapes,
                query_pos=None):
        """query (B, nq, C); value (B, keys, C); reference_points (B, nq,
        2) normalised."""
        residual = query
        if query_pos is not None:
            query = query + query_pos
        b, nq, c = query.shape
        h, L, P = self.h, self.L, self.P
        offsets, weights = _offsets_and_weights(
            self.sampling_offsets, self.attention_weights, query, h, L, P)
        v = self.value_proj(value).reshape(b, -1, h, c // h)
        norm = _level_norm(spatial_shapes, query).reshape(1, 1, 1, L, 1, 2)
        loc = (at_least_f32(reference_points[:, :, None, None, None, :])
               + offsets / norm)
        out = ms_deformable_attention(v, spatial_shapes, loc, weights)
        return self.output_proj(out) + residual


def same_padding(size: int, k: int, s: int) -> tuple[int, int]:
    """flax ``padding="SAME"``'s (low, high) padding of one side: the output
    is ceil(size / s), the excess split with the smaller half low."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class DeformConv2d(nn.Module):
    """Modulated deformable 3x3 convolution (DCNv2, mmcv's
    ``ModulatedDeformConv2dPack``): ``conv_offset`` predicts per output
    pixel 9 (dy, dx) pairs, interleaved, and 9 mask logits; taps sit at
    ``(i s + dy_k + off_y, j s + dx_k + off_x)``. NCHW in and out; the
    offsets, the samples and the product run in float32 (float64 in a float64
    evaluation), the output is cast to ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.stride, self.compute_dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel, kernel))
        nn.init.kaiming_normal_(self.weight, mode="fan_out")
        self.conv_offset = nn.Conv2d(in_channels, 3 * kernel * kernel, kernel,
                                     stride=stride)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, cin, h, w = x.shape
        k, s = self.k, self.stride
        kk = k * k
        x = at_least_f32(x)
        (th, bh), (tw, bw) = same_padding(h, k, s), same_padding(w, k, s)
        om = self.conv_offset(F.pad(x, (tw, bw, th, bh)))
        ho, wo = om.shape[2:]
        off_y = om[:, 0:2 * kk:2].permute(0, 2, 3, 1)      # b, ho, wo, kk
        off_x = om[:, 1:2 * kk:2].permute(0, 2, 3, 1)
        mask = torch.sigmoid(om[:, 2 * kk:])                # b, kk, ho, wo

        r = (k - 1) // 2
        d = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
        # Tap t sits at (t // k, t % k) of the window, row-major.
        gy, gx = d.repeat_interleave(k), d.repeat(k)
        cy = torch.arange(ho, dtype=torch.float32, device=x.device) * s
        cx = torch.arange(wo, dtype=torch.float32, device=x.device) * s
        pos_y = (cy[:, None, None] + gy) + off_y
        pos_x = (cx[None, :, None] + gx) + off_x
        coords = torch.stack([pos_x, pos_y], 1).reshape(b, 2, ho * wo, kk)
        sampled = bilinear_sampler_zero_pad(x, coords)      # b, cin, P, kk
        sampled = sampled * mask.flatten(2).transpose(1, 2)[:, None]
        cols = sampled.permute(0, 2, 1, 3).reshape(b, ho * wo, cin * kk)
        out = cols @ self.weight.reshape(self.weight.shape[0], -1).t()
        return out.transpose(1, 2).reshape(b, -1, ho, wo).to(
            self.compute_dtype)
