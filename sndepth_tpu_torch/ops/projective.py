"""RAFT3D projective geometry (pinhole, intrinsics as [fx fy cx cy]).

Counterpart of ``sndepth_tpu/ops/projective.py``. Coordinates are
(x, y, inverse-depth); validity masks use MIN_DEPTH = 0.05.

Layouts are the JAX functions': points, coordinates and SE3 fields are
channel-last, ``(B, H, W, 3)``, ``(B, H, W, 2)`` and ``(B, H, W, 7)``; depth
maps are ``(B, H, W)``; intrinsics ``(B, 4)``. Only :func:`grid_sampler`
takes an image, and takes it NCHW as the rest of the port does.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.ops import se3
from sndepth_tpu_torch.ops.warp import bilinear_sampler_zero_pad

MIN_DEPTH = 0.05


def _intrinsics(intrinsics: torch.Tensor):
    """(B, 4) -> fx, fy, cx, cy, each (B, 1, 1)."""
    return intrinsics[:, None, None, :4].unbind(-1)


def pixel_axes(h: int, w: int, like: torch.Tensor):
    """Column and row index of every pixel, each (h, w), in the type and on
    the device of ``like``."""
    x = torch.arange(w, dtype=like.dtype, device=like.device).expand(h, w)
    y = torch.arange(h, dtype=like.dtype,
                     device=like.device)[:, None].expand(h, w)
    return x, y


def project(points: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """points: (B, H, W, 3) -> (x, y, 1/z) coords (B, H, W, 3)."""
    x, y, z = points.unbind(-1)
    fx, fy, cx, cy = _intrinsics(intrinsics)
    u = fx * (x / z) + cx
    v = fy * (y / z) + cy
    return torch.stack([u, v, 1.0 / z], dim=-1)


def inv_project(depths: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """depths: (B, H, W) -> 3-D points (B, H, W, 3)."""
    h, w = depths.shape[-2:]
    fx, fy, cx, cy = _intrinsics(intrinsics)
    x, y = pixel_axes(h, w, depths)
    X = depths * ((x - cx) / fx)
    Y = depths * ((y - cy) / fy)
    return torch.stack([X, Y, depths], dim=-1)


def projective_transform(transforms: torch.Tensor, depth: torch.Tensor,
                         intrinsics: torch.Tensor):
    """Project I1 points into I2 through the SE3 field.

    transforms: (B, H, W, 7); depth: (B, H, W); intrinsics: (B, 4).
    Returns ((B, H, W, 3) coords, (B, H, W) validity)."""
    x0 = inv_project(depth, intrinsics)
    x1 = se3.act(transforms, x0)
    coords = project(x1, intrinsics)
    valid = (x0[..., -1] > MIN_DEPTH) & (x1[..., -1] > MIN_DEPTH)
    return coords, valid.to(depth.dtype)


def induced_flow(transforms: torch.Tensor, depth: torch.Tensor,
                 intrinsics: torch.Tensor):
    """2-D (x, y, dzinv) and 3-D flow fields induced by the SE3 field, both
    (B, H, W, 3), and the (B, H, W) validity."""
    x0 = inv_project(depth, intrinsics)
    x1 = se3.act(transforms, x0)
    p0 = project(x0, intrinsics)
    p1 = project(x1, intrinsics)
    valid = (x0[..., -1] > MIN_DEPTH) & (x1[..., -1] > MIN_DEPTH)
    return p1 - p0, x1 - x0, valid.to(depth.dtype)


def backproject_flow3d(flow2d: torch.Tensor, depth0: torch.Tensor,
                       depth1: torch.Tensor,
                       intrinsics: torch.Tensor) -> torch.Tensor:
    """3-D flow from 2-D flow + two depth maps of a single image:
    flow2d (H, W, 2), depths (H, W), intrinsics (4,) -> (H, W, 3)."""
    h, w = flow2d.shape[0:2]
    fx, fy, cx, cy = intrinsics[:4].unbind(-1)
    x0, y0 = pixel_axes(h, w, depth0)
    x1 = x0 + flow2d[..., 0]
    y1 = y0 + flow2d[..., 1]
    X0 = depth0 * ((x0 - cx) / fx)
    Y0 = depth0 * ((y0 - cy) / fy)
    X1 = depth1 * ((x1 - cx) / fx)
    Y1 = depth1 * ((y1 - cy) / fy)
    return torch.stack([X1 - X0, Y1 - Y0, depth1 - depth0], dim=-1)


def grid_sampler(img: torch.Tensor, coords: torch.Tensor):
    """Bilinear sample img (B, C, H, W) at pixel coords (B, Ht, Wt, 2),
    channels (x, y), zero-padded, with an in-bounds validity mask: returns
    ((B, C, Ht, Wt), (B, Ht, Wt)). The sample goes through the gather kernel
    in ``zero_pad`` mode (see :mod:`sndepth_tpu_torch.ops.warp`)."""
    h, w = img.shape[2:]
    x, y = coords[..., 0], coords[..., 1]
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    sampled = bilinear_sampler_zero_pad(img, coords.permute(0, 3, 1, 2))
    return sampled, valid.to(img.dtype)


def depth_sampler(depths: torch.Tensor, coords: torch.Tensor):
    """Sample a depth map (B, H, W) at coords (B, Ht, Wt, 2) ->
    ((B, Ht, Wt), (B, Ht, Wt) validity)."""
    sampled, valid = grid_sampler(depths[:, None], coords)
    return sampled[:, 0], valid
