"""UniAD functional utilities: box codecs, the 2-D positional embedding, the
trajectory activation and GridMask.

Counterpart of ``sndepth_tpu/utils/uniad.py`` (reference
`utils/utils_uniad/`):

* :func:`normalize_bbox` / :func:`denormalize_bbox`: the 9-dim box [cx, cy,
  cz, w, l, h, rot(, vx, vy)] and the 10-dim network space [cx, cy, log w,
  log l, cz, log h, sin r, cos r, vx, vy];
* :func:`pos2posemb2d`: the sine / cosine embedding of normalised 2-D
  positions;
* :func:`bivariate_gaussian_activation`;
* :func:`grid_mask`: grid dropout on NCHW images. Its draws are arguments,
  so a caller can hand another side's draws across;
* :func:`surround_lidar2img`: a nuScenes-like six-camera rig.
"""

from __future__ import annotations

import math

import torch


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    cx, cy, cz = bboxes[..., 0:1], bboxes[..., 1:2], bboxes[..., 2:3]
    w, l, h = bboxes[..., 3:4], bboxes[..., 4:5], bboxes[..., 5:6]
    rot = bboxes[..., 6:7]
    parts = [cx, cy, torch.log(w), torch.log(l), cz, torch.log(h),
             torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, -1)


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    cx, cy = normalized[..., 0:1], normalized[..., 1:2]
    w, l = torch.exp(normalized[..., 2:3]), torch.exp(normalized[..., 3:4])
    cz, h = normalized[..., 4:5], torch.exp(normalized[..., 5:6])
    rot = torch.atan2(normalized[..., 6:7], normalized[..., 7:8])
    parts = [cx, cy, cz, w, l, h, rot]
    if normalized.shape[-1] > 8:
        parts += [normalized[..., 8:9], normalized[..., 9:10]]
    return torch.cat(parts, -1)


def pos2posemb2d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """(..., 2) normalised positions -> (..., 2 num_pos_feats): the y
    embedding, then the x one, sine and cosine interleaved."""
    pos = pos * (2.0 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pos.device)
    dim_t = temperature ** (2.0 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    px = pos[..., 0:1] / dim_t
    py = pos[..., 1:2] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()],
                     -1).flatten(-2)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()],
                     -1).flatten(-2)
    return torch.cat([py, px], -1)


def bivariate_gaussian_activation(ip: torch.Tensor) -> torch.Tensor:
    """mu passes, sigma through exp, rho through tanh."""
    if ip.shape[-1] <= 2:
        return ip
    return torch.cat([ip[..., 0:1], ip[..., 1:2], ip[..., 2:3].exp(),
                      ip[..., 3:4].exp(), ip[..., 4:5].tanh()], -1)


def grid_mask(images: torch.Tensor, d: int, off_x: int, off_y: int,
              apply: bool, ratio: float = 0.5) -> torch.Tensor:
    """Zero a regular grid of square cells of pitch ``d`` (``int(d ratio)``
    rows and columns of each kept), offset by ``off_x``, ``off_y``, on
    images (B, C, H, W) where ``apply``."""
    if not apply:
        return images
    h, w = images.shape[-2:]
    keep = int(d * ratio)
    ys = (torch.arange(h, device=images.device) + off_y) % d
    xs = (torch.arange(w, device=images.device) + off_x) % d
    mask = ((ys[:, None] >= keep) | (xs[None, :] >= keep)).to(images.dtype)
    return images * mask


# The nuScenes surround rig: six cameras at these yaws (degrees,
# counter-clockwise from the lidar's forward x axis), focal length 1266
# pixels at 1600x900-class images, ~1.5 m above the lidar's origin.
SURROUND_YAWS = (0.0, -55.0, 55.0, -110.0, 110.0, 180.0)
SURROUND_FOCAL_PER_WIDTH = 1266.0 / 1600.0


def surround_lidar2img(h: int, w: int, yaws=SURROUND_YAWS,
                       height: float = 1.5) -> torch.Tensor:
    """(1, cams, 4, 4) ``lidar2img`` of pinhole cameras at the lidar's
    origin raised by ``height``, looking out horizontally at ``yaws``, with
    the focal length ``SURROUND_FOCAL_PER_WIDTH * w`` at the image centre.
    Lidar axes: x forward, y left, z up; camera axes: x right, y down, z
    forward."""
    f = SURROUND_FOCAL_PER_WIDTH * w
    k = torch.tensor([[f, 0.0, w / 2.0, 0.0], [0.0, f, h / 2.0, 0.0],
                      [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                     dtype=torch.float64)
    mats = []
    for yaw in yaws:
        a = math.radians(yaw)
        rot = torch.tensor([[math.sin(a), -math.cos(a), 0.0],
                            [0.0, 0.0, -1.0],
                            [math.cos(a), math.sin(a), 0.0]],
                           dtype=torch.float64)
        ext = torch.eye(4, dtype=torch.float64)
        ext[:3, :3] = rot
        ext[:3, 3] = -rot @ torch.tensor([0.0, 0.0, height],
                                         dtype=torch.float64)
        mats.append(k @ ext)
    return torch.stack(mats)[None].float()
