"""Differentiable bilinear image warping, edge_zero mode (NCHW).

Counterpart of :func:`sndepth_tpu.ops.warp.bilinear_sampler` and
:func:`sndepth_tpu.ops.warp.flow_warp`: the GeoNet reference's hand-rolled
sampler (reference `utils/utils_edited.py:386-486`). The corner
indices are clamped to the image *before* the weights are formed:

  x0 = clip(floor(x), 0, W-1); x1 = clip(floor(x) + 1, 0, W-1)
  wt_x0 = x1 - x;              wt_x1 = x - x0

so a coordinate more than a pixel outside the image, or exactly on the last
row or column, samples 0. ``floor`` and ``clip`` carry no gradient, so the
coordinate derivative of ``x1 - x`` is -1 everywhere, as under JAX autodiff.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.ops.camera import meshgrid


def _corners(c: torch.Tensor, size: int):
    c0 = torch.floor(c)
    return c0.clamp(0.0, size - 1.0), (c0 + 1.0).clamp(0.0, size - 1.0)


def _index(c: torch.Tensor, size: int) -> torch.Tensor:
    # The second clamp keeps a NaN coordinate's index in range; its weight
    # is NaN, so the sample is NaN, as in the JAX gather.
    return c.long().clamp(0, size - 1)


def bilinear_sampler(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``imgs`` (B, C, Hs, Ws) at pixel ``coords`` (B, 2, Ht, Wt),
    channels (x, y) in source pixels. Returns (B, C, Ht, Wt)."""
    b, c, hs, ws = imgs.shape
    ht, wt = coords.shape[2], coords.shape[3]
    cx, cy = coords[:, 0], coords[:, 1]
    x0s, x1s = _corners(cx, ws)
    y0s, y1s = _corners(cy, hs)
    wt_x0 = x1s - cx
    wt_x1 = cx - x0s
    wt_y0 = y1s - cy
    wt_y1 = cy - y0s
    x0i, x1i = _index(x0s, ws), _index(x1s, ws)
    y0i, y1i = _index(y0s, hs), _index(y1s, hs)

    flat = imgs.reshape(b, c, hs * ws)

    def tap(yi, xi):
        idx = (yi * ws + xi).reshape(b, 1, ht * wt).expand(b, c, ht * wt)
        return torch.gather(flat, 2, idx).reshape(b, c, ht, wt)

    w00 = (wt_x0 * wt_y0)[:, None]
    w01 = (wt_x0 * wt_y1)[:, None]
    w10 = (wt_x1 * wt_y0)[:, None]
    w11 = (wt_x1 * wt_y1)[:, None]
    return (w00 * tap(y0i, x0i) + w01 * tap(y1i, x0i)
            + w10 * tap(y0i, x1i) + w11 * tap(y1i, x1i))


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """(1, 2, H, W) grid of target pixel coordinates, channels (x, y)."""
    return meshgrid(h, w, homogeneous=False, dtype=dtype, device=device)[None]


def flow_warp(src_img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``src_img`` (B, C, H, W) by per-pixel ``flow`` (B, 2, H, W):
    target grid + flow, sampled from the source."""
    h, w = src_img.shape[2], src_img.shape[3]
    grid = pixel_grid(h, w, flow.dtype, flow.device)
    return bilinear_sampler(src_img, grid + flow)
