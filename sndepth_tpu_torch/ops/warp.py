"""Differentiable bilinear image warping (NCHW), in two border modes.

Counterpart of :func:`sndepth_tpu.ops.warp.bilinear_sampler`,
:func:`sndepth_tpu.ops.warp.bilinear_sampler_zero_pad` and
:func:`sndepth_tpu.ops.warp.flow_warp`.

:func:`bilinear_sampler` is the GeoNet reference's hand-rolled sampler
(reference `utils/utils_edited.py:386-486`), mode ``edge_zero``: the corner
indices are clamped to the image *before* the weights are formed,

  x0 = clip(floor(x), 0, W-1); x1 = clip(floor(x) + 1, 0, W-1)
  wt_x0 = x1 - x;              wt_x1 = x - x0

so a coordinate more than a pixel outside the image, or exactly on the last
row or column, samples 0. ``floor`` and ``clip`` carry no gradient, so the
coordinate derivative of ``x1 - x`` is -1 everywhere, as under JAX autodiff.
:func:`bilinear_sampler_zero_pad` is standard zero-padded sampling (mode
``zero_pad``): exact at integer borders.

The public samplers go through the gather kernel of
:mod:`sndepth_tpu_torch.kernels.warp`, which dispatches by device: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the kernel's plain
version. The ``*_reference`` functions are plain PyTorch on every device,
differentiable by autograd.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.kernels.warp import bilinear_sample, sampler_reference
from sndepth_tpu_torch.ops.camera import meshgrid


def bilinear_sampler_reference(imgs: torch.Tensor,
                               coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``edge_zero`` sampler."""
    return sampler_reference(imgs, coords, "edge_zero")


def bilinear_sampler_zero_pad_reference(imgs: torch.Tensor,
                                        coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``zero_pad`` sampler."""
    return sampler_reference(imgs, coords, "zero_pad")


def bilinear_sampler(imgs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``imgs`` (B, C, Hs, Ws) at pixel ``coords`` (B, 2, Ht, Wt),
    channels (x, y) in source pixels, ``edge_zero`` mode. Returns
    (B, C, Ht, Wt)."""
    return bilinear_sample(imgs.contiguous(), coords.contiguous(),
                           "edge_zero")


def bilinear_sampler_zero_pad(imgs: torch.Tensor,
                              coords: torch.Tensor) -> torch.Tensor:
    """As :func:`bilinear_sampler` in ``zero_pad`` mode: sampling at the
    integer coordinate W-1 returns the border pixel with weight 1. A float64
    evaluation on the CPU takes the plain version (the kernel takes
    float32)."""
    if imgs.dtype == torch.float64 and imgs.device.type == "cpu":
        return bilinear_sampler_zero_pad_reference(imgs, coords)
    return bilinear_sample(imgs.contiguous(), coords.contiguous(), "zero_pad")


def pixel_grid(h: int, w: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """(1, 2, H, W) grid of target pixel coordinates, channels (x, y)."""
    return meshgrid(h, w, homogeneous=False, dtype=dtype, device=device)[None]


def _with_grid(flow: torch.Tensor) -> torch.Tensor:
    h, w = flow.shape[2], flow.shape[3]
    return pixel_grid(h, w, flow.dtype, flow.device) + flow


def flow_warp(src_img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``src_img`` (B, C, H, W) by per-pixel ``flow`` (B, 2, H, W):
    target grid + flow, sampled from the source."""
    return bilinear_sampler(src_img, _with_grid(flow))


def flow_warp_reference(src_img: torch.Tensor,
                        flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`flow_warp`."""
    return bilinear_sampler_reference(src_img, _with_grid(flow))
