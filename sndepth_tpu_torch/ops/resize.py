"""Bilinear resizes (NCHW).

:func:`resize_bilinear_align_corners` is the counterpart of
:func:`sndepth_tpu.ops.resize.resize_bilinear_align_corners`: the coordinate
map is ``src = dst * (in - 1) / (out - 1)``. The JAX package writes the
interpolation as two banded weight-matrix products for the TPU's matrix
unit; what it computes is ``F.interpolate(..., align_corners=True)``.

:func:`resize_bilinear_antialias` is ``jax.image.resize(..., "bilinear")``:
half-pixel centres and, along an axis it shrinks, the triangle filter
widened by the shrink factor (antialiasing), the weights of the taps inside
the image normalised to one; along an axis it grows, plain bilinear.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, C, out_h, out_w)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def resize_bilinear_antialias(x: torch.Tensor, out_h: int,
                              out_w: int) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, C, out_h, out_w), as ``jax.image.resize``
    "bilinear" resizes."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)
