"""Dilated patch extraction (``F.unfold`` over the spatial axes).

Counterpart of :func:`sndepth_tpu.ops.patches.extract_patches` and
:func:`~sndepth_tpu.ops.patches.extract_patches_tap_last`, with their
channel-last layout in and out: the convex upsampling of RAFT3D applies the
first to SE3 tangents and flows, NNET's depth-normal solves the second to
normals and 3-D points, all channel-last throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_patches_tap_last(x: torch.Tensor, k: int,
                             dilation: int) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, C, k*k), zero-padded to the same size,
    stride 1. Tap order is row-major over the k x k window."""
    b, h, w, c = x.shape
    pad = (k - 1) * dilation // 2
    cols = F.unfold(x.permute(0, 3, 1, 2), k, dilation=dilation, padding=pad)
    return cols.reshape(b, c, k * k, h, w).permute(0, 3, 4, 1, 2)


def extract_patches(x: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, k*k, C), zero-padded to the same size,
    stride 1. Tap order is row-major over the k x k window."""
    b, h, w, c = x.shape
    pad = (k - 1) * dilation // 2
    cols = F.unfold(x.permute(0, 3, 1, 2), k, dilation=dilation, padding=pad)
    # unfold orders its rows (C, k, k).
    return cols.reshape(b, c, k * k, h, w).permute(0, 3, 4, 2, 1)
