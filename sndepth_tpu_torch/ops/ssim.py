"""SSIM-based photometric dissimilarity (NCHW).

Counterpart of :mod:`sndepth_tpu.ops.ssim` and the reference DSSIM
(reference `utils/utils_edited.py:121-141`): 3x3 stride-1 average
pools zero-padded by 1 with divisor 9, C1 = 0.01^2, C2 = 0.03^2, and
``clip((1 - SSIM) / 2, 0, 1)`` with the gradient split 0.5/0.5 at a clip
tie (see :mod:`sndepth_tpu_torch.kernels.dssim`).

:func:`dssim` and :func:`image_similarity` go through the DSSIM kernel,
which dispatches by device: a CUDA tensor launches it or raises, a CPU
tensor takes its plain version. The ``*_reference`` functions are plain
PyTorch on every device.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.kernels.dssim import dssim_map, dssim_reference


def dssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel structural dissimilarity in [0, 1]; NCHW in, NCHW out."""
    return dssim_map(x.contiguous(), y.contiguous())


def image_similarity(alpha: float, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """alpha * DSSIM + (1 - alpha) * |x - y|, per pixel and channel."""
    return alpha * dssim(x, y) + (1.0 - alpha) * torch.abs(x - y)


def image_similarity_reference(alpha: float, x: torch.Tensor,
                               y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`image_similarity`."""
    return alpha * dssim_reference(x, y) + (1.0 - alpha) * torch.abs(x - y)
