"""SSIM-based photometric dissimilarity (NCHW).

Counterpart of :mod:`sndepth_tpu.ops.ssim` and the reference DSSIM
(reference `utils/utils_edited.py:121-141`): 3x3 stride-1 average
pools zero-padded by 1 with divisor 9, C1 = 0.01^2, C2 = 0.03^2, and
``clip((1 - SSIM) / 2, 0, 1)``.

The clip is ``minimum(maximum(s, 0), 1)``: torch's binary max/min split the
gradient 0.5/0.5 at a tie, as JAX's ``clip`` does, while ``torch.clamp``
passes the whole gradient. DSSIM hits exactly 0 wherever the two windows
are equal, so the tie rule shows in real gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean over an NCHW tensor, zero-padded, divisor 9."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def dssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel structural dissimilarity in [0, 1]; NCHW in, NCHW out."""
    mu_x = avg_pool3(x)
    mu_y = avg_pool3(y)
    sigma_x = avg_pool3(x * x) - mu_x * mu_x
    sigma_y = avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = avg_pool3(x * y) - mu_x * mu_y
    ssim_n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    s = (1.0 - ssim_n / ssim_d) * 0.5
    zero = s.new_zeros(())
    return torch.minimum(torch.maximum(s, zero), zero + 1.0)


def image_similarity(alpha: float, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """alpha * DSSIM + (1 - alpha) * |x - y|, per pixel and channel."""
    return alpha * dssim(x, y) + (1.0 - alpha) * torch.abs(x - y)
