"""Image pyramids and finite-difference gradients (NCHW).

Counterpart of :mod:`sndepth_tpu.ops.pyramid`: 2x2 mean pooling per level
(the reference's 'area' resize at power-of-two ratios) and forward
differences ``g[i] = x[i] - x[i+1]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean-pool an NCHW image. Odd H or W drop their last row or
    column, as the JAX version's VALID ``reduce_window`` does."""
    return F.avg_pool2d(img, 2, 2)


def scale_pyramid(img: torch.Tensor, num_scales: int) -> list[torch.Tensor]:
    """List of ``num_scales`` NCHW images, each 2x smaller than the last."""
    pyramid = [img]
    for _ in range(num_scales - 1):
        pyramid.append(downsample2x(pyramid[-1]))
    return pyramid


def gradient_x(img: torch.Tensor) -> torch.Tensor:
    """Forward difference along W of an NCHW tensor: img[j] - img[j+1]."""
    return img[..., :, :-1] - img[..., :, 1:]


def gradient_y(img: torch.Tensor) -> torch.Tensor:
    """Forward difference along H of an NCHW tensor: img[i] - img[i+1]."""
    return img[..., :-1, :] - img[..., 1:, :]
