"""Self-supervised smoothness losses (NCHW).

Counterpart of :func:`sndepth_tpu.losses.photometric.smooth_loss` and
:func:`sndepth_tpu.losses.photometric.flow_smooth_loss`
(reference `models/loss_functions.py:8-32`), always through the
fused smoothness kernel (:mod:`sndepth_tpu_torch.kernels.smooth_loss`).
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.kernels.smooth_loss import smooth_loss_fused


def smooth_loss(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of depth (N, 1, H, W) under image
    (N, 3, H, W): depth gradients are down-weighted where the image has
    strong gradients. Differentiable in ``depth`` only."""
    return smooth_loss_fused(depth.float().contiguous(),
                             image.float().contiguous())


def flow_smooth_loss(flow: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Smoothness applied per flow channel and averaged: flow (N, 2, H, W),
    image (N, 3, H, W). Differentiable in ``flow`` only."""
    return (smooth_loss(flow[:, 0:1], image)
            + smooth_loss(flow[:, 1:2], image)) / 2.0
