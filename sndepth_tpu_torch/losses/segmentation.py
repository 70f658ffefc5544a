"""Segmentation losses.

Counterpart of ``sndepth_tpu/losses/segmentation.py``: the cross-entropy of
the motion train step (reference `train.py:20,30`) and its class-weighted
form with weights [0, 1, 1], which ignores the background class (reference
`utils/motion_split/loss_func.py:4-10`). As torch's
``CrossEntropyLoss(weight=w)``, the weighted mean is normalised by the
summed weights of the targets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights=None) -> torch.Tensor:
    """logits (..., C) float, channel-last; labels (...,) integer. In
    float32 (float64 logits stay float64): logsumexp minus the one-hot
    contraction, as the JAX function writes it."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    oh = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    per_pixel = torch.logsumexp(logits, -1) - (logits * oh).sum(-1)
    if class_weights is None:
        return per_pixel.mean()
    w = (oh * torch.as_tensor(class_weights, dtype=logits.dtype,
                              device=logits.device)).sum(-1)
    return (per_pixel * w).sum() / torch.clamp(w.sum(), min=1e-12)


def weighted_motion_ce(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Background-ignoring cross-entropy (weights [0, 1, 1])."""
    return cross_entropy(logits, labels, (0.0, 1.0, 1.0))
