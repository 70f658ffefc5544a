"""GroupNorm and BatchNorm with the JAX package's semantics (NCHW).

Counterpart of ``sndepth_tpu/ops/norm.py``: what :class:`BlockedGroupNorm`
and :class:`BatchNorm` compute, not their TPU layout (the blocked
statistics, the lane fold of ``_bn_fold_factor``). Statistics and the
normalisation run in float32 and the result is cast to ``dtype`` (the
input's type when ``None``), as flax does. The epsilons are flax's unless a
caller says otherwise: 1e-6 for GroupNorm (torch's default is 1e-5) and
1e-5 for BatchNorm; the EfficientNet encoder's BatchNorms take 1e-3.
BatchNorm in training normalises with flax's batch statistics and moves its
running averages as flax does (:class:`BatchNorm2d`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with flax's epsilon, at least float32 statistics and
    the output in ``dtype``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 dtype: torch.dtype | None = None):
        super().__init__(num_groups, num_channels, eps=eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.to(torch.promote_types(x.dtype, torch.float32)),
                         self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(self.out_dtype or x.dtype)


# flax's BatchNorm momentum: the weight of the old running average.
MOMENTUM = 0.99


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's semantics, at least float32 inside and
    the output in ``dtype``; flax's epsilon unless given.

    In eval mode it normalises with its running statistics. In train mode
    it normalises with the batch's mean and its biased variance in flax's
    fast form, ``max(0, E[x^2] - E[x]^2)`` (not torch's two-pass variance),
    and moves the running averages to ``0.99 ra + 0.01 stat`` with that same
    biased variance (``F.batch_norm`` would feed the unbiased one to
    ``running_var``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__(num_features, eps=eps, momentum=1.0 - MOMENTUM)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # At least float32, as flax's statistics (float64 stays float64).
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.out_dtype or x.dtype)
        mean = xf.mean((0, 2, 3))
        var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
            self.running_var.mul_(MOMENTUM).add_((1 - MOMENTUM) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.out_dtype or x.dtype)
