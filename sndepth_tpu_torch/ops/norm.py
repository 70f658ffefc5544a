"""GroupNorm and BatchNorm with the JAX package's semantics (NCHW).

Counterpart of ``sndepth_tpu/ops/norm.py``: what :class:`BlockedGroupNorm`
and :class:`BatchNorm` compute, not their TPU layout (the blocked
statistics, the lane fold of ``_bn_fold_factor``). Statistics and the
normalisation run in float32 and the result is cast to ``dtype`` (the
input's type when ``None``), as flax does. The epsilons are flax's unless a
caller says otherwise: 1e-6 for GroupNorm (torch's default is 1e-5) and
1e-5 for BatchNorm; the EfficientNet encoder's BatchNorms take 1e-3.
BatchNorm runs on its running statistics (inference); training the nets
that hold it comes with NNET training.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with flax's epsilon, float32 statistics and the
    output in ``dtype``."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 dtype: torch.dtype | None = None):
        super().__init__(num_groups, num_channels, eps=eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(self.out_dtype or x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` on its running statistics, float32 inside and the
    output in ``dtype``; flax's epsilon unless given."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__(num_features, eps=eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm2d here runs on its running statistics only: "
                "call .eval() (training comes with NNET training)")
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(self.out_dtype or x.dtype)
