"""PoseNet: 6-DoF relative camera pose regressor (NCHW).

Counterpart of :class:`sndepth_tpu.models.posenet.PoseNet`, with the
reference's module names (reference `models/PoseNet.py:17-52`):
seven stride-2 convs ``conv{i}.0`` over the channel-concatenated [target,
sources] frames, a 1x1 ``pred_poses`` conv run in float32, a spatial mean
and a 0.01 output scale.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.dispnet import conv

_PLAN = ((16, 7), (32, 5), (64, 3), (128, 3), (256, 3), (256, 3), (256, 3))


class PoseNet(nn.Module):
    """Input (B, 3*(1+num_source), H, W) in [-1, 1]; returns (B,
    num_source, 6) float32 pose vectors [tx ty tz rx ry rz]."""

    def __init__(self, num_source: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_source, self.dtype = num_source, dtype
        c_in = 3 * (1 + num_source)
        for i, (features, k) in enumerate(_PLAN):
            setattr(self, f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(c_in, features, k, 2, (k - 1) // 2), nn.ReLU()))
            c_in = features
        self.pred_poses = nn.Conv2d(c_in, 6 * num_source, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(len(_PLAN)):
            x = F.relu(conv(getattr(self, f"conv{i + 1}")[0], x, self.dtype))
        x = conv(self.pred_poses, x.float(), torch.float32)
        pose = x.mean((2, 3))
        return 0.01 * pose.reshape(pose.shape[0], self.num_source, 6)
