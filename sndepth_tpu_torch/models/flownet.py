"""FlowNet: residual optical-flow encoder-decoder (NCHW).

Counterpart of :class:`sndepth_tpu.models.flownet.FlowNet` on its default
path, with the reference's module names (reference
`models/FlowNet.py:41-135`) so that a reference state_dict loads as it is:
the encoder and decoder of :class:`~sndepth_tpu_torch.models.dispnet.
EncoderDecoder` (``conv{i}.0/.2``, ``upconv{i}.0``, ``iconv{i}.0``) and the
four 1x1 flow heads ``flow4..flow1``. A head runs in float32 on a float32
cast of its input, whatever ``dtype`` the convolutions run in, and is
scaled by ``flow_scale_factor``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.dispnet import EncoderDecoder


class FlowNet(EncoderDecoder):
    """Input (B, C_in, H, W) of channel-stacked views, warps, flows and
    errors; returns (flow1, flow2, flow3, flow4), each (B, 2, H/2^s, W/2^s)
    float32, finest first."""

    def __init__(self, in_channels: int = 12, flow_scale_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, 2, dtype=dtype)
        self.flow_scale_factor = flow_scale_factor
        for t in (4, 3, 2, 1):
            setattr(self, f"flow{t}", nn.Conv2d(self.dec_planes[7 - t], 2, 1))

    def _head(self, t: int, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, f"flow{t}")
        return self.flow_scale_factor * F.conv2d(x.float(), layer.weight,
                                                 layer.bias)

    def forward(self, x: torch.Tensor):
        return self._decode(x, self._head)
