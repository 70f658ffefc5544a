"""Inference pipeline stages.

Counterpart of ``sndepth_tpu/pipelines.py``. Ported so far:
:class:`RAFT3DStage` (scene flow from two frames, their depths and the
intrinsics). A stage builds its model once, on an explicit device, and runs
it without gradients; everything between its input and its output stays on
that device.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.models import raft3d
from sndepth_tpu_torch.ops import se3


class RAFT3DStage:
    """``stage(img1, img2, depth1, depth2, intrinsics)`` -> the SE3 field
    (B, H, W, 7) and its logarithm (B, H, W, 6) = [tau, phi].

    Images (B, 3, H, W) in [0, 1], depths (B, H, W), intrinsics (B, 4) =
    [fx fy cx cy], H and W multiples of 8. ``dtype`` covers the encoders
    and the GRU; correlation, Gauss-Newton and SE3 math stay float32.
    Without a ``state_dict`` the weights are random, drawn from ``seed``."""

    def __init__(self, state_dict: dict | None = None, iters: int = 16,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        self.device = torch.device(device)
        self.iters = iters
        self.model = raft3d.RAFT3D(dtype=dtype)
        if state_dict is None:
            raft3d.init_weights(self.model,
                                torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, img1, img2, depth1, depth2, intrinsics):
        Ts = self.model(*(t.to(self.device) for t in
                          (img1, img2, depth1, depth2, intrinsics)),
                        iters=self.iters)
        return Ts, se3.log(Ts)
