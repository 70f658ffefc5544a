"""Inference pipeline stages.

Counterpart of ``sndepth_tpu/pipelines.py``. Ported so far:
:class:`GeoNetStage` (disparity, depth and poses from a 3-view batch),
:class:`NNETStage` (normals and refined depth) and :class:`RAFT3DStage`
(scene flow from two frames, their depths and the intrinsics). A stage
builds its model once, on an explicit device, and runs it without
gradients; everything between its input and its output stays on that
device. Images are NCHW, as everywhere in the port; per-pixel outputs keep
the JAX stages' channel-last layout.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.core.config import GeoNetConfig, apply_precision
from sndepth_tpu_torch.models import nnet as nnet_lib
from sndepth_tpu_torch.models import raft3d
from sndepth_tpu_torch.ops import se3
from sndepth_tpu_torch.ops.edges import edge_model_inputs
from sndepth_tpu_torch.train import geonet as geonet_lib


class GeoNetStage:
    """``stage(batch)`` -> {"disp": (B, h, w), "depth": (B, h, w), "poses":
    (B, ns, 6), "tgt_norm": (B, 3, H, W), "src_norm": (B, 3 ns, H, W)}: the
    finest disparity and depth of the target view, the poses, and the
    images scaled to [-1, 1].

    ``batch`` is a raw batch, numpy or torch, as the readers and the
    synthetic stream give it: uint8 NHWC ``tgt`` (B, H, W, 3) and ``src``
    (B, H, W, 3 ns), and ``intrinsics``. DispNetS and PoseNet run in
    ``config.compute_dtype``; without ``state_dicts`` ({"disp_net": ...,
    "pose_net": ...}, the checkpoint's keys) the weights are random, drawn
    from ``config.seed``."""

    def __init__(self, config: GeoNetConfig, state_dicts: dict | None = None,
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        apply_precision(config)
        self.disp_net, self.pose_net, _ = geonet_lib.build_models(
            config, self.device)
        if state_dicts is not None:
            self.disp_net.load_state_dict(state_dicts["disp_net"])
            self.pose_net.load_state_dict(state_dicts["pose_net"])
        self.disp_net.eval()
        self.pose_net.eval()

    @torch.no_grad()
    def __call__(self, batch: dict) -> dict:
        batch = geonet_lib.preprocess_batch(
            {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()})
        disparities, depths, poses = geonet_lib.geonet_forward(
            self.disp_net, self.pose_net, batch, self.config)
        return {"disp": disparities[0][:, 0, 0], "depth": depths[0][:, 0],
                "poses": poses, "tgt_norm": batch["tgt"],
                "src_norm": batch["src"]}


class NNETStage:
    """``stage(pre_depth, rgb)`` -> {"normals": (B, H, W, 3), "depth":
    (B, H, W, 1)} (`baseline.py:274`).

    ``rgb`` (B, 3, H, W) in [0, 1]; ``pre_depth`` (B, H, W) reaches NNET as
    its log2-depth argument as it is, as in the JAX stage (the fused
    pipeline hands it GeoNet's depth). The Canny edges are computed on the
    device. ``dtype`` bfloat16 (the default, as in JAX) runs the convolution
    stacks in bf16; the normal heads and the D2N/N2D solves stay float32.
    Without a ``state_dict`` the weights are random, drawn from seed 0;
    ``model`` serves an NNET built elsewhere (another encoder plan, or the
    decoder's ``BN`` architecture) instead of the full-width GN one."""

    def __init__(self, state_dict: dict | None = None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 model: nnet_lib.NNET | None = None):
        self.device = torch.device(device)
        if model is None:
            model = nnet_lib.NNET("GN", dtype)
            if state_dict is None:
                nnet_lib.init_weights(model, torch.Generator().manual_seed(0))
            else:
                model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, pre_depth: torch.Tensor, rgb: torch.Tensor) -> dict:
        rgb = rgb.to(self.device).permute(0, 2, 3, 1)
        model_in = nnet_lib.bgr_preprocess(rgb)
        edge_in = edge_model_inputs(model_in)
        norm, depth, _ = self.model(pre_depth.to(self.device), rgb, edge_in,
                                    edge_in[..., :1])
        return {"normals": norm, "depth": depth}


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
