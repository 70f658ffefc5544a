"""Inference pipeline stages.

Counterpart of ``sndepth_tpu/pipelines.py``. Ported so far:
:class:`GeoNetStage` (disparity, depth and poses from a 3-view batch),
:class:`NNETStage` (normals and refined depth), :class:`MotionStage` (the
motion class map from an image and a flow image), :class:`RAFT3DStage`
(scene flow from two frames, their depths and the intrinsics),
:class:`Raft2DFlowStage` (optical flow from two frames),
:class:`VAEStage` (the RGBD latent posterior) and :class:`TrackStage`
(UniAD tracking, DINO-style features and the pose denoiser). A stage
builds its model once, on an explicit device, and runs it without
gradients; everything between its input and its output stays on that
device. Images are NCHW, as everywhere in the port; per-pixel outputs keep
the JAX stages' channel-last layout.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.core.config import GeoNetConfig, apply_precision
from sndepth_tpu_torch.models import motionseg
from sndepth_tpu_torch.models import nnet as nnet_lib
from sndepth_tpu_torch.models import raft2d, raft3d
from sndepth_tpu_torch.ops import se3
from sndepth_tpu_torch.ops.edges import edge_model_inputs
from sndepth_tpu_torch.train import geonet as geonet_lib
from sndepth_tpu_torch.train import motion as motion_lib


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


class MotionStage:
    """``stage(image01, flow_rgb)`` -> the argmax class map (B, H, W),
    int64: MotionFusionNet in float32 on its running statistics, as the JAX
    stage runs it (`predict.py:74-85`).

    ``image01`` and ``flow_rgb`` (B, 3, H, W) in [0, 1], H and W multiples
    of 16. Without a ``state_dict`` (the reference's key names) the weights
    are random, drawn from seed 0."""

    def __init__(self, state_dict: dict | None = None, device="cuda"):
        self.device = torch.device(device)
        self.model = motionseg.MotionFusionNet()
        if state_dict is None:
            motionseg.init_weights(self.model,
                                   torch.Generator().manual_seed(0))
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    def __call__(self, image01: torch.Tensor,
                 flow_rgb: torch.Tensor) -> torch.Tensor:
        image01 = image01.to(self.device)
        batch = {"image": image01.permute(0, 2, 3, 1),
                 "flow": flow_rgb.to(self.device).permute(0, 2, 3, 1),
                 "label": torch.zeros(image01.shape[0], *image01.shape[2:],
                                      dtype=torch.long, device=self.device)}
        return motion_lib.eval_step(self.model, batch)["pred"]


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


class Raft2DFlowStage:
    """``stage(img1, img2)`` -> the optical flow (B, H, W, 2) from ``img1``
    to ``img2``, the flow input of the motion segmentation
    (`predict.py:61`'s torchvision RAFT-Large).

    ``arch="large"`` is :class:`~sndepth_tpu_torch.models.raft2d.
    RAFT2DLarge`, whose ``state_dict`` a torchvision ``raft_large`` file
    gives (:func:`~sndepth_tpu_torch.utils.weights.raft2d_large_checkpoint`);
    ``arch="native"`` the lighter :class:`~sndepth_tpu_torch.models.raft2d.
    RAFT2D`. Images (B, 3, H, W), H and W multiples of 8, as the caller
    scales them. Float32; without a ``state_dict`` the weights are random,
    drawn from seed 0."""

    def __init__(self, state_dict: dict | None = None, iters: int = 12,
                 arch: str = "native", device="cuda"):
        if arch not in ("native", "large"):
            raise ValueError(f"unknown RAFT2D arch {arch!r}")
        self.device = torch.device(device)
        self.iters = iters
        self.model = raft2d.RAFT2DLarge() if arch == "large" else raft2d.RAFT2D()
        if state_dict is None:
            raft3d.init_weights(self.model, torch.Generator().manual_seed(0))
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return self.model(img1.to(self.device), img2.to(self.device),
                          iters=self.iters)


class VAEStage:
    """``stage(rgb01, depth)`` -> the posterior's mean and variance, each
    (B, H/8, W/8, 4), channel-last as the JAX stage returns them: the
    reference's RGBD autoencoder (:func:`~sndepth_tpu_torch.models.vae.
    get_autoencoder`, float32) encoding ``rgb01`` (B, 3, H, W) in [0, 1]
    with ``depth`` (B, H, W) as the fourth channel. Without a
    ``state_dict`` (the Stable-Diffusion names) the weights are random,
    drawn from seed 0."""

    def __init__(self, state_dict: dict | None = None, device="cuda"):
        from sndepth_tpu_torch.models.vae import get_autoencoder
        from sndepth_tpu_torch.ops.layers import init_weights
        self.device = torch.device(device)
        self.model = get_autoencoder()
        if state_dict is None:
            init_weights(self.model, torch.Generator().manual_seed(0))
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, rgb01: torch.Tensor, depth: torch.Tensor):
        rgbd = torch.cat([rgb01.to(self.device),
                          depth.to(self.device)[:, None]], 1)
        posterior = self.model.encode(rgbd)
        return (posterior.mean.permute(0, 2, 3, 1),
                posterior.var.permute(0, 2, 3, 1))


class TrackStage:
    """``stage(imgs, lidar2img, state, rgb_for_features)`` -> (the next
    :class:`~sndepth_tpu_torch.models.uniad_track.TrackState`, the frame's
    decoded detections, the denoised poses (B, 32, 9)): a small UniAD
    track model (32 queries, 64 dims, an 8x8 BEV, 2 + 2 layers, one
    bottleneck a stage), the multi-scale ViT extractor at depth
    ``vit_depth`` over scales 1 and 1/2, and ``get_opt_model()`` fed the
    extractor's embedding of ``rgb_for_features`` for 32 zero poses at t =
    0 (`predict_vae_uniad.py:57-68`).

    ``imgs`` (cams, B, 3, H, W); ``rgb_for_features`` (B, 3, H, W) in
    [0, 1]. Float32; without ``state_dicts`` ({"track", "features",
    "denoiser"}) the weights are random, drawn from seeds 0, 1 and 2."""

    def __init__(self, num_cams: int = 1, image_hw=(64, 64),
                 vit_depth: int = 4, state_dicts: dict | None = None,
                 device="cuda"):
        from sndepth_tpu_torch.models import uniad_track as ut
        from sndepth_tpu_torch.models import vit
        from sndepth_tpu_torch.models.denoiser import get_opt_model
        self.device = torch.device(device)
        self.image_hw = tuple(image_hw)
        self.track_model = ut.UniADTrack(
            num_query=32, num_classes=10, embed_dims=64, bev_h=8, bev_w=8,
            num_cams=num_cams, encoder_layers=2, decoder_layers=2,
            backbone_blocks=(1, 1, 1, 1), mem_len=2)
        self.feat_model = vit.MultiScaleImageFeatureExtractor((1.0, 0.5))
        self.feat_model.net = vit.ViT(depth=vit_depth)
        self.denoiser = get_opt_model()
        models = {"track": self.track_model, "features": self.feat_model,
                  "denoiser": self.denoiser}
        for seed, (name, model) in enumerate(models.items()):
            if state_dicts is None:
                init = (ut.init_weights if name == "track"
                        else vit.init_weights)
                init(model, torch.Generator().manual_seed(seed))
            else:
                model.load_state_dict(state_dicts[name])
            model.to(self.device).eval()

    def init_state(self):
        """Free slots with zero queries, as the JAX stage starts."""
        from sndepth_tpu_torch.models.track_runtime import empty_tracks
        from sndepth_tpu_torch.models.uniad_track import TrackState
        m, dev = self.track_model, self.device
        return TrackState(
            prev_bev=torch.zeros(1, m.bev_h * m.bev_w, m.embed_dims,
                                 device=dev),
            tracks=empty_tracks(m.num_query, m.embed_dims, m.num_classes,
                                m.mem_len, device=dev),
            next_obj_id=torch.zeros((), dtype=torch.int32, device=dev),
            timestamp=torch.zeros((), device=dev),
            has_prev=torch.zeros((), dtype=torch.bool, device=dev))

    @torch.no_grad()
    def __call__(self, imgs, lidar2img, state, rgb_for_features):
        state, results = self.track_model(imgs.to(self.device),
                                          lidar2img.to(self.device), state)
        feats = self.feat_model(rgb_for_features.to(self.device))
        b, n = feats.shape[0], 32
        z = feats[:, None, :].expand(b, n, feats.shape[-1])
        x = torch.zeros(b, n, 9, device=self.device)
        t = torch.zeros(b, device=self.device)
        return state, results, self.denoiser(x, t, z)
