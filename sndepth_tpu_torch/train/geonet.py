"""GeoNet stage-1 self-supervised depth+pose training step (PyTorch).

Counterpart of ``sndepth_tpu/train/geonet.py`` with ``train_flow=False``
(reference `models/baseline.py:746-1278`): DispNetS over the stacked
[target, sources] views, PoseNet over their channel concatenation, a
4-scale rigid-warp photometric loss through the fused pair kernel
(:mod:`sndepth_tpu_torch.kernels.photo_loss`), edge-aware smoothness
through the fused smoothness kernel, and Adam. Kernels are chosen by the
device the tensors live on: CUDA tensors launch them, CPU tensors take
their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from sndepth_tpu_torch.core.config import GeoNetConfig, apply_precision
from sndepth_tpu_torch.kernels.photo_loss import warp_photo_pair_loss
from sndepth_tpu_torch.losses.photometric import smooth_loss
from sndepth_tpu_torch.models.dispnet import DispNetS, init_weights
from sndepth_tpu_torch.models.posenet import PoseNet
from sndepth_tpu_torch.ops.camera import (compute_multi_scale_intrinsics,
                                          compute_rigid_flow)
from sndepth_tpu_torch.ops.pyramid import scale_pyramid
from sndepth_tpu_torch.ops.warp import pixel_grid

# As optax.apply_if_finite(max_consecutive_errors=100) in the JAX step: a
# non-finite step is skipped; the 101st consecutive one raises here, where
# optax would start applying the non-finite updates.
MAX_CONSECUTIVE_SKIPS = 100


def build_models(config: GeoNetConfig, device) -> tuple[DispNetS, PoseNet]:
    """DispNetS and PoseNet with weights drawn on the host from a generator
    seeded with ``config.seed``, then moved to ``device``: the same seed
    gives the same weights on every device."""
    gen = torch.Generator().manual_seed(config.seed)
    disp_net = DispNetS(dtype=config.compute_dtype)
    pose_net = PoseNet(num_source=config.num_source,
                       dtype=config.compute_dtype)
    init_weights(disp_net, gen)
    init_weights(pose_net, gen)
    return disp_net.to(device), pose_net.to(device)


def preprocess_batch(batch: dict) -> dict:
    """uint8 [0, 255] NHWC images -> float32 [-1, 1] NCHW; tgt (B, 3, H, W),
    src (B, 3*ns, H, W); intrinsics (B, 3, 3) float32."""
    def to_unit(x):
        x = x.float() * (1.0 / 255.0) * 2.0 - 1.0
        return x.permute(0, 3, 1, 2).contiguous()
    out = dict(batch)
    out["tgt"] = to_unit(batch["tgt"])
    out["src"] = to_unit(batch["src"])
    out["intrinsics"] = batch["intrinsics"].float()
    return out


def stack_views(batch: dict) -> torch.Tensor:
    """(B, V, 3, H, W) view stack, V = [tgt, src_0, ..., src_{ns-1}],
    batch-major as in the JAX version."""
    srcs = batch["src"]
    ns = srcs.shape[1] // 3
    return torch.stack([batch["tgt"]] + [srcs[:, 3 * s:3 * (s + 1)]
                                         for s in range(ns)], 1)


def geonet_forward(disp_net: DispNetS, pose_net: PoseNet, batch: dict,
                   config: GeoNetConfig):
    """DispNetS + PoseNet on a preprocessed batch. Returns disparities
    (per scale, (B, V, 1, h, w)), depths (per scale, (B, V, h, w)) and poses
    (B, ns, 6)."""
    b = batch["tgt"].shape[0]
    nv = 1 + config.num_source
    views = stack_views(batch)
    disparities = [d.reshape(b, nv, *d.shape[1:])
                   for d in disp_net(views.reshape(b * nv, *views.shape[2:]))]
    depths = [1.0 / d[:, :, 0] for d in disparities]
    poses = pose_net(torch.cat([batch["tgt"], batch["src"]], 1))
    return disparities, depths, poses


def geonet_loss(disp_net: DispNetS, pose_net: PoseNet, batch: dict,
                config: GeoNetConfig) -> tuple[torch.Tensor, dict]:
    """Total stage-1 loss of one preprocessed batch, and its parts."""
    _, depths, poses = geonet_forward(disp_net, pose_net, batch, config)
    return geonet_loss_tail(depths, poses, batch, config)


def geonet_loss_tail(depths: list, poses: torch.Tensor, batch: dict,
                     config: GeoNetConfig) -> tuple[torch.Tensor, dict]:
    """Rigid-warp photometric + smoothness losses from the nets' outputs."""
    cfg = config
    b = batch["tgt"].shape[0]
    ns = cfg.num_source
    nv = 1 + ns
    views = stack_views(batch)
    views_pyr = scale_pyramid(views.reshape(b * nv, *views.shape[2:]),
                              cfg.num_scales)
    ms_intrinsics = compute_multi_scale_intrinsics(batch["intrinsics"],
                                                   cfg.num_scales)
    poses_flat = poses.reshape(b * ns, 6).float()

    loss_rigid_warp = 0.0
    loss_disp_smooth = 0.0
    for s in range(cfg.num_scales):
        hs, ws = views_pyr[s].shape[2], views_pyr[s].shape[3]
        v_s = views_pyr[s].reshape(b, nv, 3, hs, ws)
        k_s = ms_intrinsics[:, s, None].expand(b, ns, 3, 3).reshape(
            b * ns, 3, 3)
        depth_s = depths[s].float()
        tgt_depth = depth_s[:, :1].expand(b, ns, hs, ws).reshape(
            b * ns, hs, ws)
        src_depth = depth_s[:, 1:].reshape(b * ns, hs, ws)

        fwd_flow = compute_rigid_flow(poses_flat, tgt_depth, k_s, False)
        bwd_flow = compute_rigid_flow(poses_flat, src_depth, k_s, True)
        grid = pixel_grid(hs, ws, torch.float32, fwd_flow.device)
        cf = (grid + fwd_flow).reshape(b, ns, 2, hs, ws)
        cb = (grid + bwd_flow).reshape(b, ns, 2, hs, ws)
        pair_sum = warp_photo_pair_loss(
            v_s[:, 0].contiguous(), v_s[:, 1:].contiguous(), cf.contiguous(),
            cb.contiguous(), cfg.simi_alpha)
        denom = float(b * ns * 3 * hs * ws)
        loss_rigid_warp = loss_rigid_warp + (
            cfg.loss_weight_rigid_warp * ns / 2.0 * pair_sum / denom)

        loss_disp_smooth = loss_disp_smooth + (
            cfg.loss_weight_disparity_smooth / (2 ** s)
            * smooth_loss(depth_s.reshape(b * nv, 1, hs, ws), views_pyr[s]))

    total = loss_rigid_warp + loss_disp_smooth
    return total, {"loss_rigid_warp": loss_rigid_warp,
                   "loss_disp_smooth": loss_disp_smooth,
                   "loss_total": total}


def make_optimizer(config: GeoNetConfig, params) -> torch.optim.Adam:
    """Adam(lr=2e-4, betas=(0.9, 0.999), eps=1e-8) - `baseline.py:1269`;
    eps sits outside the square root, as in optax.adam."""
    return torch.optim.Adam(params, lr=config.learning_rate,
                            betas=(config.adam_beta1, config.adam_beta2),
                            eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """Models, optimizer and counters; :func:`train_step` updates it in
    place."""
    disp_net: DispNetS
    pose_net: PoseNet
    optimizer: torch.optim.Adam
    step: int = 0
    notfinite_count: int = 0

    def parameters(self) -> list[torch.nn.Parameter]:
        return [*self.disp_net.parameters(), *self.pose_net.parameters()]


def create_train_state(config: GeoNetConfig, device) -> TrainState:
    apply_precision(config)
    disp_net, pose_net = build_models(config, device)
    params = [*disp_net.parameters(), *pose_net.parameters()]
    return TrainState(disp_net, pose_net, make_optimizer(config, params))


def train_step(state: TrainState, batch: dict,
               config: GeoNetConfig) -> dict:
    """One optimizer step on a raw batch (uint8 NHWC images on the device).

    The update is skipped, and the skip counted, when the loss or any
    gradient is non-finite. Returns the loss parts, detached."""
    batch = preprocess_batch(batch)
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = geonet_loss(state.disp_net, state.pose_net, batch, config)
    total.backward()
    grads = [p.grad for p in state.parameters() if p.grad is not None]
    finite = torch.stack([torch.isfinite(total)]
                         + [torch.isfinite(g).all() for g in grads]).all()
    if bool(finite):
        state.optimizer.step()
        state.notfinite_count = 0
    else:
        state.notfinite_count += 1
        if state.notfinite_count > MAX_CONSECUTIVE_SKIPS:
            raise FloatingPointError(
                f"{state.notfinite_count} consecutive non-finite steps")
    state.step += 1
    return {k: v.detach() for k, v in aux.items()}
