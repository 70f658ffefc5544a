"""GeoNet self-supervised training step, stages 1 and 2 (PyTorch).

Counterpart of ``sndepth_tpu/train/geonet.py`` (reference
`models/baseline.py:746-1278`): DispNetS over the stacked [target, sources]
views, PoseNet over their channel concatenation, a 4-scale rigid-warp
photometric loss through the fused pair kernel
(:mod:`sndepth_tpu_torch.kernels.photo_loss`), edge-aware smoothness
through the fused smoothness kernel, and Adam.

With ``config.train_flow`` (stage 2) a residual FlowNet refines the rigid
flows. It eats the scale-0 warped image and error map, so scale 0 keeps the
split ops there (the warp gather and the DSSIM map, forward direction) and
the single-direction photo kernel (backward direction); the full flows then
pay a weighted photometric pair loss, a per-channel smoothness loss and a
forward-backward consistency loss whose masks come from warping one flow by
the other.

Kernels are chosen by the device the tensors live on: CUDA tensors launch
them, CPU tensors take their plain versions.

On one process with the batch on a CUDA device, :func:`train_step` runs
the step as replays of CUDA graphs (:class:`_StepGraphs`): the same
kernels in the same order, issued by one call instead of ~3,500.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from sndepth_tpu_torch.core.config import GeoNetConfig, apply_precision
from sndepth_tpu_torch.kernels.photo_loss import (
    warp_photo_loss, warp_photo_pair_loss, warp_photo_pair_loss_weighted)
from sndepth_tpu_torch.losses.photometric import (flow_smooth_loss,
                                                  smooth_loss)
from sndepth_tpu_torch.models.dispnet import DispNetS, init_weights
from sndepth_tpu_torch.models.flownet import FlowNet
from sndepth_tpu_torch.models.posenet import PoseNet
from sndepth_tpu_torch.ops.camera import (compute_multi_scale_intrinsics,
                                          compute_rigid_flow)
from sndepth_tpu_torch.ops.pyramid import scale_pyramid
from sndepth_tpu_torch.ops.ssim import image_similarity
from sndepth_tpu_torch.ops.warp import flow_warp, pixel_grid
from sndepth_tpu_torch.utils import tracing

# As optax.apply_if_finite(max_consecutive_errors=100) in the JAX step: a
# non-finite step is skipped; the 101st consecutive one raises here, where
# optax would start applying the non-finite updates.
MAX_CONSECUTIVE_SKIPS = 100


# FlowNet input: tgt (3) + src (3) + warped (3) + rigid flow (2) + |err| (1)
FLOW_IN_CHANNELS = 12


def build_models(config: GeoNetConfig, device
                 ) -> tuple[DispNetS, PoseNet, FlowNet | None]:
    """DispNetS, PoseNet and, with ``config.train_flow``, FlowNet (else
    ``None``), with weights drawn on the host in that order from a generator
    seeded with ``config.seed``, then moved to ``device``: the same seed
    gives the same weights on every device."""
    gen = torch.Generator().manual_seed(config.seed)
    nets = [DispNetS(dtype=config.compute_dtype),
            PoseNet(num_source=config.num_source, dtype=config.compute_dtype)]
    if config.train_flow:
        nets.append(FlowNet(FLOW_IN_CHANNELS, config.flow_scale_factor,
                            dtype=config.compute_dtype))
    for net in nets:
        init_weights(net, gen)
    nets = [net.to(device) for net in nets]
    return nets[0], nets[1], (nets[2] if config.train_flow else None)


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
                config: GeoNetConfig, flow_net: FlowNet | None = None,
                mask_mean=torch.mean) -> tuple[torch.Tensor, dict]:
    """Total loss of one preprocessed batch, and its parts."""
    with tracing.span("geonet#nets"):
        _, depths, poses = geonet_forward(disp_net, pose_net, batch, config)
    with tracing.span("geonet#loss_tail"):
        return geonet_loss_tail(depths, poses, batch, config, flow_net,
                                mask_mean)


def geonet_loss_tail(depths: list, poses: torch.Tensor, batch: dict,
                     config: GeoNetConfig, flow_net: FlowNet | None = None,
                     mask_mean=torch.mean) -> tuple[torch.Tensor, dict]:
    """Rigid-warp photometric + smoothness losses from the nets' outputs,
    and the stage-2 flow losses when ``config.train_flow`` (``flow_net`` is
    read by that branch only). ``mask_mean`` gives the stage-2 consistency
    masks' normalisers (see :func:`_full_flow_losses`).

    Every stage-1 term is a mean over the batch, so on equal shards of a
    global batch the ranks' mean of it is the global batch's: a
    data-parallel step needs no reduction here."""
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
    fwd_flows, bwd_flows, tgt_tile_pyr, src_pyr = [], [], [], []
    fwd_warp0 = fwd_err0 = None
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
        denom = float(b * ns * 3 * hs * ws)
        if not cfg.train_flow or s > 0:
            cf = (grid + fwd_flow).reshape(b, ns, 2, hs, ws)
            cb = (grid + bwd_flow).reshape(b, ns, 2, hs, ws)
            pair_sum = warp_photo_pair_loss(
                v_s[:, 0].contiguous(), v_s[:, 1:].contiguous(),
                cf.contiguous(), cb.contiguous(), cfg.simi_alpha)
        if cfg.train_flow:
            tgt_s = v_s[:, :1].expand(b, ns, 3, hs, ws).reshape(
                b * ns, 3, hs, ws).contiguous()
            src_s = v_s[:, 1:].reshape(b * ns, 3, hs, ws).contiguous()
            tgt_tile_pyr.append(tgt_s)
            src_pyr.append(src_s)
            fwd_flows.append(fwd_flow)
            bwd_flows.append(bwd_flow)
            if s == 0:
                # Only the forward warp and error map feed FlowNet, so the
                # backward direction takes the fused kernel.
                fwd_warp0 = flow_warp(src_s, fwd_flow)
                fwd_err0 = image_similarity(cfg.simi_alpha, tgt_s, fwd_warp0)
                pair_sum = fwd_err0.sum() + warp_photo_loss(
                    src_s, tgt_s, (grid + bwd_flow).contiguous(),
                    cfg.simi_alpha)
        loss_rigid_warp = loss_rigid_warp + (
            cfg.loss_weight_rigid_warp * ns / 2.0 * pair_sum / denom)

        loss_disp_smooth = loss_disp_smooth + (
            cfg.loss_weight_disparity_smooth / (2 ** s)
            * smooth_loss(depth_s.reshape(b * nv, 1, hs, ws), views_pyr[s]))

    total = loss_rigid_warp + loss_disp_smooth
    aux = {"loss_rigid_warp": loss_rigid_warp,
           "loss_disp_smooth": loss_disp_smooth}
    if cfg.train_flow:
        flow_losses = _full_flow_losses(
            flow_net, cfg, tgt_tile_pyr, src_pyr, fwd_flows, bwd_flows,
            fwd_warp0, fwd_err0, mask_mean)
        total = total + sum(flow_losses.values())
        aux.update(flow_losses)
    aux["loss_total"] = total
    return total, aux


def _err_magnitude(err: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(err + 1e-10, dim=1, keepdim=True)


def _consistency(flow: torch.Tensor, other: torch.Tensor, s: int,
                 cfg: GeoNetConfig):
    """|warp(other, flow) + flow| and the mask (N, 1, h, w) of the pixels
    where it stays under the bound (`baseline.py:1063-1113`): the share of
    the two flow channels that do. The bound and the mask carry no
    gradient; the difference is differentiated in both flows."""
    diff = torch.abs(flow_warp(other, flow) + flow)
    bound = torch.clamp_min(
        cfg.geometric_consistency_beta * torch.abs(flow) * 2 ** s,
        cfg.geometric_consistency_alpha).detach()
    mask = (diff * 2 ** s < bound).float().mean(1, keepdim=True)
    return diff, mask


def _full_flow_losses(flow_net: FlowNet, cfg: GeoNetConfig, tgt_tile_pyr,
                      src_pyr, fwd_rigid, bwd_rigid, fwd_warp0, fwd_err0,
                      mask_mean=torch.mean) -> dict:
    """Stage-2 GeoNet: residual FlowNet and the full-flow warp, smoothness
    and consistency losses (``sndepth_tpu/train/geonet.py:
    _full_flow_losses``). Pyramids are lists over scales of (B*ns, C, h, w);
    ``fwd_warp0`` / ``fwd_err0`` are the scale-0 forward warp and error.

    The masked terms divide by the mean of their mask, ``mask_mean(mask)``.
    On one process that is the batch's mean. A rank of a data-parallel step
    holds a shard of the global batch and passes the global batch's mean
    (:class:`sndepth_tpu_torch.parallel.mesh.DataReduce`): each rank's
    masked terms are then the world size times its share of the global
    batch's, so the ranks' mean of the loss, and of its gradient, is the
    global batch's, as in the JAX step over the whole batch."""
    n = tgt_tile_pyr[0].shape[0]
    ns = cfg.num_source
    tgt0, src0 = tgt_tile_pyr[0], src_pyr[0]
    fwd_in = torch.cat([tgt0, src0, fwd_warp0, fwd_rigid[0],
                        _err_magnitude(fwd_err0)], 1)
    bwd_warp0 = flow_warp(tgt0, bwd_rigid[0])
    bwd_err0 = image_similarity(cfg.simi_alpha, src0, bwd_warp0)
    bwd_in = torch.cat([src0, tgt0, bwd_warp0, bwd_rigid[0],
                        _err_magnitude(bwd_err0)], 1)
    # Forward and backward interleaved per pair: (n, 2) flattened.
    fb = torch.stack([fwd_in, bwd_in], 1)
    resflow = flow_net(fb.reshape(2 * n, *fb.shape[2:]))

    loss_warp = 0.0
    loss_smooth = 0.0
    loss_geo = 0.0
    for s in range(cfg.num_scales):
        hs, ws = tgt_tile_pyr[s].shape[2:]
        r_s = resflow[s].reshape(n, 2, 2, hs, ws)
        fwd_full = r_s[:, 0] + fwd_rigid[s]
        bwd_full = r_s[:, 1] + bwd_rigid[s]
        fwd_diff, fwd_mask = _consistency(fwd_full, bwd_full, s, cfg)
        bwd_diff, bwd_mask = _consistency(bwd_full, fwd_full, s, cfg)
        fwd_norm = mask_mean(fwd_mask).clamp_min(1e-6)
        bwd_norm = mask_mean(bwd_mask).clamp_min(1e-6)

        # The masked, mean-normalised photometric pair is linear in the
        # masks, which carry no gradient: they ride the weighted kernel as
        # per-pixel weights, the normalisations folded in.
        nelem = 3.0 * fwd_mask.numel()
        grid = pixel_grid(hs, ws, torch.float32, fwd_full.device)
        pair_sum = warp_photo_pair_loss_weighted(
            tgt_tile_pyr[s], src_pyr[s][:, None],
            (grid + fwd_full)[:, None].contiguous(),
            (grid + bwd_full)[:, None].contiguous(),
            (fwd_mask / (fwd_norm * nelem)).contiguous(),
            (bwd_mask / (bwd_norm * nelem)).contiguous(), cfg.simi_alpha)
        loss_warp = loss_warp + cfg.loss_weight_full_warp * ns / 2.0 * pair_sum

        loss_smooth = loss_smooth + (
            cfg.loss_weight_full_smooth / 2 ** (s + 1)
            * (flow_smooth_loss(fwd_full, tgt_tile_pyr[s])
               + flow_smooth_loss(bwd_full, src_pyr[s])))

        loss_geo = loss_geo + (
            cfg.loss_weight_geometrical_consistency / 2.0
            * ((fwd_diff.mean(1, keepdim=True) * fwd_mask).mean() / fwd_norm
               + (bwd_diff.mean(1, keepdim=True) * bwd_mask).mean()
               / bwd_norm))

    return {"loss_full_warp": loss_warp, "loss_full_smooth": loss_smooth,
            "loss_geometric_consistency": loss_geo}


def make_optimizer(config: GeoNetConfig, params) -> torch.optim.Adam:
    """Adam(lr=2e-4, betas=(0.9, 0.999), eps=1e-8) - `baseline.py:1269`;
    eps sits outside the square root, as in optax.adam. On CUDA
    parameters its step count lives on the card (``capturable``), so that
    a CUDA graph can replay the update: the same update."""
    params = list(params)
    return torch.optim.Adam(params, lr=config.learning_rate,
                            betas=(config.adam_beta1, config.adam_beta2),
                            eps=1e-8,
                            capturable=all(p.is_cuda for p in params))


@dataclasses.dataclass
class TrainState:
    """Models, optimizer and counters; :func:`train_step` updates it in
    place."""
    disp_net: DispNetS
    pose_net: PoseNet
    optimizer: torch.optim.Adam
    flow_net: FlowNet | None = None
    step: int = 0
    notfinite_count: int = 0
    # The step's CUDA graphs, made by train_step; not part of the state
    # dict.
    _graphs: _StepGraphs | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def nets(self) -> dict[str, torch.nn.Module]:
        """The nets by checkpoint key, in parameter order."""
        nets = {"disp_net": self.disp_net, "pose_net": self.pose_net}
        if self.flow_net is not None:
            nets["flow_net"] = self.flow_net
        return nets

    def parameters(self) -> list[torch.nn.Parameter]:
        return [p for net in self.nets().values() for p in net.parameters()]

    def state_dict(self) -> dict:
        """What a checkpoint holds: the counters, each net's state dict
        under its key and the optimizer's."""
        return {"step": self.step, "notfinite_count": self.notfinite_count,
                **{k: net.state_dict() for k, net in self.nets().items()},
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, saved: dict) -> None:
        # The optimizer's state tensors are replaced, and the update's
        # graph reads the old ones.
        self._graphs = None
        for key, net in self.nets().items():
            if key not in saved:
                raise KeyError(f"the checkpoint holds no {key}: it was "
                               "saved by a run without that net")
            net.load_state_dict(saved[key])
        # Whether Adam keeps its step count on the card is this state's
        # choice, by the device of its parameters, not the saving run's:
        # torch then moves the saved counts to match.
        optim = saved["optimizer"]
        optim = {**optim, "param_groups": [
            {**g, "capturable": live["capturable"]} for g, live in zip(
                optim["param_groups"], self.optimizer.param_groups)]}
        self.optimizer.load_state_dict(optim)
        self.step = int(saved["step"])
        self.notfinite_count = int(saved["notfinite_count"])


def create_train_state(config: GeoNetConfig, device) -> TrainState:
    apply_precision(config)
    disp_net, pose_net, flow_net = build_models(config, device)
    state = TrainState(disp_net, pose_net, None, flow_net)
    state.optimizer = make_optimizer(config, state.parameters())
    return state


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a sharded DTensor (FSDP's gradients); a plain
    tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


@tracing.span("geonet#step")
def train_step(state: TrainState, batch: dict, config: GeoNetConfig,
               nets: tuple | None = None, ranks=None) -> dict:
    """One optimizer step on a raw batch (uint8 NHWC images on the device).

    The update is skipped, and the skip counted, when the loss or any
    gradient is non-finite. Returns the loss parts, detached.

    A data-parallel step (``parallel/mesh.py``, ``parallel/fsdp.py``)
    passes the wrapped (DispNetS, PoseNet, FlowNet or None) as ``nets`` and
    the group's reductions as ``ranks`` (:class:`~sndepth_tpu_torch.
    parallel.mesh.DataReduce`): the stage-2 mask normalisers are then the
    global batch's, the finite flag holds only when it holds on every rank
    (a rank's loss is its own, and FSDP's gradients are shards: each rank
    sees only its part), and the loss parts are the ranks' mean, the same
    on every rank.

    Without either, on a batch of CUDA tensors with grad mode on, the step
    replays CUDA graphs of itself (:class:`_StepGraphs`); every other step
    is issued op by op."""
    if nets is None and ranks is None and _graphable(batch):
        return _graph_step(state, batch, config)
    return _eager_step(state, batch, config, nets, ranks)


def _graphable(batch: dict) -> bool:
    return torch.is_grad_enabled() and all(
        isinstance(v, torch.Tensor) and v.is_cuda for v in batch.values())


def _eager_step(state: TrainState, batch: dict, config: GeoNetConfig,
                nets: tuple | None = None, ranks=None) -> dict:
    tracing.count("eager_steps")
    state.optimizer.zero_grad(set_to_none=True)
    finite, aux = _loss_and_grads(state, batch, config, nets, ranks)
    _update_if_finite(state, finite, state.optimizer.step)
    return {k: v.detach() for k, v in aux.items()}


def _loss_and_grads(state: TrainState, batch: dict, config: GeoNetConfig,
                    nets: tuple | None = None, ranks=None):
    """The loss parts of a raw batch, the gradients in the parameters'
    ``grad`` and the flag that the loss and every gradient are finite,
    with nothing read on the host: (finite flag, loss parts)."""
    batch = preprocess_batch(batch)
    disp_net, pose_net, flow_net = nets or (state.disp_net, state.pose_net,
                                            state.flow_net)
    total, aux = geonet_loss(
        disp_net, pose_net, batch, config, flow_net,
        ranks.mean if ranks is not None else torch.mean)
    with tracing.span("geonet#backward"):
        total.backward()
    grads = [_local(p.grad) for p in state.parameters() if p.grad is not None]
    finite = torch.stack([torch.isfinite(total)]
                         + [torch.isfinite(g).all() for g in grads]).all()
    if ranks is not None:
        finite = ranks.all(finite)
        aux = ranks.average(aux)
    return finite, aux


def _update_if_finite(state: TrainState, finite: torch.Tensor,
                      update) -> None:
    """Wait for ``finite`` on the host; call ``update`` (Adam) when it
    holds, else count the skip."""
    with tracing.span("geonet#finite_sync"):
        finite = bool(finite)
    if finite:
        with tracing.span("geonet#adam"):
            update()
        state.notfinite_count = 0
    else:
        state.notfinite_count += 1
        if state.notfinite_count > MAX_CONSECUTIVE_SKIPS:
            raise FloatingPointError(
                f"{state.notfinite_count} consecutive non-finite steps")
    state.step += 1


def _graph_step(state: TrainState, batch: dict,
                config: GeoNetConfig) -> dict:
    """The one-process step on CUDA tensors. A key is the config, the
    optimizer and nets the state holds, and each batch tensor's shape and
    dtype. Its first steps run eagerly on the graphs' side stream, as
    their warm-up (cuDNN's choices, the allocator, K2's ticket for that
    stream), until one of them has made Adam's state; the next captures
    the graphs, and it and every later step replay them. A step of another
    key drops them and starts the new key's warm-up."""
    key = (config, state.optimizer, *state.nets().values(),
           *((k, v.shape, v.dtype, v.device) for k, v in batch.items()))
    graphs = state._graphs
    if graphs is None or graphs.key != key:
        state._graphs = graphs = _StepGraphs(key, batch["tgt"].device)
    if graphs.step is None:
        if not graphs.ready(state.optimizer):
            graphs.warmups += 1
            with graphs.side_stream():
                return _eager_step(state, batch, config)
        graphs.capture(state, batch, config)
    with tracing.span("geonet#replay"):
        graphs.replay(batch)
    tracing.count("graph_replays")
    _update_if_finite(state, graphs.finite, graphs.adam.replay)
    parts = graphs.parts.clone()
    return dict(zip(graphs.names, parts.unbind()))


class _StepGraphs:
    """The step of one key as two CUDA graphs, captured together on a side
    stream and replayed on the current one: ``step`` takes the static
    batch ``inputs`` through :func:`preprocess_batch`, the nets, the loss
    and the backward to the parameters' gradients, the ``finite`` flag and
    the stacked loss ``parts``; ``adam`` is the optimizer's update, which
    reads those gradients. Capturing executes nothing: the replay that
    follows it is the step, so a step's state is what the eager step
    leaves. Adam's state must exist before the capture: a graph that made
    it would zero the moments at every replay."""

    def __init__(self, key, device: torch.device):
        self.key = key
        self.stream = torch.cuda.Stream(device)
        self.warmups = 0
        self.inputs = self.finite = self.parts = None
        self.names = ()
        self.step = self.adam = None
        # The hand-written kernels' launches that the capture counted,
        # which each replay adds: copied from the capture, not measured.
        self.launches = {}

    @contextlib.contextmanager
    def side_stream(self):
        """Run on the side stream, after the current stream's work; the
        current stream then waits for it."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def ready(self, optimizer: torch.optim.Adam) -> bool:
        """Warmed up, with Adam's state made for every parameter that has
        a gradient."""
        grads = [p for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        return self.warmups > 0 and all(p in optimizer.state for p in grads)

    def capture(self, state: TrainState, batch: dict,
                config: GeoNetConfig) -> None:
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        # Gradients set to None, so that the backward allocates them in
        # the graph's memory, where every replay writes them anew.
        state.optimizer.zero_grad(set_to_none=True)
        before = tracing.counts()
        step, adam = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with tracing.span("geonet#capture"):
            with torch.cuda.graph(step, stream=self.stream):
                self.finite, aux = _loss_and_grads(state, self.inputs,
                                                   config)
                self.names = tuple(aux)
                self.parts = torch.stack([aux[k].detach()
                                          for k in self.names])
            with torch.cuda.graph(adam, pool=step.pool(),
                                  stream=self.stream):
                state.optimizer.step()
        self.step, self.adam = step, adam
        # The capture launched nothing: what the wrappers counted is taken
        # back here, and added by each replay.
        after = tracing.counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        for k, n in self.launches.items():
            tracing.count(k, -n)
        tracing.count("graph_captures")

    def replay(self, batch: dict) -> None:
        for k, t in self.inputs.items():
            t.copy_(batch[k])
        self.step.replay()
        for k, n in self.launches.items():
            tracing.count(k, n)
