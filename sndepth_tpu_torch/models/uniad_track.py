"""UniADTrack: camera-only multi-object tracking.

Counterpart of ``sndepth_tpu/models/uniad_track.py`` (reference
`models/track_uniad.py`): ResNet + FPN image features (DCNv2 in stages 3-4)
-> the BEVFormer encoder -> the DETR decoder over the track queries (900
objects + 1 ego) -> the tracker's lifecycle, the memory bank and the query
interaction. The per-frame state is an explicit :class:`TrackState` handed
from frame to frame; :func:`uniad_reference_config` is the reference's
full-size model.

Training (``train_frame``, ``train_clip``) runs a clip frame by frame with
the track carry, matches every decoder layer against the GTs, binds new
tracks, and refreshes the carry through the memory bank and the trainer's
query selection; the QIM draws are arguments (or come from a
``torch.Generator``), so another side's can be handed across. As in JAX,
the previous frame's BEV is carried detached.

Images are NCHW: a frame is (cams, B, 3, H, W). The state_dict names are
the reference's: ``img_backbone.*`` (``conv1``, ``bn1``,
``layer{s}.{b}.{conv1,bn1,conv2,bn2,conv3,bn3,downsample.0,downsample.1}``,
a DCN's ``conv2.weight`` and ``conv2.conv_offset``), ``img_neck.*``
(``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``), ``pts_bbox_head.*``,
``query_embedding``, ``reference_points``, ``memory_bank.*``,
``query_interact.*``. The frozen BatchNorm of the caffe backbone
(``backbone_norm="affine"``) keeps ``weight``, ``bias``, ``running_mean``
and ``running_var`` and is the channel affine they make.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.coders import nms_free_decode
from sndepth_tpu_torch.models.deformable import DeformConv2d
from sndepth_tpu_torch.models.track_head import BEVFormerTrackHead
from sndepth_tpu_torch.models.track_runtime import (
    MemoryBank, QueryInteractionModule, TrackInstances, empty_tracks,
    qim_select_train, tracker_update, velocity_update_reference_points)
from sndepth_tpu_torch.ops import layers
from sndepth_tpu_torch.ops.layers import Conv2d
from sndepth_tpu_torch.ops.norm import GroupNorm
from sndepth_tpu_torch.utils import tracing


def uniad_reference_config(**overrides) -> "UniADTrack":
    """The reference's full-size model: 200x200 BEV, 901 queries, 256 dims,
    6 + 6 layers, a caffe ResNet-101 with frozen BatchNorm and DCN in
    stages 3-4, 10 classes, the nuScenes point-cloud range."""
    cfg = dict(num_query=901, num_classes=10, embed_dims=256, bev_h=200,
               bev_w=200, num_cams=6, encoder_layers=6, decoder_layers=6,
               backbone_blocks=(3, 4, 23, 3),
               pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
               score_thresh=0.4, filter_score_thresh=0.35, miss_tolerance=5,
               mem_len=4, backbone_style="caffe", backbone_norm="affine")
    cfg.update(overrides)
    return UniADTrack(**cfg)


@dataclasses.dataclass
class TrackState:
    """What one frame hands the next."""
    prev_bev: torch.Tensor          # (1, bev_h bev_w, C)
    tracks: TrackInstances
    next_obj_id: torch.Tensor       # () int32
    timestamp: torch.Tensor         # () seconds
    has_prev: torch.Tensor          # () bool


class ChannelAffine(nn.Module):
    """A frozen BatchNorm2d (torchvision's ``FrozenBatchNorm2d``): the
    channel affine ``x weight / sqrt(running_var + eps) + bias - running_mean
    weight / sqrt(running_var + eps)``, in ``dtype``."""

    def __init__(self, c: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.compute_dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.full((c,), 1.0 - eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        dt = self.compute_dtype
        return (x.to(dt) * scale.to(dt)[:, None, None]
                + shift.to(dt)[:, None, None]).to(dt)


def _norm(kind: str, c: int, dtype) -> nn.Module:
    if kind == "affine":
        return ChannelAffine(c, dtype=dtype)
    return GroupNorm(32, c, dtype=dtype)


class Bottleneck(nn.Module):
    """ResNet bottleneck; ``style="caffe"`` strides the first 1x1,
    ``"pytorch"`` the 3x3 (the DCN where ``use_dcn``)."""

    def __init__(self, cin: int, width: int, stride: int, dtype,
                 use_dcn: bool = False, style: str = "pytorch",
                 norm: str = "gn"):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = Conv2d(cin, width, 1, stride=s1, bias=False, dtype=dtype)
        self.bn1 = _norm(norm, width, dtype)
        if use_dcn:
            self.conv2 = DeformConv2d(width, width, 3, stride=s2, dtype=dtype)
        else:
            self.conv2 = Conv2d(width, width, 3, stride=s2, padding=1,
                                bias=False, dtype=dtype)
        self.bn2 = _norm(norm, width, dtype)
        self.conv3 = Conv2d(width, 4 * width, 1, bias=False, dtype=dtype)
        self.bn3 = _norm(norm, 4 * width, dtype)
        self.downsample = None
        if stride != 1 or cin != 4 * width:
            self.downsample = nn.Sequential(
                Conv2d(cin, 4 * width, 1, stride=stride, bias=False,
                       dtype=dtype),
                _norm(norm, 4 * width, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + h)


class ResNet(nn.Module):
    """The image backbone: a 7x7 stem, a max pool and four stages of
    bottlenecks at widths 64-512; returns the four stages' outputs."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 23, 3),
                 stage_with_dcn: Sequence[bool] = (False, False, True, True),
                 style: str = "pytorch", norm: str = "gn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            dtype=dtype)
        self.bn1 = _norm(norm, 64, dtype)
        cin = 64
        for si, (blocks, width) in enumerate(zip(stage_blocks,
                                                 (64, 128, 256, 512))):
            stage = []
            for bi in range(blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                stage.append(Bottleneck(cin, width, stride, dtype,
                                        stage_with_dcn[si], style, norm))
                cin = 4 * width
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))

    def forward(self, x: torch.Tensor) -> list:
        h = F.relu(self.bn1(self.conv1(x.to(self.compute_dtype))))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        feats = []
        for i in range(4):
            h = getattr(self, f"layer{i + 1}")(h)
            feats.append(h)
        return feats


class _ConvModule(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride=stride, padding=padding,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    """Laterals on stages 2-4, top-down nearest upsampling (flax's
    ``jax.image.resize`` "nearest", torch's ``nearest-exact``), 3x3 output
    convolutions and one extra stride-2 level on the ReLU of the last:
    ``embed_dims`` channels at 1/8, 1/16, 1/32, 1/64."""

    def __init__(self, embed_dims: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lateral_convs = nn.ModuleList([
            _ConvModule(4 * w, embed_dims, 1, dtype=dtype)
            for w in (128, 256, 512)])
        self.fpn_convs = nn.ModuleList(
            [_ConvModule(embed_dims, embed_dims, 3, padding=1, dtype=dtype)
             for _ in range(3)]
            + [_ConvModule(embed_dims, embed_dims, 3, stride=2, padding=1,
                           dtype=dtype)])

    def forward(self, feats: list) -> list:
        lats = [conv(f) for conv, f in zip(self.lateral_convs, feats[1:])]
        for i in (1, 0):
            lats[i] = lats[i] + F.interpolate(
                lats[i + 1], size=lats[i].shape[-2:], mode="nearest-exact")
        outs = [self.fpn_convs[i](lats[i]) for i in range(3)]
        return outs + [self.fpn_convs[3](F.relu(outs[-1]))]


class ResNetFPN(nn.Module):
    """``img_backbone`` and ``img_neck`` in one module (the JAX
    ``ResNetFPN``): (N, 3, H, W) -> four (N, C, h, w) levels."""

    def __init__(self, stage_blocks=(3, 4, 23, 3), embed_dims: int = 256,
                 stage_with_dcn=(False, False, True, True),
                 style: str = "pytorch", norm: str = "gn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_backbone = ResNet(stage_blocks, stage_with_dcn, style, norm,
                                   dtype)
        self.img_neck = FPN(embed_dims, dtype)

    def forward(self, x: torch.Tensor) -> list:
        return self.img_neck(self.img_backbone(x))


class UniADTrack(nn.Module):
    """The camera tracking model (defaults: the JAX ``UniADTrack()``'s)."""

    def __init__(self, num_query: int = 901, num_classes: int = 10,
                 embed_dims: int = 256, bev_h: int = 200, bev_w: int = 200,
                 num_cams: int = 6, encoder_layers: int = 6,
                 decoder_layers: int = 6,
                 backbone_blocks: Sequence[int] = (3, 4, 23, 3),
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 score_thresh: float = 0.4, filter_score_thresh: float = 0.35,
                 miss_tolerance: int = 5, mem_len: int = 4,
                 backbone_style: str = "pytorch", backbone_norm: str = "gn",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.num_query, self.num_classes = num_query, num_classes
        self.embed_dims, self.bev_h, self.bev_w = embed_dims, bev_h, bev_w
        self.num_cams, self.mem_len = num_cams, mem_len
        self.pc_range = tuple(pc_range)
        self.score_thresh = score_thresh
        self.filter_score_thresh = filter_score_thresh
        self.miss_tolerance = miss_tolerance
        self.img_backbone = ResNet(backbone_blocks, style=backbone_style,
                                   norm=backbone_norm, dtype=dtype)
        self.img_neck = FPN(embed_dims, dtype)
        self.pts_bbox_head = BEVFormerTrackHead(
            bev_h=bev_h, bev_w=bev_w, embed_dims=embed_dims,
            num_classes=num_classes, num_query=num_query,
            num_encoder_layers=encoder_layers,
            num_decoder_layers=decoder_layers, num_cams=num_cams,
            pc_range=pc_range, dtype=dtype, remat=remat)
        self.query_embedding = nn.Embedding(num_query, 2 * embed_dims)
        self.reference_points = nn.Linear(embed_dims, 3)
        self.memory_bank = MemoryBank(embed_dims, mem_len, dtype=dtype)
        self.query_interact = QueryInteractionModule(
            embed_dims, update_query_pos=True, dtype=dtype)

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    def fresh_tracks(self) -> TrackInstances:
        """The learned queries and their reference points in free slots."""
        query = self.query_embedding.weight
        ref = torch.sigmoid(self.reference_points(query[:, :self.embed_dims]))
        return empty_tracks(self.num_query, self.embed_dims, self.num_classes,
                            self.mem_len, query_init=query, ref_init=ref,
                            device=query.device)

    def extract_img_feat(self, imgs: torch.Tensor) -> list:
        """(cams, B, 3, H, W) -> per level (cams, B, C, h, w)."""
        cams, b = imgs.shape[:2]
        feats = self.img_neck(self.img_backbone(imgs.flatten(0, 1)))
        return [f.reshape(cams, b, *f.shape[1:]) for f in feats]

    def get_bevs(self, imgs, lidar2img, prev_bev=None, ego_shift=None,
                 ego_rotation_deg=None, can_bus=None) -> torch.Tensor:
        with tracing.span("uniad#backbone"):
            feats = self.extract_img_feat(imgs)
        with tracing.span("uniad#bev_encoder"):
            return self.pts_bbox_head.get_bev_features(
                feats, lidar2img, tuple(imgs.shape[3:5]), prev_bev=prev_bev,
                ego_shift=ego_shift, ego_rotation_deg=ego_rotation_deg,
                can_bus=can_bus)

    def init_state(self) -> TrackState:
        dev = self.query_embedding.weight.device
        return TrackState(
            prev_bev=torch.zeros(1, self.bev_h * self.bev_w, self.embed_dims,
                                 device=dev),
            tracks=self.fresh_tracks(),
            next_obj_id=torch.zeros((), dtype=torch.int32, device=dev),
            timestamp=torch.zeros((), device=dev),
            has_prev=torch.zeros((), dtype=torch.bool, device=dev))

    @tracing.span("uniad#frame")
    def forward(self, imgs, lidar2img, state: TrackState, timestamp=None,
                ego_shift=None, ego_rotation_deg=None, max_dets: int = 100):
        """One inference frame: (new state, the decoded detections)."""
        tracks = state.tracks
        if timestamp is None:
            timestamp = state.timestamp
        timestamp = torch.as_tensor(timestamp, dtype=state.timestamp.dtype,
                                    device=state.timestamp.device)
        dt = torch.where(state.has_prev, timestamp - state.timestamp,
                         torch.zeros_like(timestamp))
        tracks = velocity_update_reference_points(
            tracks, tracks.pred_boxes[:, 8:10], dt, self.pc_range)
        # The first frame's previous BEV is zeros, not None: temporal
        # self-attention then samples zeros, not the current BEV.
        prev_bev = state.has_prev.float() * state.prev_bev
        bev = self.get_bevs(imgs, lidar2img, prev_bev=prev_bev,
                            ego_shift=ego_shift,
                            ego_rotation_deg=ego_rotation_deg)

        fresh = self.fresh_tracks()
        live = (tracks.obj_idxes >= 0)[:, None]
        query = torch.where(live, tracks.query, fresh.query)
        ref_pts = torch.where(live, tracks.ref_pts, fresh.ref_pts)
        with tracing.span("uniad#decoder"):
            det = self.pts_bbox_head.get_detections(bev, query[None],
                                                    ref_pts[None])
        logits = det["all_cls_scores"][-1, 0]
        boxes = det["all_bbox_preds"][-1, 0]
        out_emb = det["query_feats"][0]
        track_scores = torch.sigmoid(logits).amax(-1)
        tracks = tracks.replace(
            query=torch.cat([query[:, :self.embed_dims], out_emb], -1),
            ref_pts=det["ref_pts"][0], output_embedding=out_emb,
            scores=track_scores, track_scores=track_scores,
            pred_logits=logits, pred_boxes=boxes)
        with tracing.span("uniad#tracker"):
            tracks, next_obj_id = tracker_update(
                tracks, self.score_thresh, self.filter_score_thresh,
                self.miss_tolerance, state.next_obj_id)
            tracks = self.memory_bank(tracks)
            tracks = self.query_interact(tracks)
            results = nms_free_decode(logits, boxes, max_num=max_dets,
                                      obj_idxes=tracks.obj_idxes,
                                      track_scores=track_scores)
        # The carried state keeps its dtypes whatever the model computes in.
        old = state.tracks.tensors()
        tracks = TrackInstances(**{k: v.to(old[k].dtype)
                                   for k, v in tracks.tensors().items()})
        new_state = TrackState(
            prev_bev=bev.to(state.prev_bev.dtype), tracks=tracks,
            next_obj_id=next_obj_id.to(state.next_obj_id.dtype),
            timestamp=timestamp,
            has_prev=torch.ones_like(state.has_prev))
        return new_state, results

    def simple_test_track(self, imgs_seq, lidar2img, timestamps=None):
        """Track a clip (T, cams, B, 3, H, W) from a fresh state; returns
        the last state and each frame's detections."""
        state = self.init_state()
        results = []
        for t in range(imgs_seq.shape[0]):
            ts = timestamps[t] if timestamps is not None else float(t) * 0.5
            state, res = self(imgs_seq[t], lidar2img, state, timestamp=ts)
            results.append(res)
        return state, results

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _merge_with_fresh(self, tracks: TrackInstances,
                          keep: torch.Tensor) -> TrackInstances:
        """Slots not kept go back to the learned query and reference point
        with their state cleared (QIM's concatenation with the initial
        tracks); ``save_period`` stays, as in JAX."""
        fresh = self.fresh_tracks().tensors()
        merged = tracks.tensors()
        for k, v in merged.items():
            if k != "save_period":
                m = keep.reshape(keep.shape + (1,) * (v.dim() - 1))
                merged[k] = torch.where(m, v, fresh[k])
        return TrackInstances(**merged)

    def train_frame(self, imgs, lidar2img, tracks: TrackInstances, prev_bev,
                    has_prev, gt: dict, dt_next, qim_draws,
                    random_drop: float = 0.1, fp_ratio: float = 0.3):
        """One training frame: detect, match every decoder layer against
        ``gt``, bind new tracks, refresh the carry. ``qim_draws`` = (u_drop,
        u_fp), each (nq,) uniform. Returns (tracks, bev, losses, aux)."""
        from sndepth_tpu_torch.losses.track_loss import (
            scatter_last, train_frame_layer_losses)
        from sndepth_tpu_torch.ops.box_iou import iou_3d
        from sndepth_tpu_torch.utils.uniad import denormalize_bbox

        nq = self.num_query
        prev = (has_prev.float() * prev_bev).detach()
        bev = self.get_bevs(imgs, lidar2img, prev_bev=prev)
        det = self.pts_bbox_head.get_detections(bev, tracks.query[None],
                                                tracks.ref_pts[None])
        logits_l = det["all_cls_scores"][:, 0]
        boxes_l = det["all_bbox_preds"][:, 0]
        trajs_l = det["all_past_traj_preds"][:, 0]
        out_emb = det["query_feats"][0]
        new_ref = det["ref_pts"][0]
        track_scores = torch.sigmoid(logits_l[-1]).amax(-1).detach()

        losses, new_obj, assigned, matched = train_frame_layer_losses(
            logits_l, boxes_l, trajs_l, tracks.obj_idxes, gt,
            self.num_classes, sdc_slot=nq - 1)

        pred9 = denormalize_bbox(boxes_l[-1].detach())
        gt9 = denormalize_bbox(gt["boxes"])
        safe_q = torch.clamp(assigned, 0, nq - 1).long()
        pair_iou = torch.diagonal(iou_3d(pred9[safe_q][:, :7], gt9[:, :7]))
        iou = scatter_last(torch.zeros(nq, device=bev.device), safe_q,
                           torch.where(matched, pair_iou,
                                       torch.zeros_like(pair_iou)))

        velo = boxes_l[-1][:, 8:10].detach()
        x0, y0, _, x1, y1, _ = self.pc_range
        wx = new_ref[:, 0] * (x1 - x0) + x0 + velo[:, 0] * dt_next
        wy = new_ref[:, 1] * (y1 - y0) + y0 + velo[:, 1] * dt_next
        ref_xy = torch.stack([(wx - x0) / (x1 - x0), (wy - y0) / (y1 - y0)],
                             -1)
        fresh_ref = self.fresh_tracks().ref_pts
        ref_pts = torch.cat([ref_xy, fresh_ref[:, 2:3]], -1).detach()

        tracks = tracks.replace(
            query=torch.cat([tracks.query[:, :self.embed_dims], out_emb], -1),
            ref_pts=ref_pts, output_embedding=out_emb, scores=track_scores,
            track_scores=track_scores, pred_logits=logits_l[-1],
            pred_boxes=boxes_l[-1], obj_idxes=new_obj, iou=iou)
        tracks = self.memory_bank(tracks)
        keep = qim_select_train(tracks, *qim_draws, random_drop=random_drop,
                                fp_ratio=fp_ratio)
        tracks = self.query_interact(tracks, update_mask=keep)
        tracks = self._merge_with_fresh(tracks, keep)
        aux = {"num_matched": matched.sum(), "num_kept": keep.sum(),
               "assigned": assigned, "matched": matched, "keep": keep}
        return tracks, bev, losses, aux

    def train_clip(self, imgs_seq, lidar2img, gt_clip: dict, timestamps,
                   qim_draws=None, generator: torch.Generator | None = None):
        """The clip's training forward: frames in order with the track
        carry, the losses summed over the decoder layers and averaged over
        the frames. ``qim_draws`` holds each frame's (u_drop, u_fp); else
        they are drawn from ``generator``. Returns (loss, the terms and
        ``num_matched``, each frame's matcher and QIM decisions)."""
        t_frames = imgs_seq.shape[0]
        dev = self.query_embedding.weight.device
        tracks = self.fresh_tracks()
        prev_bev = torch.zeros(1, self.bev_h * self.bev_w, self.embed_dims,
                               device=dev)
        has_prev = torch.zeros((), dtype=torch.bool, device=dev)
        total = {"loss_cls": 0.0, "loss_bbox": 0.0, "loss_past_trajs": 0.0}
        num_matched = 0
        decisions = []
        for t in range(t_frames):
            gt_t = {k: v[t] for k, v in gt_clip.items()}
            dt_next = (timestamps[t + 1] - timestamps[t]
                       if t + 1 < t_frames else torch.zeros((), device=dev))
            if qim_draws is not None:
                draws = qim_draws[t]
            else:
                draws = torch.rand(2, self.num_query, generator=generator,
                                   device=dev).unbind(0)
            tracks, prev_bev, losses, aux = self.train_frame(
                imgs_seq[t], lidar2img, tracks, prev_bev, has_prev, gt_t,
                dt_next, draws)
            has_prev = torch.ones_like(has_prev)
            for k in total:
                total[k] = total[k] + losses[k]
            num_matched = num_matched + aux["num_matched"]
            decisions.append({k: aux[k] for k in ("assigned", "matched",
                                                  "keep")})
        for k in total:
            total[k] = total[k] / t_frames
        loss = (total["loss_cls"] + total["loss_bbox"]
                + total["loss_past_trajs"])
        total["loss_total"] = loss
        total["num_matched"] = num_matched
        return loss, total, decisions


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights: :func:`sndepth_tpu_torch.ops.layers.init_weights`
    (LeCun normal, biases 0, norms at identity; the deformable offsets and
    the DCN offset convolutions too, so the taps spread), every embedding
    and the camera and level embeddings standard normal, each DCN kernel
    LeCun normal, frozen BatchNorms at identity."""
    layers.init_weights(model, generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, DeformConv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=generator)
            elif isinstance(m, ChannelAffine):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0 - m.eps)
            for name in ("level_embeds", "cams_embeds"):
                p = getattr(m, name, None)
                if isinstance(p, nn.Parameter):
                    p.normal_(0.0, 1.0, generator=generator)


# spread_offsets's spread of the taps (pixels).
SPREAD_PIXELS = 3.0


def spread_offsets(model: nn.Module, forward,
                   generator: torch.Generator) -> None:
    """Make seeded weights behave as a trained model's where it matters for
    the sampling. Rescale every deformable sampling-offset layer and DCN
    offset convolution so that its outputs spread ``SPREAD_PIXELS`` (their
    standard deviation, measured in one ``forward()``) with biases normal at
    half that: the taps then land several pixels from their reference
    points, some outside the image (JAX's initialisation puts them all on
    the reference points)."""
    from sndepth_tpu_torch.models.deformable import (
        CustomMSDeformableAttention, MSDeformableAttention3D,
        TemporalSelfAttention)
    layers_ = []
    for m in model.modules():
        if isinstance(m, (MSDeformableAttention3D, TemporalSelfAttention,
                          CustomMSDeformableAttention)):
            layers_.append(m.sampling_offsets)
        elif isinstance(m, DeformConv2d):
            layers_.append(m.conv_offset)
    stds = {}

    def hook(mod, args, out):
        if mod not in stds:
            n = 2 * 9 if isinstance(mod, nn.Conv2d) else out.shape[-1]
            part = out[:, :n] if isinstance(mod, nn.Conv2d) else out
            stds[mod] = float(part.float().std())

    handles = [m.register_forward_hook(hook) for m in layers_]
    try:
        with torch.no_grad():
            forward()
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        for m in layers_:
            m.weight.mul_(SPREAD_PIXELS / max(stds[m], 1e-6))
            m.bias.copy_(torch.randn(m.bias.shape, generator=generator)
                         * (SPREAD_PIXELS / 2))
