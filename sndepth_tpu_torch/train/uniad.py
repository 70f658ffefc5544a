"""UniAD tracker training (PyTorch).

Counterpart of ``sndepth_tpu/train/uniad.py`` (reference
`track_uniad.py` ``forward_track_train`` with the ClipMatcher): the clip's
forward frame by frame with the track carry (``UniADTrack.train_clip``),
every decoder layer's focal, L1 and past-trajectory losses, and one update:
the JAX step's ``optax.apply_if_finite(optax.chain(clip_by_global_norm(35),
adamw(2e-4, weight_decay=0.01)), max_consecutive_errors=100)`` written out
as the port's other trainers write it. The gradients' global norm is
clipped to 35; ``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8 outside
the root, the decay decoupled and times the rate, on every parameter)
applies the update; a step whose loss or gradient is not finite is skipped
and counted, and more than 100 in a row raise.

The QIM's uniform draws come from the state's generator, on the model's
device, unless a caller hands them in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sndepth_tpu_torch.models.uniad_track import UniADTrack
from sndepth_tpu_torch.train.raft3d import (MAX_CONSECUTIVE_SKIPS,
                                            clip_by_global_norm_)

LR, WEIGHT_DECAY, CLIP_NORM = 2e-4, 0.01, 35.0


def synthetic_clip(model: UniADTrack, t_frames: int = 3, ng: int = 4,
                   img_hw: tuple[int, int] = (64, 64), steps: int = 8,
                   seed: int = 0) -> dict:
    """The JAX package's drifting-boxes clip, the same numbers from
    ``numpy.random.RandomState(seed)``: ``imgs_seq`` (T, cams, 1, 3, H, W),
    the identity ``lidar2img``, per-frame ``gt`` and ``timestamps``; CPU
    tensors."""
    rng = np.random.RandomState(seed)
    h, w = img_hw
    cams = model.num_cams
    imgs = rng.rand(t_frames, cams, 1, h, w, 3).astype("float32")
    lidar2img = np.tile(np.eye(4, dtype="float32")[None, None],
                        (1, cams, 1, 1))
    boxes = rng.randn(t_frames, ng, 10).astype("float32") * 0.5
    labels = rng.randint(0, model.num_classes, (t_frames, ng))
    past = rng.randn(t_frames, ng, steps, 2).astype("float32")
    sdc_box = rng.randn(t_frames, 10).astype("float32") * 0.1
    t = torch.from_numpy
    gt = {"labels": t(labels), "boxes": t(boxes),
          "valid": torch.ones(t_frames, ng, dtype=torch.bool),
          "instance_ids": torch.arange(ng).repeat(t_frames, 1),
          "past_traj": t(past),
          "past_traj_mask": torch.ones(t_frames, ng, steps, 2),
          "sdc_label": torch.zeros(t_frames, dtype=torch.long),
          "sdc_box": t(sdc_box)}
    return {"imgs_seq": t(np.ascontiguousarray(imgs.transpose(
                0, 1, 2, 5, 3, 4))),
            "lidar2img": t(lidar2img), "gt": gt,
            "timestamps": torch.arange(t_frames, dtype=torch.float32) * 0.5}


def _moved_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Normalised boxes (N, 10) moved by 2% in every component: the centre
    by 2% of the smaller side in x and y and of the height in z, the log
    sizes and the velocity by 0.02, (sin, cos) scaled by 1.02 (the angle
    unchanged). An IoU near 0.9 with the boxes, and no component so close
    that float rounding decides the sign of an L1 gradient."""
    side = torch.exp(torch.minimum(boxes[:, 2], boxes[:, 3]))
    height = torch.exp(boxes[:, 5])
    one = torch.ones_like(side)
    scale = torch.stack([side, side, one, one, height, one, boxes[:, 6],
                         boxes[:, 7], one, one], -1)
    return boxes + 0.02 * scale


def clip_with_gts_on_detections(model: UniADTrack, clip: dict, qim_draws,
                                n: int = 2) -> dict:
    """A copy of ``clip`` whose GTs sit on ``model``'s own detections, so
    that the QIM keeps slots (a synthetic clip binds none at an IoU above
    its threshold) and the frames after the first train the QIM and the
    memory bank. In the first frame the first ``n`` GTs take the boxes of
    the last decoder layer's ``n`` best-scoring queries (the ego slot left
    out) and their best classes; in each later frame a GT takes the box of
    the slot its instance is bound to, moved by 2% in every component
    (:func:`_moved_boxes`). The model runs the clip
    frame by frame without gradients, with the QIM draws ``qim_draws`` that
    the train step is to use."""
    gt = {k: v.clone() for k, v in clip["gt"].items()}
    imgs, l2i = clip["imgs_seq"], clip["lidar2img"]
    t_frames = imgs.shape[0]
    tracks = model.fresh_tracks()
    dev = tracks.query.device
    prev = torch.zeros(1, model.bev_h * model.bev_w, model.embed_dims,
                       device=dev)
    has_prev = torch.zeros((), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for t in range(t_frames):
            bev = model.get_bevs(imgs[t], l2i,
                                 prev_bev=has_prev.float() * prev)
            det = model.pts_bbox_head.get_detections(bev, tracks.query[None],
                                                     tracks.ref_pts[None])
            logits = det["all_cls_scores"][-1, 0]
            boxes = _moved_boxes(det["all_bbox_preds"][-1, 0])
            if t == 0:
                slots = torch.argsort(-logits[:-1].amax(-1), stable=True)[:n]
                gts = torch.arange(n, device=dev)
            else:
                bound = (tracks.obj_idxes[:, None]
                         == gt["instance_ids"][t][None].to(dev))
                slots, gts = torch.nonzero(bound, as_tuple=True)
            gt["boxes"][t, gts] = boxes[slots].to(gt["boxes"])
            gt["labels"][t, gts] = logits[slots].argmax(-1).to(gt["labels"])
            dt_next = (clip["timestamps"][t + 1] - clip["timestamps"][t]
                       if t + 1 < t_frames else torch.zeros((), device=dev))
            tracks, prev, _, _ = model.train_frame(
                imgs[t], l2i, tracks, prev, has_prev,
                {k: v[t] for k, v in gt.items()}, dt_next, qim_draws[t])
            has_prev = torch.ones_like(has_prev)
    return {**clip, "gt": gt}


def clip_to(clip: dict, device) -> dict:
    """The clip's tensors on ``device``."""
    return {k: ({kk: vv.to(device) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in clip.items()}


def make_optimizer(params, lr: float = LR,
                   weight_decay: float = WEIGHT_DECAY) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class UniADTrainState:
    """Model, optimizer, the QIM draws' generator and the counters;
    :func:`train_step` updates it in place. ``step`` counts the applied
    updates, ``calls`` every call; ``decisions`` holds the last step's
    matcher and QIM decisions a frame."""
    model: UniADTrack
    optimizer: torch.optim.AdamW
    generator: torch.Generator
    step: int = 0
    notfinite_count: int = 0
    calls: int = 0
    decisions: list = dataclasses.field(default_factory=list)


def create_train_state(model: UniADTrack, device="cuda", lr: float = LR,
                       seed: int = 0) -> UniADTrainState:
    model = model.to(device).train()
    generator = torch.Generator(torch.device(device)).manual_seed(seed)
    return UniADTrainState(model, make_optimizer(model.parameters(), lr),
                           generator)


def train_step(state: UniADTrainState, clip: dict, qim_draws=None) -> dict:
    """One update on ``clip`` (tensors on the model's device); ``qim_draws``
    hands each frame's (u_drop, u_fp) in. Returns the loss terms,
    ``num_matched`` and ``grad_norm``, detached."""
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]
    state.optimizer.zero_grad(set_to_none=True)
    loss, terms, state.decisions = model.train_clip(
        clip["imgs_seq"], clip["lidar2img"], clip["gt"], clip["timestamps"],
        qim_draws=qim_draws, generator=state.generator)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = clip_by_global_norm_([p.grad for p in params], CLIP_NORM)
    state.calls += 1
    if bool(torch.isfinite(loss) & torch.isfinite(norm)):
        state.optimizer.step()
        state.step += 1
        state.notfinite_count = 0
    else:
        state.notfinite_count += 1
        if state.notfinite_count > MAX_CONSECUTIVE_SKIPS:
            raise FloatingPointError(
                f"{state.notfinite_count} consecutive non-finite steps")
    out = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in terms.items()}
    out["grad_norm"] = norm
    return out
