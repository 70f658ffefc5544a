"""Track losses: focal classification, L1 boxes, the assignment and the
ClipMatcher.

Counterpart of ``sndepth_tpu/losses/track_loss.py`` (reference
`register_module/track_loss.py`, `hungarian_assigner_3d_track.py`,
`match_cost.py`): the focal loss (gamma 2, alpha 0.25) and code-weighted L1
over normalised boxes; the assignment cost (focal classification cost plus
L1 box cost) solved by the auction of :mod:`sndepth_tpu_torch.losses.lap`
(the JAX default); the per-frame matcher with tracked objects pinned to
their slots, every decoder layer matched against its own predictions, and
the past-trajectory loss.

Scatters with repeated indices keep the last write, as XLA's do: the
unmatched GTs all point at slot 0, and where one of them comes after a
real write there, JAX keeps its value (:func:`scatter_last`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sndepth_tpu_torch.losses.lap import auction_lap
from sndepth_tpu_torch.models.deformable import _constant

# mmdet's code_weights on the 10-dim track box [cx, cy, w, l, cz, h, sin,
# cos, vx, vy]: the velocities down-weighted.
CODE_WEIGHTS_10 = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)


def scatter_last(base: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``base`` with ``base[idx[i]] = values[i]`` done in order of i: where
    an index repeats, the last write stays (``.at[idx].set`` under XLA)."""
    order = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((base.shape[0],), -1, dtype=order.dtype,
                      device=idx.device).scatter_reduce(
        0, idx.long(), order, reduce="amax")
    written = last >= 0
    out = base.clone()
    out[written] = values[last[written]].to(base.dtype)
    return out


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax ``sigmoid_binary_cross_entropy``'s form."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss; targets in {0, 1}, shaped as the logits."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def focal_cls_cost(logits, gt_labels, alpha: float = 0.25,
                   gamma: float = 2.0) -> torch.Tensor:
    """(nq, C) logits and (ng,) labels -> (nq, ng) FocalLossCost."""
    p = torch.sigmoid(logits)
    eps = 1e-12
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * (p ** gamma)
    pos_cost = -torch.log(p + eps) * alpha * ((1 - p) ** gamma)
    return (pos_cost - neg_cost)[:, gt_labels.long()]


def l1_bbox_cost(pred_boxes, gt_boxes) -> torch.Tensor:
    """(nq, D) and (ng, D) -> (nq, ng) L1 cost."""
    return (pred_boxes[:, None, :] - gt_boxes[None, :, :]).abs().sum(-1)


def hungarian_match(cost: torch.Tensor, valid_cols: torch.Tensor):
    """The assignment of a fixed-size cost (nq, ng): (rows, cols), each
    (ng,), the query of each valid GT column and the column itself, -1
    elsewhere. No gradient goes through it."""
    rows = auction_lap(cost.detach(), valid_cols.detach())
    cols = torch.where(rows >= 0, torch.arange(
        cost.shape[1], dtype=torch.int32, device=cost.device),
        torch.full_like(rows, -1))
    return rows, cols


def match_frame(logits, boxes, gt_labels, gt_boxes, gt_valid,
                pinned_query=None, cls_weight: float = 2.0,
                bbox_weight: float = 0.25, exclude_query=None):
    """Assign GTs to queries: GT g pinned to slot ``pinned_query[g]`` >= 0,
    the others by the auction over the slots neither pinned nor in
    ``exclude_query``. Returns (the query of each GT (ng,), matched (ng,))."""
    nq, ng = logits.shape[0], gt_labels.shape[0]
    cost = (cls_weight * focal_cls_cost(logits, gt_labels)
            + bbox_weight * l1_bbox_cost(boxes, gt_boxes))
    if pinned_query is None:
        pinned_query = torch.full((ng,), -1, dtype=torch.int32,
                                  device=logits.device)
    pinned_mask_q = scatter_last(
        torch.zeros(nq, dtype=torch.bool, device=logits.device),
        torch.clamp(pinned_query, 0, nq - 1), pinned_query >= 0)
    if exclude_query is not None:
        pinned_mask_q = pinned_mask_q | exclude_query
    cost = torch.where(pinned_mask_q[:, None], torch.full_like(cost, 1e9),
                       cost)
    rows, _ = hungarian_match(cost, gt_valid & (pinned_query < 0))
    assigned = torch.where(pinned_query >= 0, pinned_query.to(torch.int32),
                           rows)
    return assigned, gt_valid & (assigned >= 0)


def frame_losses(logits, boxes, gt_labels, gt_boxes, gt_valid, assigned,
                 matched, num_classes: int, num_boxes=None,
                 cls_weight: float = 1.0, bbox_weight: float = 1.0,
                 code_weights=None, sdc_slot: int | None = None,
                 sdc_label=None, sdc_box=None) -> dict:
    """Focal classification over all queries and code-weighted L1 over the
    matched pairs, each over ``num_boxes``; the ego query's extra terms
    against ``sdc_label`` / ``sdc_box`` where ``sdc_slot`` is set."""
    nq = logits.shape[0]
    if num_boxes is None:
        num_boxes = torch.clamp(matched.float().sum(), min=1.0)
    safe_q = torch.clamp(assigned, 0, nq - 1).long()
    updates = F.one_hot(gt_labels.long(), num_classes).float() * \
        matched[:, None].float()
    onehot = torch.zeros(nq, num_classes, device=logits.device).index_add(
        0, safe_q, updates)
    if sdc_slot is not None and sdc_label is not None:
        onehot[sdc_slot] = F.one_hot(sdc_label.long(), num_classes).float()
    onehot = torch.clamp(onehot, 0.0, 1.0)
    loss_cls = sigmoid_focal_loss(logits, onehot).sum() / num_boxes
    cw = (_constant(tuple(code_weights), boxes.device).to(boxes.dtype)
          if code_weights is not None
          else torch.ones(boxes.shape[-1], dtype=boxes.dtype,
                          device=boxes.device))
    l1 = ((boxes[safe_q] - gt_boxes).abs() * cw).sum(-1) * matched
    loss_bbox = l1.sum()
    if sdc_slot is not None and sdc_box is not None:
        loss_bbox = loss_bbox + ((boxes[sdc_slot] - sdc_box).abs() * cw).sum()
    return {"loss_cls": cls_weight * loss_cls,
            "loss_bbox": bbox_weight * (loss_bbox / num_boxes)}


def past_traj_loss(pred_trajs, gt_trajs, gt_traj_mask, assigned,
                   matched) -> torch.Tensor:
    """Masked L1 of the matched queries' past trajectories: sum(|src - tgt|
    mask) / (count(mask > 0) + 1e-5)."""
    nq = pred_trajs.shape[0]
    src = pred_trajs[torch.clamp(assigned, 0, nq - 1).long()]
    m = gt_traj_mask * matched[:, None, None]
    loss = ((src - gt_trajs).abs() * m).sum()
    return loss / ((m > 0).to(loss.dtype).sum() + 1e-5)


def _pinned(obj_idxes, inst):
    """The slot holding each GT's instance id (the first), else -1."""
    same = (obj_idxes[None, :] == inst[:, None]) & (inst[:, None] >= 0)
    return torch.where(same.any(1), same.to(torch.int32).argmax(1),
                       torch.full_like(inst, -1)).to(torch.int32)


def train_frame_layer_losses(layer_logits, layer_boxes, layer_trajs,
                             obj_idxes, gt: dict, num_classes: int,
                             cls_weight: float = 2.0,
                             bbox_weight: float = 0.25,
                             traj_weight: float = 1.0,
                             sdc_slot: int | None = None):
    """One training frame of the ClipMatcher over every decoder layer:
    each layer matched against its own predictions, the pinned slots
    shared; the last layer's matching binds new slots to their GT ids.

    layer_*: (L, nq, ...); obj_idxes (nq,) (-1 free, -2 reserved); gt:
    labels (ng,), boxes (ng, 10), valid (ng,), instance_ids (ng,),
    past_traj and past_traj_mask (ng, steps, 2), optionally sdc_label and
    sdc_box. Returns (losses summed over layers, new obj_idxes, the last
    layer's assigned and matched)."""
    num_layers, nq = layer_logits.shape[:2]
    inst = gt["instance_ids"]
    pinned = _pinned(obj_idxes, inst)
    reserved = obj_idxes != -1
    if sdc_slot is not None:
        reserved = reserved | (torch.arange(nq, device=obj_idxes.device)
                               == sdc_slot)
    bound = obj_idxes >= 0
    present = ((obj_idxes[:, None] == inst[None, :])
               & gt["valid"][None, :]).any(1)
    num_samples = (gt["valid"].float().sum()
                   + (bound & ~present).float().sum())
    nb = torch.clamp(num_samples, min=1.0)

    total = {"loss_cls": 0.0, "loss_bbox": 0.0, "loss_past_trajs": 0.0}
    for li in range(num_layers):
        assigned, matched = match_frame(
            layer_logits[li], layer_boxes[li], gt["labels"], gt["boxes"],
            gt["valid"], pinned, exclude_query=reserved)
        losses = frame_losses(
            layer_logits[li], layer_boxes[li], gt["labels"], gt["boxes"],
            gt["valid"], assigned, matched, num_classes, num_boxes=nb,
            cls_weight=cls_weight, bbox_weight=bbox_weight,
            code_weights=CODE_WEIGHTS_10, sdc_slot=sdc_slot,
            sdc_label=gt.get("sdc_label"), sdc_box=gt.get("sdc_box"))
        losses["loss_past_trajs"] = traj_weight * past_traj_loss(
            layer_trajs[li], gt["past_traj"], gt["past_traj_mask"], assigned,
            matched)
        for k in total:
            total[k] = total[k] + losses[k]

    safe_q = torch.clamp(assigned, 0, nq - 1).long()
    upd = matched & (pinned < 0)
    new_obj = scatter_last(obj_idxes, safe_q,
                           torch.where(upd, inst.to(obj_idxes.dtype),
                                       obj_idxes[safe_q]))
    return total, new_obj, assigned, matched


def clip_matcher_loss(per_frame_outputs: list, per_frame_gt: list,
                      num_classes: int = 10) -> dict:
    """MOTR-style clip loss: each frame matched with the GTs already on a
    slot pinned there. per_frame_outputs[t]: logits (nq, C), boxes (nq,
    10), obj_idxes (nq,); per_frame_gt[t]: labels, boxes, valid,
    instance_ids."""
    total_cls = total_bbox = 0.0
    for out, gt in zip(per_frame_outputs, per_frame_gt):
        pinned = _pinned(out["obj_idxes"], gt["instance_ids"])
        num_boxes = torch.clamp(gt["valid"].float().sum(), min=1.0)
        assigned, matched = match_frame(out["logits"], out["boxes"],
                                        gt["labels"], gt["boxes"],
                                        gt["valid"], pinned)
        losses = frame_losses(out["logits"], out["boxes"], gt["labels"],
                              gt["boxes"], gt["valid"], assigned, matched,
                              num_classes, num_boxes)
        total_cls = total_cls + losses["loss_cls"]
        total_bbox = total_bbox + losses["loss_bbox"]
    n = len(per_frame_outputs)
    return {"loss_cls": total_cls / n, "loss_bbox": total_bbox / n,
            "loss_total": (total_cls + total_bbox) / n}
