"""Track runtime state: fixed-capacity instances, the tracker's lifecycle,
the memory bank and the query interaction module.

Counterpart of ``sndepth_tpu/models/track_runtime.py`` (reference
`models/track_head_plugin/`):

* :class:`TrackInstances`: a dataclass of tensors, one slot a query, with
  ``obj_idxes`` -1 on a free slot; updates are masked, never boolean
  surgery on the slots;
* :func:`tracker_update`: births above ``score_thresh`` numbered in slot
  order, deaths after ``miss_tolerance`` frames under
  ``filter_score_thresh``, and the optional rotated-IoU suppression of
  newborns;
* :class:`MemoryBank`: the per-slot embedding FIFO fused by attention, its
  saves on a 3-frame cooldown at inference and on every scoring frame in
  training (``train=True``);
* :func:`qim_select_train`: the trainer's slot selection (random drop,
  false positives injected among the best inactive slots), its uniform
  draws as arguments;
* :class:`QueryInteractionModule`: self-attention and FFNs refreshing the
  queries of selected slots.

Module names are the reference's (``temporal_attn``, ``save_proj``,
``self_attn``, ``linear_pos1`` ...). Attention masks fill with the dtype's
most negative value, as flax does: a slot with no valid history attends
uniformly and its output is then discarded, so no NaN reaches a gradient.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.ops.layers import Dense, LayerNorm, MultiheadAttention


@dataclasses.dataclass
class TrackInstances:
    """Fixed-capacity per-query track state (capacity = the query count)."""
    ref_pts: torch.Tensor           # (N, 3) sigmoid-space reference points
    query: torch.Tensor             # (N, 2C) [query_pos | query_feat]
    output_embedding: torch.Tensor  # (N, C) the last decoder output
    obj_idxes: torch.Tensor         # (N,) int32, -1 = unassigned
    scores: torch.Tensor            # (N,)
    track_scores: torch.Tensor      # (N,)
    pred_logits: torch.Tensor       # (N, num_classes)
    pred_boxes: torch.Tensor        # (N, 10)
    disappear_time: torch.Tensor    # (N,) int32
    mem_bank: torch.Tensor          # (N, mem_len, C)
    mem_valid: torch.Tensor         # (N, mem_len) bool
    save_period: torch.Tensor       # (N,) int32 save cooldown
    iou: torch.Tensor               # (N,) matched-GT IoU (training)

    def replace(self, **changes) -> "TrackInstances":
        return dataclasses.replace(self, **changes)

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def to(self, device) -> "TrackInstances":
        return TrackInstances(**{k: v.to(device)
                                 for k, v in self.tensors().items()})


def empty_tracks(num_query: int, embed_dims: int, num_classes: int = 10,
                 mem_len: int = 4, query_init=None, ref_init=None,
                 device=None) -> TrackInstances:
    """Free slots; ``query_init`` and ``ref_init`` give the learned query
    and reference points (else zeros)."""
    n, c = num_query, embed_dims
    z = lambda *shape, dtype=torch.float32: torch.zeros(
        *shape, dtype=dtype, device=device)
    return TrackInstances(
        ref_pts=ref_init if ref_init is not None else z(n, 3),
        query=query_init if query_init is not None else z(n, 2 * c),
        output_embedding=z(n, c),
        obj_idxes=torch.full((n,), -1, dtype=torch.int32, device=device),
        scores=z(n), track_scores=z(n), pred_logits=z(n, num_classes),
        pred_boxes=z(n, 10), disappear_time=z(n, dtype=torch.int32),
        mem_bank=z(n, mem_len, c), mem_valid=z(n, mem_len, dtype=torch.bool),
        save_period=z(n, dtype=torch.int32), iou=z(n))


def tracker_update(tracks: TrackInstances, score_thresh: float = 0.4,
                   filter_score_thresh: float = 0.35,
                   miss_tolerance: int = 5, next_obj_id=None,
                   dedup_iou_threshold: float | None = None):
    """RuntimeTrackerBase.update, masked. Returns (tracks, next_obj_id)."""
    scores = tracks.track_scores
    if next_obj_id is None:
        next_obj_id = torch.zeros((), dtype=torch.int32, device=scores.device)
    assigned = tracks.obj_idxes >= 0
    low = assigned & (scores < filter_score_thresh)
    disappear = torch.where(low, tracks.disappear_time + 1,
                            torch.zeros_like(tracks.disappear_time))
    dead = disappear >= miss_tolerance
    obj_idxes = torch.where(dead, torch.full_like(tracks.obj_idxes, -1),
                            tracks.obj_idxes)
    disappear = torch.where(dead, torch.zeros_like(disappear), disappear)

    newborn = ~assigned & (scores >= score_thresh)
    if dedup_iou_threshold is not None:
        from sndepth_tpu_torch.ops.box_iou import rotated_bev_iou
        from sndepth_tpu_torch.utils.uniad import denormalize_bbox
        boxes = denormalize_bbox(tracks.pred_boxes)
        bev = boxes[:, [0, 1, 3, 4, 6]]
        iou = rotated_bev_iou(bev, bev)
        alive = (obj_idxes >= 0).to(iou.dtype)
        max_overlap = (iou * alive[None, :]).amax(1)
        newborn = newborn & (max_overlap < dedup_iou_threshold)
    born = newborn.to(torch.int32)
    birth_rank = torch.cumsum(born, 0, dtype=torch.int32) - 1
    obj_idxes = torch.where(newborn, next_obj_id + birth_rank, obj_idxes)
    next_obj_id = next_obj_id + born.sum(dtype=torch.int32)
    return tracks.replace(obj_idxes=obj_idxes.to(torch.int32),
                          disappear_time=disappear), next_obj_id


def active_mask(tracks: TrackInstances,
                filter_score_thresh: float = 0.35) -> torch.Tensor:
    """Slots carried to the next frame: assigned, and scoring now or not
    yet timed out."""
    return (tracks.obj_idxes >= 0) & (
        (tracks.track_scores >= filter_score_thresh)
        | (tracks.disappear_time > 0))


def velocity_update_reference_points(tracks: TrackInstances, velocity_xy,
                                     dt, pc_range) -> TrackInstances:
    """Move the assigned slots' reference points by their box velocity over
    ``dt`` seconds, in sigmoid grid space."""
    x0, y0, _, x1, y1, _ = pc_range
    ref = tracks.ref_pts
    wx = ref[:, 0] * (x1 - x0) + x0 + velocity_xy[:, 0] * dt
    wy = ref[:, 1] * (y1 - y0) + y0 + velocity_xy[:, 1] * dt
    new_ref = torch.stack([(wx - x0) / (x1 - x0), (wy - y0) / (y1 - y0),
                           ref[:, 2]], -1)
    use = (tracks.obj_idxes >= 0)[:, None]
    return tracks.replace(ref_pts=torch.where(use, new_ref, ref))


class MemoryBank(nn.Module):
    """Temporal embedding FIFO and its attention fusion: ``temporal_attn``
    of the embedding over the slot's history, residual and
    ``temporal_norm1``, the ``temporal_fc1`` / ``temporal_fc2`` FFN,
    residual and ``temporal_norm2``, kept where the newest entry is valid;
    the embedding pushed through ``save_proj``."""

    def __init__(self, embed_dims: int = 256, mem_len: int = 4,
                 save_thresh: float = 0.0, dtype: torch.dtype = torch.float32,
                 train: bool = False):
        super().__init__()
        self.mem_len, self.save_thresh, self.train_mode = (mem_len,
                                                           save_thresh, train)
        c = embed_dims
        self.save_proj = Dense(c, c, dtype=dtype)
        self.temporal_attn = MultiheadAttention(c, 8, dtype)
        self.temporal_fc1 = Dense(c, c, dtype=dtype)
        self.temporal_fc2 = Dense(c, c, dtype=dtype)
        self.temporal_norm1 = LayerNorm(c, dtype=dtype)
        self.temporal_norm2 = LayerNorm(c, dtype=dtype)

    def forward(self, tracks: TrackInstances) -> TrackInstances:
        emb, bank, valid = (tracks.output_embedding, tracks.mem_bank,
                            tracks.mem_valid)
        attn = self.temporal_attn(emb[:, None, :], bank, bank,
                                  mask=valid[:, None, None, :])
        fused = self.temporal_norm1(emb + attn[:, 0])
        ff = self.temporal_fc2(F.relu(self.temporal_fc1(fused)))
        fused = self.temporal_norm2(fused + ff)
        fused = torch.where(valid[:, -1:], fused, emb)
        if self.train_mode:
            save = tracks.scores > 0.0
            period = tracks.save_period
        else:
            save = (tracks.save_period == 0) & (tracks.scores
                                                > self.save_thresh)
            period = torch.clamp(tracks.save_period - 1, min=0)
            period = torch.where(save, torch.full_like(period, 3), period)
        saved = self.save_proj(fused)
        new_bank = torch.cat([bank[:, 1:], saved[:, None].to(bank.dtype)], 1)
        new_valid = torch.cat([valid[:, 1:],
                               torch.ones_like(valid[:, :1])], 1)
        bank = torch.where(save[:, None, None], new_bank, bank)
        valid = torch.where(save[:, None], new_valid, valid)
        return tracks.replace(output_embedding=fused, mem_bank=bank,
                              mem_valid=valid, save_period=period)


def qim_select_train(tracks: TrackInstances, u_drop: torch.Tensor,
                     u_fp: torch.Tensor, random_drop: float = 0.1,
                     fp_ratio: float = 0.3,
                     iou_thresh: float = 0.5) -> torch.Tensor:
    """The trainer's slot selection, given (N,) uniform draws ``u_drop``
    and ``u_fp`` in [0, 1): the slots bound to a GT above ``iou_thresh``
    are kept where ``u_drop > random_drop``; then as many of the best
    scoring inactive slots as kept slots with ``u_fp < fp_ratio`` join as
    false positives. Returns the (N,) bool mask of slots carried on."""
    n = tracks.obj_idxes.shape[0]
    active = (tracks.obj_idxes >= 0) & (tracks.iou > iou_thresh)
    kept_active = active & (u_drop > random_drop)
    num_fp = (kept_active & (u_fp < fp_ratio)).sum()
    inactive = tracks.obj_idxes < 0
    scores = torch.where(inactive, tracks.scores,
                         torch.full_like(tracks.scores, float("-inf")))
    order = torch.argsort(-scores, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    return kept_active | (inactive & (rank < num_fp))


class QueryInteractionModule(nn.Module):
    """MOTR's QIM: self-attention with q = k = query_pos + embedding over
    the embeddings of the masked slots, FFN, then FFNs updating the feature
    half of the query and, with ``update_query_pos``, the position half, on
    the slots of ``update_mask`` (the assigned ones by default)."""

    def __init__(self, embed_dims: int = 256, update_query_pos: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = embed_dims
        self.embed_dims, self.update_query_pos = c, update_query_pos
        self.self_attn = MultiheadAttention(c, 8, dtype)
        self.linear1 = Dense(c, c, dtype=dtype)
        self.linear2 = Dense(c, c, dtype=dtype)
        self.norm1 = LayerNorm(c, dtype=dtype)
        self.norm2 = LayerNorm(c, dtype=dtype)
        if update_query_pos:
            self.linear_pos1 = Dense(c, c, dtype=dtype)
            self.linear_pos2 = Dense(c, c, dtype=dtype)
            self.norm_pos = LayerNorm(c, dtype=dtype)
        self.linear_feat1 = Dense(c, c, dtype=dtype)
        self.linear_feat2 = Dense(c, c, dtype=dtype)
        self.norm_feat = LayerNorm(c, dtype=dtype)

    def forward(self, tracks: TrackInstances,
                update_mask: torch.Tensor | None = None) -> TrackInstances:
        c = self.embed_dims
        if update_mask is None:
            update_mask = tracks.obj_idxes >= 0
        emb = tracks.output_embedding
        query_pos, query_feat = tracks.query[:, :c], tracks.query[:, c:]
        qk = (query_pos + emb)[None]
        attn = self.self_attn(qk, qk, emb[None],
                              mask=update_mask[None, None, None, :])
        tgt = self.norm1(emb[None] + attn)
        tgt = self.norm2(tgt + self.linear2(F.relu(self.linear1(tgt))))[0]
        um = update_mask[:, None]
        if self.update_query_pos:
            pos2 = self.linear_pos2(F.relu(self.linear_pos1(tgt)))
            query_pos = torch.where(um, self.norm_pos(query_pos + pos2),
                                    query_pos)
        feat2 = self.linear_feat2(F.relu(self.linear_feat1(tgt)))
        query_feat = torch.where(um, self.norm_feat(query_feat + feat2),
                                 query_feat)
        return tracks.replace(query=torch.cat([query_pos, query_feat], -1))
