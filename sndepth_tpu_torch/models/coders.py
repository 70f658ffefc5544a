"""NMS-free box decoding: top-k over the class scores.

Counterpart of ``sndepth_tpu/models/coders.py`` (reference
`nms_free_coder.py`, `detr3d_track_coder.py`): fixed-size outputs with a
``valid`` mask. The top k is a stable descending sort, so that ties go to
the lower index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises
no order among ties).
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.utils.uniad import denormalize_bbox


def _top_k(x: torch.Tensor, k: int):
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def nms_free_decode(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                    max_num: int = 100, score_threshold: float | None = None,
                    post_center_range=None, obj_idxes=None,
                    track_scores=None) -> dict:
    """cls_scores (nq, num_classes) logits; bbox_preds (nq, 10). With
    ``track_scores`` the track scores pick the queries (DETRTrack3DCoder)
    and ``obj_idxes`` pass through. Returns {bboxes (k, 9), scores, labels,
    valid, query_idx[, obj_idxes]}."""
    nq, num_classes = cls_scores.shape
    probs = torch.sigmoid(cls_scores)
    if track_scores is None:
        flat = probs.reshape(-1)
        scores, idx = _top_k(flat, min(max_num, flat.shape[0]))
        query_idx = torch.div(idx, num_classes, rounding_mode="floor")
        labels = idx % num_classes
    else:
        scores, query_idx = _top_k(track_scores, min(max_num, nq))
        labels = torch.argmax(probs[query_idx], -1)
    boxes = denormalize_bbox(bbox_preds[query_idx])
    valid = torch.ones(scores.shape[0], dtype=torch.bool,
                       device=scores.device)
    if score_threshold is not None:
        valid &= scores > score_threshold
    if post_center_range is not None:
        rng = torch.as_tensor(post_center_range, dtype=boxes.dtype,
                              device=boxes.device)
        centers = boxes[..., :3]
        valid &= (centers >= rng[:3]).all(-1) & (centers <= rng[3:]).all(-1)
    out = {"bboxes": boxes, "scores": scores, "labels": labels,
           "valid": valid, "query_idx": query_idx}
    if obj_idxes is not None:
        out["obj_idxes"] = obj_idxes[query_idx]
    return out
