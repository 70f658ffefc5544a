"""Rotated BEV and 3-D box IoU with static shapes.

Counterpart of ``sndepth_tpu/ops/box_iou.py`` (the reference's optional
mmdet3d ``iou3d`` duplicate suppression and the matched-pair IoU of the
track trainer). The intersection of two rotated rectangles: candidate
points are the corners of each inside the other and the 16 edge-edge
intersections (24 slots, masked), sorted by angle around their centroid,
the area by the shoelace formula over the valid prefix. Every pair of an
(N, M) grid at once, by broadcasting.
"""

from __future__ import annotations

import torch


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [cx, cy, w, l, rot] -> (..., 4, 2) corners (ccw)."""
    cx, cy, w, l, r = boxes.unbind(-1)
    cos, sin = torch.cos(r), torch.sin(r)
    dx = torch.stack([w, w, -w, -w], -1) * 0.5
    dy = torch.stack([l, -l, -l, l], -1) * 0.5
    x = cx[..., None] + dx * cos[..., None] - dy * sin[..., None]
    y = cy[..., None] + dx * sin[..., None] + dy * cos[..., None]
    return torch.stack([x, y], -1)


def _point_in_rect(points: torch.Tensor, corners: torch.Tensor):
    """points (..., P, 2) inside the convex quads (..., 4, 2)."""
    edge = torch.roll(corners, -1, -2) - corners                # ..., 4, 2
    rel = points[..., :, None, :] - corners[..., None, :, :]    # ..., P, 4, 2
    cross = (edge[..., None, :, 0] * rel[..., 1]
             - edge[..., None, :, 1] * rel[..., 0])
    return (cross >= -1e-7).all(-1) | (cross <= 1e-7).all(-1)


def _segment_intersections(c1: torch.Tensor, c2: torch.Tensor):
    """The 16 edge-edge intersections of two quads (..., 4, 2) each, edge i
    of the first against edge j of the second at 4 i + j."""
    r = torch.roll(c1, -1, -2) - c1
    s = torch.roll(c2, -1, -2) - c2
    pi = c1.repeat_interleave(4, -2)
    ri = r.repeat_interleave(4, -2)
    qi = c2.repeat((1,) * (c2.dim() - 2) + (4, 1))
    si = s.repeat((1,) * (s.dim() - 2) + (4, 1))
    denom = ri[..., 0] * si[..., 1] - ri[..., 1] * si[..., 0]
    small = denom.abs() < 1e-10
    safe = torch.where(small, torch.ones_like(denom), denom)
    qp = qi - pi
    t = (qp[..., 0] * si[..., 1] - qp[..., 1] * si[..., 0]) / safe
    u = (qp[..., 0] * ri[..., 1] - qp[..., 1] * ri[..., 0]) / safe
    valid = ~small & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    return pi + t[..., None] * ri, valid


def _polygon_area(points: torch.Tensor, valid: torch.Tensor):
    """Area of the convex polygon of the valid points (..., n, 2): angle
    sort about their centroid, then the shoelace formula."""
    count = valid.sum(-1)
    vf = valid.to(points.dtype)
    centroid = (points * vf[..., None]).sum(-2) / torch.clamp(
        count, min=1)[..., None].to(points.dtype)
    rel = points - centroid[..., None, :]
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 1e9))
    order = torch.argsort(ang, dim=-1, stable=True)
    pts = torch.gather(points, -2, order[..., None].expand_as(points))
    n = points.shape[-2]
    idx = torch.arange(n, device=points.device)
    nxt = torch.where(idx + 1 < count[..., None], idx + 1,
                      torch.zeros_like(idx))
    p_n = torch.gather(pts, -2, nxt[..., None].expand_as(pts))
    c = centroid[..., None, :]
    cross = ((pts[..., 0] - c[..., 0]) * (p_n[..., 1] - c[..., 1])
             - (p_n[..., 0] - c[..., 0]) * (pts[..., 1] - c[..., 1]))
    cross = torch.where(idx < count[..., None], cross,
                        torch.zeros_like(cross))
    return cross.sum(-1).abs() * 0.5


def _intersection_area(box1: torch.Tensor, box2: torch.Tensor):
    """Overlap area of boxes (..., 5) and (..., 5), broadcast together."""
    c1 = box_corners(box1)
    c2 = box_corners(box2)
    c1, c2 = torch.broadcast_tensors(c1, c2)
    inter_pts, inter_valid = _segment_intersections(c1, c2)
    points = torch.cat([c1, c2, inter_pts], -2)                 # ..., 24, 2
    valid = torch.cat([_point_in_rect(c1, c2), _point_in_rect(c2, c1),
                       inter_valid], -1)
    area = _polygon_area(points, valid)
    return torch.where(valid.sum(-1) >= 3, area, torch.zeros_like(area))


def rotated_bev_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """(N, 5) x (M, 5) [cx, cy, w, l, rot] -> (N, M) IoU."""
    inter = _intersection_area(boxes1[:, None], boxes2[None, :])
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    return inter / torch.clamp(a1 + a2 - inter, min=1e-7)


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) [cx, cy, cz, w, l, h, rot] -> (N, M) 3-D IoU."""
    cols = [0, 1, 3, 4, 6]
    bev1, bev2 = boxes1[:, cols], boxes2[:, cols]
    inter_bev = rotated_bev_iou(bev1, bev2)
    a1 = (bev1[:, 2] * bev1[:, 3])[:, None]
    a2 = (bev2[:, 2] * bev2[:, 3])[None, :]
    inter_area = inter_bev * (a1 + a2) / (1.0 + inter_bev)
    z1_lo = boxes1[:, 2] - boxes1[:, 5] / 2
    z1_hi = boxes1[:, 2] + boxes1[:, 5] / 2
    z2_lo = boxes2[:, 2] - boxes2[:, 5] / 2
    z2_hi = boxes2[:, 2] + boxes2[:, 5] / 2
    overlap_z = torch.clamp(
        torch.minimum(z1_hi[:, None], z2_hi[None, :])
        - torch.maximum(z1_lo[:, None], z2_lo[None, :]), min=0.0)
    inter_vol = inter_area * overlap_z
    v1 = (boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None]
    v2 = (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :]
    return inter_vol / torch.clamp(v1 + v2 - inter_vol, min=1e-7)
