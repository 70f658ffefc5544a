"""Surface-normal training loss: the uncertainty-weighted angular NLL.

Counterpart of ``sndepth_tpu/losses/normal_loss.py``:

    L = -log(kappa^2 + 1) + kappa theta + log(1 + exp(-kappa pi))

with theta the angle between the predicted and the true normal, over the
decoder's coarse map and each level's refined points
(:func:`decoder_multi_scale_loss`). Tensors are channel-last, as the
decoder returns them.
"""

from __future__ import annotations

import math

import torch

from sndepth_tpu_torch.models.normal_decoder import gather_points
from sndepth_tpu_torch.ops.resize import resize_bilinear_align_corners

COS_CLIP = 1.0 - 1e-7


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a maximum and a minimum, so that a value exactly at a
    bound passes half its gradient, as JAX's does."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def angular_nll(pred: torch.Tensor, gt: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """pred (..., 4) [unit normal | kappa]; gt (..., 3) unit normals; the
    mean over ``mask``'s weights (plus 1e-8), or over all points. The cosine
    is clipped to +-(1 - 1e-7) before ``arccos``."""
    kappa = pred[..., 3]
    cos = _clip((pred[..., :3] * gt).sum(-1), -COS_CLIP, COS_CLIP)
    loss = (-torch.log(kappa * kappa + 1.0) + kappa * torch.arccos(cos)
            + torch.log(1.0 + torch.exp(-kappa * math.pi)))
    if mask is not None:
        return (loss * mask).sum() / (mask.sum() + 1e-8)
    return loss.mean()


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), bilinear with aligned corners."""
    return resize_bilinear_align_corners(x.permute(0, 3, 1, 2), h, w
                                         ).permute(0, 2, 3, 1)


def _unit(n: torch.Tensor) -> torch.Tensor:
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-8)


def decoder_multi_scale_loss(norm_outs, sampled_preds, sampled_idx,
                             gt_normals: torch.Tensor,
                             gt_mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The mean over the decoder's levels of :func:`angular_nll`: the
    coarse map densely, each finer level on its refined points, against the
    ground truth (B, H, W, 3) resized to the level and renormalised, and
    the mask (B, H, W) resized and taken as ``> 0.5`` at the coarse level,
    as a weight at the others.

    norm_outs[s] (B, h_s, w_s, 4); for s >= 1 either the dense form,
    sampled_preds[s] (B, h_s, w_s, 4) with the selection mask
    sampled_idx[s] (B, h_s, w_s), or the gather form, the points
    (B, N, 4) with their (rows, cols)."""
    coarse = norm_outs[0]
    h, w = coarse.shape[1:3]
    mask_c = None
    if gt_mask is not None:
        mask_c = (_resize(gt_mask.float()[..., None], h, w)[..., 0]
                  > 0.5).float()
    total = angular_nll(coarse, _unit(_resize(gt_normals, h, w)), mask_c)
    for s in range(1, len(norm_outs)):
        if sampled_preds[s] is None or sampled_idx[s] is None:
            continue
        h, w = norm_outs[s].shape[1:3]
        gt_s = _unit(_resize(gt_normals, h, w))
        m = (None if gt_mask is None
             else _resize(gt_mask.float()[..., None], h, w))
        if isinstance(sampled_idx[s], tuple):
            rows, cols = sampled_idx[s]
            total = total + angular_nll(
                sampled_preds[s], gather_points(gt_s, rows, cols),
                None if m is None else gather_points(m, rows, cols)[..., 0])
        else:
            sel = sampled_idx[s] if m is None else sampled_idx[s] * m[..., 0]
            total = total + angular_nll(sampled_preds[s], gt_s, sel)
    return total / len(norm_outs)
