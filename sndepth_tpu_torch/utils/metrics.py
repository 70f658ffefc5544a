"""Evaluation metrics: depth (Eigen), surface normals, segmentation mIoU.

Counterpart of ``sndepth_tpu/utils/metrics.py`` (reference
`models/test_disp.py:107-148`, `utils/utils_coders.py:73-84`,
`evaluate.py:12-22`). Every function takes torch tensors or numpy arrays
and returns float32 tensors on the input's device. Medians are the JAX
package's: the mean of the two middle values of an even count (``jnp.median``
interpolates), where ``torch.median`` would return the lower one.
"""

from __future__ import annotations

import torch

DEPTH_MIN = 1e-3   # `test_disp.py:24`
DEPTH_MAX = 80.0   # `test_disp.py:25`

DEPTH_ERROR_NAMES = ("abs_diff", "abs_rel", "sq_rel", "rms", "log_rms",
                     "abs_log", "a1", "a2", "a3")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a flat tensor, as ``jnp.median`` takes it: the middle
    value, or half of each of the two middle values."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    lo, hi = s[(n - 1) // 2], s[n // 2]
    return lo * 0.5 + hi * 0.5


def compute_depth_errors(gt, pred) -> dict:
    """Eigen-style depth metrics over flattened valid pixels."""
    gt, pred = _f32(gt), _f32(pred)
    thresh = torch.maximum(gt / pred, pred / gt)
    log_diff = torch.log(gt) - torch.log(pred)
    diff = gt - pred
    return {
        "abs_diff": diff.abs().mean(),
        "abs_rel": (diff.abs() / gt).mean(),
        "sq_rel": (diff ** 2 / gt).mean(),
        "rms": torch.sqrt((diff ** 2).mean()),
        "log_rms": torch.sqrt((log_diff ** 2).mean()),
        "abs_log": log_diff.abs().mean(),
        "a1": (thresh < 1.25).float().mean(),
        "a2": (thresh < 1.25 ** 2).float().mean(),
        "a3": (thresh < 1.25 ** 3).float().mean(),
    }


def median_scaled_depth_errors(gt, pred, mask=None) -> dict:
    """The full eval protocol: mask, clip to [1e-3, 80], scale prediction by
    median(gt)/median(pred), then compute the metric set."""
    gt, pred = _f32(gt).reshape(-1), _f32(pred).reshape(-1)
    if mask is not None:
        m = torch.as_tensor(mask, device=gt.device).reshape(-1).bool()
        gt, pred = gt[m], pred[m]
    pred = pred.clamp(DEPTH_MIN, DEPTH_MAX)
    scale = median(gt) / median(pred)
    return compute_depth_errors(gt, pred * scale)


def normal_angular_errors(pred_normals, gt_normals, mask=None
                          ) -> torch.Tensor:
    """Per-pixel angular error in degrees between unit-ish normal maps.

    pred/gt: (..., 3). Returns the flattened error vector (optionally
    masked) to feed :func:`compute_normal_errors`."""
    pred, gt = _f32(pred_normals), _f32(gt_normals)
    pred = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True)
                   + 1e-12)
    gt = gt / (torch.linalg.vector_norm(gt, dim=-1, keepdim=True) + 1e-12)
    cos = (pred * gt).sum(-1).clamp(-1.0, 1.0)
    err = torch.rad2deg(torch.arccos(cos)).reshape(-1)
    if mask is not None:
        err = err[torch.as_tensor(mask, device=err.device).reshape(-1).bool()]
    return err


def compute_normal_errors(errors) -> dict:
    """Aggregate angular-error stats (`utils_coders.py:73-84`)."""
    e = _f32(errors)
    n = e.shape[0]
    return {
        "mean": e.mean(),
        "median": median(e),
        "rmse": torch.sqrt((e * e).sum() / n),
        "a1": 100.0 * (e < 5).sum().float() / n,
        "a2": 100.0 * (e < 7.5).sum().float() / n,
        "a3": 100.0 * (e < 11.25).sum().float() / n,
        "a4": 100.0 * (e < 22.5).sum().float() / n,
        "a5": 100.0 * (e < 30).sum().float() / n,
    }


def confusion_matrix(pred, target, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) confusion counts; rows = target."""
    pred = torch.as_tensor(pred).reshape(-1).to(torch.int64)
    target = torch.as_tensor(target).reshape(-1).to(torch.int64)
    idx = target * num_classes + pred
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts[:num_classes * num_classes].reshape(
        num_classes, num_classes).to(torch.int32)


def mean_iou(pred, target, num_classes: int) -> torch.Tensor:
    """Mean per-class IoU from a confusion matrix (`evaluate.py:12-22`);
    classes absent from both prediction and target count 0."""
    cm = confusion_matrix(pred, target, num_classes).float()
    tp = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - tp
    iou = torch.where(union > 0, tp / union.clamp(min=1.0),
                      torch.zeros_like(tp))
    return iou.mean()
