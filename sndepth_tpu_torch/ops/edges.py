"""Canny edges and edge-guided propagation, on the device (channel-last).

Counterpart of ``sndepth_tpu/ops/edges.py`` (reference
`utils/utils_edited.py:488-580`): Sobel gradients with the L1 magnitude,
non-maximum suppression over 4 direction bins, double threshold 100 / 220
and hysteresis as a fixed number of masked 3x3 dilations (the JAX
function's static loop, not cv2's flood fill), returning ``1 - edge``; the
4-channel edge-stage input; and :func:`propagate`, the 4-direction
edge-weighted shift blend of the refinement stage.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# BT.601 luma weights, matching cv2.cvtColor BGR2GRAY.
_BGR_LUMA = (0.114, 0.587, 0.299)


def bgr_to_gray(img_bgr: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR -> (B, H, W) luma."""
    w = torch.tensor(_BGR_LUMA, dtype=torch.float32, device=img_bgr.device)
    return torch.tensordot(img_bgr.float(), w, dims=([-1], [0]))


def _sobel(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    k = torch.tensor([[[[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]],
                      [[[-1, -2, -1], [0, 0, 0], [1, 2, 1]]]],
                     dtype=torch.float32, device=gray.device)
    g = F.conv2d(gray[:, None], k, padding=1)
    return g[:, 0], g[:, 1]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift (B, H, W) by (dy, dx) with zeros coming in."""
    out = torch.roll(x, (dy, dx), dims=(1, 2))
    if dy > 0:
        out[:, :dy] = 0
    elif dy < 0:
        out[:, dy:] = 0
    if dx > 0:
        out[:, :, :dx] = 0
    elif dx < 0:
        out[:, :, dx:] = 0
    return out


def canny_edges(img_bgr: torch.Tensor, low: float = 100.0,
                high: float = 220.0, hysteresis_iters: int = 8
                ) -> torch.Tensor:
    """Canny edge map of (B, H, W, 3) BGR images in any range (each
    min-max normalised to [0, 255], `utils_edited.py:519`). Returns
    (B, H, W, 1) float32: 0 at edges, 1 elsewhere."""
    gray = bgr_to_gray(img_bgr)
    gmin = gray.amin((1, 2), keepdim=True)
    gmax = gray.amax((1, 2), keepdim=True)
    gray = (gray - gmin) / (gmax - gmin + 1e-12) * 255.0

    gx, gy = _sobel(gray)
    mag = gx.abs() + gy.abs()   # cv2's default L1 norm

    deg = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)
    bins = torch.where(
        (deg < 22.5) | (deg >= 157.5), 0,
        torch.where(deg < 67.5, 1, torch.where(deg < 112.5, 2, 3)))
    neighbor_pairs = (((0, 1), (0, -1)),    # horizontal gradient
                      ((1, 1), (-1, -1)),   # 45 degrees
                      ((1, 0), (-1, 0)),    # vertical
                      ((1, -1), (-1, 1)))   # 135 degrees
    is_max = torch.zeros_like(mag, dtype=torch.bool)
    for b, ((dy1, dx1), (dy2, dx2)) in enumerate(neighbor_pairs):
        ge = (mag >= _shift(mag, dy1, dx1)) & (mag >= _shift(mag, dy2, dx2))
        is_max = torch.where(bins == b, ge, is_max)
    nms = torch.where(is_max, mag, torch.zeros_like(mag))

    edges = nms >= high
    weak = nms >= low
    for _ in range(hysteresis_iters):
        edges = (F.max_pool2d(edges.float()[:, None], 3, 1, 1)[:, 0] > 0) \
            & weak
    return (1.0 - edges.float())[..., None]


def edge_model_inputs(img_bgr: torch.Tensor) -> torch.Tensor:
    """[canny, bgr * 0.00784]: the 4-channel edge-stage input
    (`utils_edited.py:566-580`), (B, H, W, 4)."""
    return torch.cat([canny_edges(img_bgr), img_bgr.float() * 0.00784], -1)


def propagate(data: torch.Tensor, dlr: torch.Tensor, drl: torch.Tensor,
              dud: torch.Tensor, ddu: torch.Tensor) -> torch.Tensor:
    """Edge-weighted 4-direction shift blend (`utils_edited.py:526-563`).

    data: (B, H, W, C); each d*: (B, H, W, 1), the blend weight toward the
    shifted copy. Order: left->right, right->left, up->down, down->up."""
    def blend(x, shifted, w):
        return shifted * w + x * (1.0 - w)

    zero_col = torch.zeros_like(data[:, :, :1])
    right = torch.cat([zero_col, data[:, :, :-1]], 2)
    out = blend(data, right, dlr)
    left = torch.cat([out[:, :, 1:], zero_col.to(out.dtype)], 2)
    out = blend(out, left, drl)
    zero_row = torch.zeros_like(out[:, :1])
    down = torch.cat([zero_row, out[:, :-1]], 1)
    out = blend(out, down, dud)
    up = torch.cat([out[:, 1:], zero_row], 1)
    return blend(out, up, ddu)
