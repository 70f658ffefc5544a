"""Image/flow visualization + save helpers (numpy).

The port's own copy of ``sndepth_tpu/utils/visualize.py``: min-max
normalised image saves and HSV flow colouring (hue = angle, value =
normalised magnitude), plus the pose CSV dump, as the reference's savers
(`utils/utils_edited.py:14-86`).
"""

from __future__ import annotations

import csv
import os

import numpy as np


def normalize01(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo + 1e-12)


def flow_to_rgb(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) float RGB via HSV encoding."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx ** 2 + fy ** 2)
    ang = (np.arctan2(fy, fx) + np.pi) / (2 * np.pi)
    mag = normalize01(mag)
    h, w = mag.shape
    hsv = np.stack([ang, np.ones_like(ang), mag], axis=-1)
    # vectorized hsv->rgb
    i = np.floor(hsv[..., 0] * 6.0)
    f = hsv[..., 0] * 6.0 - i
    v = hsv[..., 2]
    p = v * 0
    q = v * (1.0 - f)
    t = v * f
    i = i.astype(int) % 6
    rgb = np.zeros((h, w, 3), np.float32)
    conds = [(i == 0, (v, t, p)), (i == 1, (q, v, p)), (i == 2, (p, v, t)),
             (i == 3, (p, q, v)), (i == 4, (t, p, v)), (i == 5, (v, p, q))]
    for cond, (r, g, b) in conds:
        rgb[cond] = np.stack([r[cond], g[cond], b[cond]], -1)
    return rgb


def save_image(path: str, img: np.ndarray) -> None:
    """Save any 2-D/3-D array min-max normalized to a png."""
    from PIL import Image
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 2:
        img = flow_to_rgb(img)
    img = normalize01(np.squeeze(img))
    if img.ndim == 2:
        out = (img * 255).astype(np.uint8)
    else:
        out = (img * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(out).save(path)


def pose_to_csv(pose_data: np.ndarray, filename: str) -> None:
    """(num_batches, num_src, 6) poses -> csv (`utils_edited.py:14-24`)."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["source_index", "tx", "ty", "tz",
                         "rx", "ry", "rz"])
        for poses in np.asarray(pose_data):
            for src_idx, pose in enumerate(poses):
                writer.writerow([src_idx] + list(map(float, pose)))
