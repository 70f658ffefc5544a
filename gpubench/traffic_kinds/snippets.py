"""Training snippets: a pool of distinct batches of the shifted-noise
pattern of ``sndepth_tpu_torch/data/synthetic.py`` (uint8 noise targets;
source s is the target rolled along W by +2, -2, +4, -4, ... pixels, so the
photometric loss has real signal), handed over as uint8 NHWC numpy arrays
as a dataset reader delivers them.

Parameters: ``pool``, ``batch``, and from the configuration ``height``,
``width`` and ``sequence_length``.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.generator import seeded


def kitti_intrinsics(h: int, w: int) -> np.ndarray:
    """The synthetic stream's pinhole intrinsics (float32, 3x3)."""
    return np.array([[w * 0.58, 0, w / 2.0], [0, h * 1.92, h / 2.0],
                     [0, 0, 1]], np.float32)


def generate(p: dict, seed: int, device) -> list:
    """``p["pool"]`` distinct batches of ``p["batch"]`` snippets of
    ``p["sequence_length"]`` frames at ``p["height"]`` x ``p["width"]``:
    ``[{"tgt": (B, H, W, 3) uint8, "src": (B, H, W, 3 (L-1)) uint8,
    "intrinsics": (B, 3, 3) float32}, ...]`` numpy, every row distinct."""
    pool, b, h, w = p["pool"], p["batch"], p["height"], p["width"]
    ns = p["sequence_length"] - 1
    shifts = [2 * (s // 2 + 1) * (1 - 2 * (s % 2)) for s in range(ns)]
    gen = seeded(seed, "snippets", device)
    tgt = torch.randint(0, 256, (pool, b, h, w, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    src = torch.cat([torch.roll(tgt, d, dims=3) for d in shifts], -1)
    tgt, src = tgt.cpu().numpy(), src.cpu().numpy()
    k = np.tile(kitti_intrinsics(h, w)[None], (b, 1, 1))
    return [{"tgt": tgt[i], "src": src[i], "intrinsics": k}
            for i in range(pool)]
