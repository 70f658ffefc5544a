"""Synthetic KITTI-like training stream (host side, numpy).

The stream of ``sndepth_tpu.data.prefetch.synthetic_batches`` for a given
seed: uint8 noise targets, with source s a copy of the target shifted
along W by +2, -2, +4, -4, ... pixels, so the photometric loss has real
signal and training visibly descends.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_batches(batch_size: int, img_height: int, img_width: int,
                      num_source: int = 2, seed: int = 0) -> Iterator[dict]:
    """Infinite stream of {"tgt": (B, H, W, 3) uint8, "src": (B, H, W,
    3*ns) uint8, "intrinsics": (B, 3, 3) float32} numpy batches (NHWC, as
    the dataset delivers them)."""
    rng = np.random.RandomState(seed)
    k = np.array([[img_width * 0.58, 0, img_width / 2.0],
                  [0, img_height * 1.92, img_height / 2.0],
                  [0, 0, 1]], np.float32)
    shifts = [2 * (s // 2 + 1) * (1 - 2 * (s % 2)) for s in range(num_source)]
    while True:
        tgt = rng.randint(0, 256, (batch_size, img_height, img_width, 3),
                          dtype=np.uint8)
        src = np.concatenate([np.roll(tgt, d, axis=2) for d in shifts],
                             axis=-1)
        yield {"tgt": tgt, "src": src,
               "intrinsics": np.tile(k[None], (batch_size, 1, 1))}
