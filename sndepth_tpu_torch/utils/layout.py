"""The one boundary between the JAX package's NHWC and this port's NCHW:
numpy conversions of channel-last arrays to channel-first and back."""

from __future__ import annotations

import numpy as np


def to_nchw(a) -> np.ndarray:
    """(..., H, W, C) -> (..., C, H, W)."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3))


def to_nhwc(a) -> np.ndarray:
    """(..., C, H, W) -> (..., H, W, C)."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -3, -1))
