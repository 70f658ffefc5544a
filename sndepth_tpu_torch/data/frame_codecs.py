"""Frame I/O codecs of the KITTI scene-flow submission.

The port's own copy of the part of ``sndepth_tpu/data/frame_codecs.py`` that
the RAFT3D submission writer needs, decoded through ``cv2``:

* KITTI flow png: uint16 png, BGR-ordered on disk, with ``64 * uv + 2^15``
  in the first two channels and a validity bit in the third;
* KITTI disparity png: uint16 ``256 * disp``.

Pure numpy, host side.
"""

from __future__ import annotations

import numpy as np


def write_flow_kitti(filename: str, uv: np.ndarray,
                     valid: np.ndarray | None = None) -> None:
    """uv: (H, W, 2) flow in pixels; valid: (H, W) or (H, W, 1), all ones
    when omitted."""
    import cv2
    data = 64.0 * uv + 2 ** 15
    if valid is None:
        valid = np.ones(uv.shape[:2] + (1,), np.float64)
    elif valid.ndim == 2:
        valid = valid[..., None]
    packed = np.concatenate([data, valid], axis=-1).astype(np.uint16)
    if not cv2.imwrite(filename, packed[..., ::-1]):
        raise OSError(f"cannot write {filename}")


def read_flow_kitti(filename: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (flow (H, W, 2) float32, valid (H, W) float32)."""
    import cv2
    raw = cv2.imread(filename, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise OSError(f"cannot read {filename}")
    raw = raw[..., ::-1].astype(np.float32)
    return (raw[..., :2] - 2 ** 15) / 64.0, raw[..., 2]


def write_disp_kitti(filename: str, disp: np.ndarray) -> None:
    import cv2
    if not cv2.imwrite(filename, (256.0 * disp).astype(np.uint16)):
        raise OSError(f"cannot write {filename}")


def read_disp_kitti(filename: str) -> np.ndarray:
    import cv2
    raw = cv2.imread(filename, cv2.IMREAD_ANYDEPTH)
    if raw is None:
        raise OSError(f"cannot read {filename}")
    return raw.astype(np.float32) / 256.0
