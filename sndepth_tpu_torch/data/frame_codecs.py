"""Frame I/O codecs of the RAFT3D readers and the submission writer.

The port's own copy of the part of ``sndepth_tpu/data/frame_codecs.py`` that
the RAFT3D submission writer and training readers need, the pngs decoded
through ``cv2``:

* KITTI flow png: uint16 png, BGR-ordered on disk, with ``64 * uv + 2^15``
  in the first two channels and a validity bit in the third;
* KITTI disparity png: uint16 ``256 * disp``;
* Middlebury ``.flo``: ``PIEH`` magic, int32 (w, h), float32 data;
* PFM: the float map format of the FlyingThings3D disparities.

Pure numpy, host side.
"""

from __future__ import annotations

import re

import numpy as np

TAG_CHAR = b"PIEH"


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


def read_flo(filename: str) -> np.ndarray:
    """Middlebury ``.flo`` -> (H, W, 2) float32."""
    with open(filename, "rb") as f:
        magic = f.read(4)
        if magic != TAG_CHAR:
            raise ValueError(f"bad .flo magic in {filename}: {magic!r}")
        w, h = np.fromfile(f, np.int32, 2)
        data = np.fromfile(f, np.float32, 2 * int(w) * int(h))
    return data.reshape(int(h), int(w), 2)


def read_pfm(filename: str) -> np.ndarray:
    """PFM -> (H, W) or (H, W, 3) float32, top row first (the file stores
    the bottom row first; a negative scale means little-endian)."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (h, w, 3) if header == b"PF" else (h, w)
    return np.flipud(data.reshape(shape))
