"""Frame I/O codecs of the RAFT3D readers, the submission writer and the
demo.

The port's own copy of ``sndepth_tpu/data/frame_codecs.py``, the KITTI pngs
decoded through ``cv2``:

* KITTI flow png: uint16 png, BGR-ordered on disk, with ``64 * uv + 2^15``
  in the first two channels and a validity bit in the third;
* KITTI disparity png: uint16 ``256 * disp``;
* Middlebury ``.flo``: ``PIEH`` magic, int32 (w, h), float32 data;
* PFM: the float map format of the FlyingThings3D disparities;
* Sintel ``.dpt`` depth and ``.cam`` camera files;
* :func:`read_gen`, which picks the reader by the file's extension.

Pure numpy, host side.
"""

from __future__ import annotations

import os
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


def write_flo(filename: str, flow: np.ndarray) -> None:
    """(H, W, 2) flow -> Middlebury ``.flo``."""
    h, w = flow.shape[:2]
    with open(filename, "wb") as f:
        f.write(TAG_CHAR)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def write_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    """(H, W) or (H, W, 3) -> PFM, bottom row first, the scale's sign
    giving the byte order."""
    image = np.flipud(image).astype(np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


TAG_FLOAT = 202021.25           # the tag of Sintel's .dpt and .cam files


def read_dpt(filename: str) -> np.ndarray:
    """Sintel ``.dpt`` depth: float32 tag, int32 (w, h), float32 map ->
    (H, W) float32."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, np.float32, 1)[0]
        if check != np.float32(TAG_FLOAT):
            raise ValueError(
                f"wrong .dpt tag in {filename}: {check} (big-endian file?)")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        if not (w > 0 and h > 0 and 1 < w * h < 100000000):
            raise ValueError(f"bad .dpt dims {w}x{h} in {filename}")
        return np.fromfile(f, np.float32, -1).reshape(h, w)


def write_dpt(filename: str, depth: np.ndarray) -> None:
    h, w = depth.shape
    with open(filename, "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        depth.astype(np.float32).tofile(f)


def read_cam(filename: str) -> tuple[np.ndarray, np.ndarray]:
    """Sintel ``.cam`` -> (pvec, kvec): pvec = [t (3), quaternion (4),
    scalar last] of the extrinsic, kvec = [fx, fy, cx, cy]. The tag is not
    checked, as the reference's reader does not check it."""
    from scipy.spatial.transform import Rotation
    with open(filename, "rb") as f:
        np.fromfile(f, np.float32, 1)
        M = np.fromfile(f, np.float64, 9).reshape(3, 3)
        N = np.fromfile(f, np.float64, 12).reshape(3, 4)
    kvec = np.array([M[0, 0], M[1, 1], M[0, 2], M[1, 2]])
    q = Rotation.from_matrix(N[:3, :3]).as_quat()
    return np.concatenate([N[:3, 3], q], 0), kvec


def write_cam(filename: str, M: np.ndarray, N: np.ndarray) -> None:
    """Intrinsics ``M`` (3, 3) and extrinsic ``N`` (3, 4) -> Sintel
    ``.cam``."""
    with open(filename, "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        M.astype(np.float64).tofile(f)
        N.astype(np.float64).tofile(f)


def read_gen(filename: str):
    """Read ``filename`` by its extension: an image (png, jpeg, ppm) as the
    uint8 array PIL decodes, ``.bin`` / ``.raw`` through ``np.load``,
    ``.flo``, ``.pfm``, ``.dpt`` and ``.cam``."""
    ext = os.path.splitext(filename)[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        from PIL import Image
        return np.asarray(Image.open(filename))
    if ext in (".bin", ".raw"):
        return np.load(filename)
    readers = {".flo": read_flo, ".pfm": read_pfm, ".dpt": read_dpt,
               ".cam": read_cam}
    if ext not in readers:
        raise ValueError(f"unsupported extension: {ext}")
    return readers[ext](filename)
