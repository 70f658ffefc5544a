"""RAFT3D KITTI evaluation loader and submission writer.

The port's own copy of ``sndepth_tpu/data/raft3d_kitti.py``, on the port's
:class:`EvalSequenceDataset`:

* :class:`KITTIEvalDataset` walks ``{root}/testing/seq/*.png`` with 3-view
  (previous / current / next, edge-clamped) sampling and parses the ``K_02``
  intrinsics from ``{root}/testing/calib_cam_to_cam/*.txt``;
* :func:`write_prediction` writes the KITTI submission artifacts: the flow
  png (``64 * uv + 2^15`` as uint16), the disparity pngs (``256 * d``) and
  the SE3 field / tau / phi text dumps.

Host side, numpy only; images are (H, W, 3) channel-last as decoded.
"""

from __future__ import annotations

import csv
import os
from glob import glob

import numpy as np

from sndepth_tpu_torch.data.frame_codecs import (write_disp_kitti,
                                                 write_flow_kitti)
from sndepth_tpu_torch.data.kitti_sequence import EvalSequenceDataset


def parse_k02_intrinsics(calib_file: str) -> np.ndarray:
    """[fx, fy, cx, cy] from the K_02 row of a KITTI calib_cam_to_cam
    file."""
    with open(calib_file) as f:
        for row in csv.reader(f, delimiter=" "):
            if row and row[0] == "K_02:":
                k = np.array(row[1:], np.float32).reshape(3, 3)
                return np.array([k[0, 0], k[1, 1], k[0, 2], k[1, 2]],
                                np.float32)
    raise ValueError(f"no K_02 entry in {calib_file}")


class KITTIEvalDataset(EvalSequenceDataset):
    """3-view loader over the RAFT3D testing sequence, with intrinsics: the
    samples of :class:`EvalSequenceDataset` plus ``"intrinsics"`` (4,). A
    frame past the last calibration file takes the last one's."""

    def __init__(self, root: str = "data/raft_datasets",
                 img_width: int = 416, img_height: int = 128):
        imgs = sorted(glob(os.path.join(root, "testing", "seq", "*.png")))
        super().__init__(imgs, img_width=img_width, img_height=img_height)
        calibs = sorted(glob(os.path.join(
            root, "testing", "calib_cam_to_cam", "*.txt")))
        self.intrinsics = [parse_k02_intrinsics(c) for c in calibs]

    def __getitem__(self, index: int) -> dict:
        sample = super().__getitem__(index)
        sample["intrinsics"] = self.intrinsics[
            min(index, len(self.intrinsics) - 1)]
        return sample


def write_prediction(out_dir: str, index: int, flow: np.ndarray,
                     Ts_field: np.ndarray, tau: np.ndarray,
                     phi: np.ndarray, disp1: np.ndarray | None = None,
                     disp2: np.ndarray | None = None) -> dict:
    """Write the KITTI submission artifacts of one frame; returns the map
    from artifact to path.

    flow: (H, W, 2); Ts_field: (..., 7) SE3 data, written as rows of
    translation + quaternion; tau, phi: (..., 3)."""
    for sub in ("flow", "T", "tau", "phi", "disp_0", "disp_1"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    paths = {"flow": os.path.join(out_dir, "flow", "%06d_10.png" % index),
             "T": os.path.join(out_dir, "T", "%06d.txt" % index),
             "tau": os.path.join(out_dir, "tau", "%06d.txt" % index),
             "phi": os.path.join(out_dir, "phi", "%06d.txt" % index)}
    write_flow_kitti(paths["flow"], flow)
    np.savetxt(paths["T"], np.asarray(Ts_field).reshape(-1, 7))
    np.savetxt(paths["tau"], np.asarray(tau).reshape(-1, 3), fmt="%.6f",
               delimiter=" ")
    np.savetxt(paths["phi"], np.asarray(phi).reshape(-1, 3), fmt="%.6f",
               delimiter=" ")
    for key, disp in (("disp_0", disp1), ("disp_1", disp2)):
        if disp is not None:
            paths[key] = os.path.join(out_dir, key, "%06d_10.png" % index)
            write_disp_kitti(paths[key], disp)
    return paths


def prepare_images_and_depths(image1: np.ndarray, image2: np.ndarray,
                              depth1: np.ndarray, depth2: np.ndarray,
                              depth_scale: float = 1.0):
    """Edge-pad (B, H, W, 3) images and (B, H, W) depths on the bottom and
    the right to multiples of 8, and scale the depths. Returns the four
    arrays and ``(pad_h, pad_w)``."""
    ht, wd = image1.shape[-3:-1]
    pad_h = (-ht) % 8
    pad_w = (-wd) % 8
    spec = [(0, 0), (0, pad_h), (0, pad_w)]

    def pad_img(x):
        return np.pad(x, spec + [(0, 0)], mode="edge")

    def pad_depth(x):
        return np.pad(x, spec, mode="edge")

    return (pad_img(image1), pad_img(image2),
            depth_scale * pad_depth(depth1), depth_scale * pad_depth(depth2),
            (pad_h, pad_w))
