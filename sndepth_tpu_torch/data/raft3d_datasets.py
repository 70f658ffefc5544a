"""RAFT3D training datasets: KITTI scene flow + FlyingThings3D/SceneFlow.

The port's own copy of ``sndepth_tpu/data/raft3d_datasets.py``: the same
items from the same files and seeds, the images decoded through ``cv2`` or
``PIL`` and the 3-D flow of the test split back-projected with the port's
``ops/projective.backproject_flow3d`` on CPU tensors.

Format parity with the reference's `utils/data_readers/kitti.py:152-248`
(KITTI train: image pairs, sparse GT disparity pngs, GANet dense
disparities, flow_occ, SparseAugmentor, crop of the top 80 rows, random
depth scale in [0.08, 0.15]) and `sceneflow.py:51-429` (FlyingThings3D:
PFM disparities, .flo optical flow, fwd/bwd pairs, RGBDAugmentor).

Both stream from disk on demand and emit numpy dicts ready for
``batch_iterator`` collation.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob

import numpy as np

from sndepth_tpu_torch.data import kitti_sequence
from sndepth_tpu_torch.data.frame_codecs import (read_disp_kitti, read_flo,
                                                 read_flow_kitti, read_pfm)
from sndepth_tpu_torch.data.raft3d_augment import (RGBDAugmentor,
                                                   SparseAugmentor)
from sndepth_tpu_torch.data.raft3d_kitti import parse_k02_intrinsics


def _imread(path):
    return kitti_sequence._imread(path).astype(np.float32)


class KITTISceneFlowDataset:
    """KITTI scene-flow training reader (`kitti.py:152-248`)."""

    CROP = 80   # drop the sky rows (`kitti.py` crop)

    def __init__(self, root: str = "data/raft_datasets", do_augment=True,
                 image_size=(256, 832), seed: int = 0):
        mode = "training"
        self.image1_list = sorted(
            glob(osp.join(root, mode, "image_2/*10.png")))
        self.image2_list = sorted(
            glob(osp.join(root, mode, "image_2/*11.png")))
        self.disp1_list = sorted(
            glob(osp.join(root, mode, "disp_occ_0/*10.png")))
        self.disp2_list = sorted(
            glob(osp.join(root, mode, "disp_occ_1/*10.png")))
        self.disp1_ga_list = sorted(
            glob(osp.join(root, mode, f"disp_ganet_{mode}/*10.png")))
        self.disp2_ga_list = sorted(
            glob(osp.join(root, mode, f"disp_ganet_{mode}/*11.png")))
        self.flow_list = sorted(
            glob(osp.join(root, mode, "flow_occ/*10.png")))
        self.intrinsics_list = []
        for calib in sorted(glob(osp.join(root, mode,
                                          "calib_cam_to_cam/*.txt"))):
            self.intrinsics_list.append(parse_k02_intrinsics(calib))
        self.augmentor = (SparseAugmentor(image_size, seed)
                          if do_augment else None)
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.image1_list)

    def __getitem__(self, index: int) -> dict:
        c = self.CROP
        image1 = _imread(self.image1_list[index])[c:]
        image2 = _imread(self.image2_list[index])[c:]
        disp1 = read_disp_kitti(self.disp1_list[index])[c:]
        disp2 = read_disp_kitti(self.disp2_list[index])[c:]
        disp1_dense = read_disp_kitti(self.disp1_ga_list[index])[c:]
        disp2_dense = read_disp_kitti(self.disp2_ga_list[index])[c:]
        flow, valid = read_flow_kitti(self.flow_list[index])
        flow, valid = flow[c:], valid[c:]
        intrinsics = self.intrinsics_list[index].copy()
        intrinsics[3] -= c

        # random metric scale for depth (`kitti.py` SCALE in [0.08, 0.15])
        scale = self.rng.uniform(0.08, 0.15)
        depth1 = scale * intrinsics[0] / np.maximum(disp1_dense, 1e-3)
        depth2 = scale * intrinsics[0] / np.maximum(disp2_dense, 1e-3)
        # target: (u, v, inverse-depth-change) flow; sparse validity
        dz = np.zeros_like(depth1)
        valid_all = (valid > 0.5) & (disp1 > 0)
        flow3 = np.concatenate([flow, dz[..., None]], axis=-1)

        if self.augmentor is not None:
            (image1, image2, depth1, depth2, flow3, valid_all,
             intrinsics) = self.augmentor(
                image1, image2, depth1, depth2, flow3,
                valid_all.astype(np.float32), intrinsics)

        return {"image1": image1, "image2": image2, "depth1": depth1,
                "depth2": depth2, "flow": flow3,
                "valid": np.asarray(valid_all, np.float32),
                "intrinsics": intrinsics}


class SceneFlowDataset:
    """FlyingThings3D-style reader (`sceneflow.py:51-200`): PFM disparities,
    .flo flows, forward pairs, RGBD augmentation."""

    DEPTH_SCALE = 0.1

    def __init__(self, root: str = "datasets/FlyingThings3D",
                 split: str = "TRAIN", do_augment=True,
                 image_size=(320, 720), fx: float = 1050.0, seed: int = 0):
        self.fx = fx
        self.samples = []
        image_dirs = sorted(glob(osp.join(root, "frames_cleanpass",
                                          split, "*/*")))
        for idir in image_dirs:
            scene_rel = osp.relpath(idir, osp.join(root, "frames_cleanpass"))
            ddir = osp.join(root, "disparity", scene_rel)
            fdir = osp.join(root, "optical_flow", scene_rel)
            for cam in ("left",):
                imgs = sorted(glob(osp.join(idir, cam, "*.png")))
                for i in range(len(imgs) - 1):
                    frame = osp.splitext(osp.basename(imgs[i]))[0]
                    nxt = osp.splitext(osp.basename(imgs[i + 1]))[0]
                    d1 = osp.join(ddir, cam, frame + ".pfm")
                    d2 = osp.join(ddir, cam, nxt + ".pfm")
                    fl = osp.join(fdir, "into_future", cam,
                                  f"OpticalFlowIntoFuture_{frame}_L.flo")
                    if all(map(os.path.exists, (d1, d2, fl))):
                        self.samples.append(
                            (imgs[i], imgs[i + 1], d1, d2, fl))
        self.augmentor = (RGBDAugmentor(image_size, seed)
                          if do_augment else None)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        i1, i2, d1p, d2p, flp = self.samples[index]
        image1 = _imread(i1)
        image2 = _imread(i2)
        disp1 = np.abs(np.asarray(read_pfm(d1p), np.float32))
        disp2 = np.abs(np.asarray(read_pfm(d2p), np.float32))
        flow2d = read_flo(flp)

        depth1 = self.DEPTH_SCALE * self.fx / np.maximum(disp1, 1e-3)
        depth2 = self.DEPTH_SCALE * self.fx / np.maximum(disp2, 1e-3)
        h, w = image1.shape[:2]
        intrinsics = np.array([self.fx, self.fx, w / 2.0, h / 2.0],
                              np.float32)
        flow3 = np.concatenate(
            [flow2d, np.zeros_like(depth1)[..., None]], axis=-1)

        if self.augmentor is not None:
            image1, image2, depth1, depth2, flow3, intrinsics = \
                self.augmentor(image1, image2, depth1, depth2, flow3,
                               intrinsics)
        return {"image1": image1, "image2": image2, "depth1": depth1,
                "depth2": depth2, "flow": flow3,
                "valid": np.ones(depth1.shape, np.float32),
                "intrinsics": intrinsics}


class FlyingThingsTest:
    """FlyingThings3D evaluation split (`sceneflow.py:363-430`): the
    official test-sample pickle lists (data_paths, sampled_pix1_x,
    sampled_pix2_y, mask) tuples; each item yields the image/disp pair,
    the 2D flow, the 3D flow backprojected through the disparity change,
    and the sampled evaluation pixel indices (y flipped as 539 - y,
    matching the reference)."""

    INTRINSICS = np.array([1050.0, 1050.0, 480.0, 270.0], np.float32)

    def __init__(self, root: str = "datasets/FlyingThings3D",
                 pickle_path: str | None = None):
        import pickle
        if pickle_path is None:
            pickle_path = osp.join(osp.dirname(root),
                                   "things_test_data.pickle")
        with open(pickle_path, "rb") as f:
            test_data = pickle.load(f)

        self.dataset_index = []
        for (data_paths, pix1_x, pix2_y, mask) in test_data:
            split, subset, sequence, camera, frame = data_paths.split("_")
            pix1_x = pix1_x[mask]
            pix2_y = 539 - pix2_y[mask]
            sampled_index = np.stack([pix2_y, pix1_x], axis=0)
            frame = int(frame)

            def p(kind, cam, name):
                return osp.join(root, kind, split, subset, sequence,
                                *( [cam] if cam else [] ), name)

            suffix = "L" if camera == "left" else "R"
            datum = (
                p("frames_cleanpass", camera, "%04d.png" % frame),
                p("frames_cleanpass", camera, "%04d.png" % (frame + 1)),
                p("disparity", camera, "%04d.pfm" % frame),
                p("disparity", camera, "%04d.pfm" % (frame + 1)),
                osp.join(root, "optical_flow", split, subset, sequence,
                         "into_future", camera,
                         f"OpticalFlowIntoFuture_%04d_{suffix}.pfm" % frame),
                osp.join(root, "disparity_change", split, subset, sequence,
                         "into_future", camera, "%04d.pfm" % frame),
                sampled_index,
            )
            self.dataset_index.append(datum)

    def __len__(self) -> int:
        return len(self.dataset_index)

    def __getitem__(self, index: int) -> dict:
        (i1, i2, d1p, d2p, flp, dcp, sampled_index) = \
            self.dataset_index[index]
        image1 = _imread(i1)
        image2 = _imread(i2)
        disp1 = np.asarray(read_pfm(d1p), np.float32)
        disp2 = np.asarray(read_pfm(d2p), np.float32)
        flow2d = np.asarray(read_pfm(flp), np.float32)[..., :2]
        disparity_change = np.asarray(read_pfm(dcp), np.float32)

        fx = self.INTRINSICS[0]
        depth1 = fx / disp1
        depth2 = fx / disp2
        depth12 = fx / (disp1 + disparity_change)

        import torch

        from sndepth_tpu_torch.ops.projective import backproject_flow3d
        flow3d = backproject_flow3d(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (flow2d, depth1, depth12, self.INTRINSICS))).numpy()

        return {"image1": image1, "image2": image2, "depth1": depth1,
                "depth2": depth2, "flow2d": flow2d, "flow3d": flow3d,
                "intrinsics": self.INTRINSICS.copy(),
                "sampled_index": sampled_index}
