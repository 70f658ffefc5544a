"""NYUv2 loader for surface-normal evaluation (host side, numpy).

The port's own copy of ``sndepth_tpu/data/nyu.py``: RGB images with
per-pixel ground-truth normals and a validity mask, as the NNET lineage
evaluates them (reference `models/baseline.py:263-272` preprocessing,
`utils/utils_coders.py:73-84` metrics; the reference's own NYU loader file
is empty).

Directory layout: ``{root}/{split}/`` containing ``*_rgb.png``,
``*_norm.png`` (normals encoded as (n + 1) / 2 * 255) and optional
``*_mask.png``.
"""

from __future__ import annotations

import glob
import os

import numpy as np


class NYUv2Dataset:
    def __init__(self, root: str, split: str = "test",
                 img_height: int | None = None,
                 img_width: int | None = None):
        base = os.path.join(root, split)
        self.rgb_paths = sorted(glob.glob(os.path.join(base, "*_rgb.png")))
        if not self.rgb_paths:
            raise FileNotFoundError(f"no *_rgb.png under {base}")
        self.img_height = img_height
        self.img_width = img_width

    def __len__(self) -> int:
        return len(self.rgb_paths)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image
        rgb_path = self.rgb_paths[index]
        base = rgb_path[:-len("_rgb.png")]

        rgb = Image.open(rgb_path).convert("RGB")
        norm_img = Image.open(base + "_norm.png").convert("RGB")
        if self.img_height and self.img_width:
            size = (self.img_width, self.img_height)
            rgb = rgb.resize(size, Image.Resampling.BILINEAR)
            norm_img = norm_img.resize(size, Image.Resampling.NEAREST)
        rgb = np.asarray(rgb, np.float32) / 255.0
        normals = np.asarray(norm_img, np.float32) / 255.0 * 2.0 - 1.0
        n = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(n, 1e-6)

        mask_path = base + "_mask.png"
        if os.path.exists(mask_path):
            mask = np.asarray(Image.open(mask_path).convert("L"))
            if self.img_height and self.img_width:
                mask = np.asarray(Image.fromarray(mask).resize(
                    (self.img_width, self.img_height),
                    Image.Resampling.NEAREST))
            mask = mask > 127
        else:
            mask = n[..., 0] > 0.5   # valid where the encoded normal is unit
        return {"rgb": rgb, "normals": normals, "mask": mask}
