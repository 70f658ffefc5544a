"""KITTIMotion reader: RGB image, flow image and 3-class label.

The port's own copy of ``sndepth_tpu/data/kitti_motion.py``. The layout is
the reference's (`models/dataset/KITTIMotion.py:13-69`):
``{root}/{train|val}/{image,flow,label}/*.png``, the class in the label's red
channel as ``class * 100``. As in the JAX reader, samples are decoded on
demand, and the three globs are sorted so that image, flow and label of a
sample correspond (the reference relies on unsorted ``glob.glob`` order).
Host side, numpy only; images (H, W, 3) float32 in [0, 1], channel-last as
decoded.
"""

from __future__ import annotations

import glob
import os

import numpy as np


class KITTIMotionDataset:
    def __init__(self, root_dir: str, train: bool = True):
        split = "train" if train else "val"
        base = os.path.join(root_dir, split)
        self.images = sorted(glob.glob(os.path.join(base, "image/*.png")))
        self.flows = sorted(glob.glob(os.path.join(base, "flow/*.png")))
        self.labels = sorted(glob.glob(os.path.join(base, "label/*.png")))
        n = len(self.labels)
        if not (len(self.images) == len(self.flows) == n):
            raise ValueError(
                f"mismatched counts under {base}: "
                f"{len(self.images)} images, {len(self.flows)} flows, "
                f"{n} labels")

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image
        img = np.asarray(Image.open(self.images[index]).convert("RGB"),
                         np.float32) / 255.0
        flow = np.asarray(Image.open(self.flows[index]).convert("RGB"),
                          np.float32) / 255.0
        label_rgb = np.asarray(Image.open(self.labels[index]))
        label = (label_rgb[..., 0] // 100).astype(np.int32)
        return {"image": img, "flow": flow, "label": label}


def synthetic_motion_batches(batch_size: int, height: int = 64,
                             width: int = 128, seed: int = 0):
    """Endless seeded stream with learnable structure, the JAX stream's bits
    (3 classes): the flow image is a function of the label, so a net can
    fit it."""
    rng = np.random.RandomState(seed)
    while True:
        image = rng.rand(batch_size, height, width, 3).astype(np.float32)
        label = rng.randint(0, 3, (batch_size, height, width))
        flow = np.zeros((batch_size, height, width, 3), np.float32)
        for c in range(3):
            flow[..., c % 3] += (label == c) * (0.3 + 0.3 * c)
        yield {"image": image, "flow": flow,
               "label": label.astype(np.int32)}
