"""An image folder as an inference stream.

Counterpart of ``sndepth_tpu/data/custom.py`` (the reference names this
loader and ships it empty, ``data/dataloader_custom.py``): every image of
a directory, in name order, becomes a frame of an
:class:`~sndepth_tpu_torch.data.kitti_sequence.EvalSequenceDataset`, with
the previous and next frames (clamped at the ends) as its sources.
"""

from __future__ import annotations

import glob
import os

from sndepth_tpu_torch.data.kitti_sequence import EvalSequenceDataset

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


class CustomFolderDataset(EvalSequenceDataset):
    def __init__(self, root: str, img_width: int = 416,
                 img_height: int = 128):
        paths = []
        for ext in IMAGE_EXTS:
            paths.extend(glob.glob(os.path.join(root, f"*{ext}")))
        if not paths:
            raise FileNotFoundError(f"no images under {root}")
        super().__init__(sorted(paths), img_width=img_width,
                         img_height=img_height)
