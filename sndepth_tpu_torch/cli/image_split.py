"""CLI: slice wide frames into overlapping crops.

Counterpart of ``python -m sndepth_tpu.cli.image_split`` (reference
``data/image_split.py``): each 1280-wide frame of ``--in_dir`` becomes three
768-wide crops (left, centre, right), ``<stem>_{0,1,2}.png`` in
``--out_dir``, for the motion-segmentation train and val sets.

Usage:
    python -m sndepth_tpu_torch.cli.image_split --in_dir frames \\
        --out_dir crops
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def split_image(img: np.ndarray, crop_w: int = 768) -> list[np.ndarray]:
    w = img.shape[1]
    starts = [0, max((w - crop_w) // 2, 0), max(w - crop_w, 0)]
    return [img[:, s:s + crop_w] for s in starts]


def main(argv=None) -> int:
    """Write the crops; returns how many."""
    p = argparse.ArgumentParser(description="slice frames into crops")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--crop_width", default=768, type=int)
    args = p.parse_args(argv)

    from PIL import Image
    os.makedirs(args.out_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.in_dir, "*.png")))
    count = 0
    for path in paths:
        img = np.asarray(Image.open(path))
        stem = os.path.splitext(os.path.basename(path))[0]
        for i, crop in enumerate(split_image(img, args.crop_width)):
            Image.fromarray(crop).save(
                os.path.join(args.out_dir, f"{stem}_{i}.png"))
            count += 1
    print(f"wrote {count} crops from {len(paths)} frames")
    return count


if __name__ == "__main__":
    main()
