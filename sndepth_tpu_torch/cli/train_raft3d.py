"""CLI: RAFT3D scene-flow training on one GPU.

The flags and defaults of ``python -m sndepth_tpu.cli.train_raft3d``, plus
``--device``: the sequence loss of :mod:`sndepth_tpu_torch.train.raft3d` over
the KITTI scene-flow reader, or over a synthetic stream made from a numpy
seed when ``--root`` holds no training pairs, with the encoders and the GRU
in bfloat16. The checkpoint goes to ``--ckpt_dir`` at the end: ``raft3d.pth``
is what ``sndepth_tpu_torch.cli.kitti_submission --ckpt_dir`` serves.

Usage:
    python -m sndepth_tpu_torch.cli.train_raft3d --max_steps 5
    python -m sndepth_tpu_torch.cli.train_raft3d --root data/raft_datasets
"""

from __future__ import annotations

import argparse

import numpy as np


def synthetic_batches(b: int, h: int, w: int, seed: int = 0):
    """Endless seeded batches in the readers' layout: images (B, H, W, 3)
    in [0, 1], depths in [2, 3), a zero flow target, full validity."""
    rng = np.random.RandomState(seed)
    while True:
        yield {
            "image1": rng.rand(b, h, w, 3).astype(np.float32),
            "image2": rng.rand(b, h, w, 3).astype(np.float32),
            "depth1": (2 + rng.rand(b, h, w)).astype(np.float32),
            "depth2": (2 + rng.rand(b, h, w)).astype(np.float32),
            "flow": np.zeros((b, h, w, 3), np.float32),
            "valid": np.ones((b, h, w), np.float32),
            "intrinsics": np.tile(
                np.array([w * 0.6, w * 0.6, w / 2, h / 2], np.float32),
                (b, 1)),
        }


def main(argv=None):
    """Train; returns (final RAFT3DTrainState, logged metric records)."""
    p = argparse.ArgumentParser(description="RAFT3D training")
    p.add_argument("--root", default="data/raft_datasets")
    p.add_argument("--ckpt_dir", default="checkpoints/raft3d")
    p.add_argument("--batch_size", default=2, type=int)
    p.add_argument("--img_height", default=256, type=int)
    p.add_argument("--img_width", default=832, type=int)
    p.add_argument("--iters", default=12, type=int)
    p.add_argument("--max_steps", default=0, type=int)
    p.add_argument("--corr_levels", default=4, type=int)
    p.add_argument("--log_every", default=10, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.data.kitti_sequence import batch_iterator
    from sndepth_tpu_torch.data.raft3d_datasets import KITTISceneFlowDataset
    from sndepth_tpu_torch.models.raft3d import RAFT3D, init_weights
    from sndepth_tpu_torch.train.loop import train_raft3d

    h, w = args.img_height, args.img_width
    ds = KITTISceneFlowDataset(args.root, image_size=(h, w))
    if len(ds) > 0:
        batches = batch_iterator(ds, args.batch_size, shuffle=True, loop=True)
        max_steps = args.max_steps or 50_000
        print(f"training on {len(ds)} KITTI scene-flow pairs")
    else:
        batches = synthetic_batches(args.batch_size, h, w)
        max_steps = args.max_steps or 100
        print("no dataset found; training on synthetic stream")

    model = RAFT3D(corr_levels=args.corr_levels, dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    return train_raft3d(batches, max_steps, device=args.device, model=model,
                        iters=args.iters, ckpt_dir=args.ckpt_dir,
                        log_every=args.log_every)


if __name__ == "__main__":
    main()
