"""CLI: surface-normal network training (encoder + decoder) on one GPU.

The flags and log lines of ``python -m sndepth_tpu.cli.train_nnet``, plus
``--device``: :mod:`sndepth_tpu_torch.train.nnet` (multi-scale angular NLL,
AdamW) over NYUv2 through :class:`~sndepth_tpu_torch.data.nyu.
NYUv2Dataset` where ``--data_dir`` is a directory, else over the seeded
synthetic stream of the JAX CLI; batch 4 at 128x416, float32. The
checkpoint goes to ``--ckpt_dir`` at the end: ``nnet.pth`` is what
``evaluate_normals --ckpt_dir`` serves.

Usage:
    python -m sndepth_tpu_torch.cli.train_nnet --max_steps 20
    python -m sndepth_tpu_torch.cli.train_nnet --data_dir data/nyu
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def synthetic_batches(b: int, h: int, w: int, seed: int = 0):
    """The JAX CLI's stream (``_synthetic_batches``): random images in
    [0, 1), random unit normals, every pixel valid."""
    rng = np.random.RandomState(seed)
    while True:
        n = rng.randn(b, h, w, 3).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8
        yield {"rgb": rng.rand(b, h, w, 3).astype(np.float32),
               "normals": n, "mask": np.ones((b, h, w), bool)}


def main(argv=None):
    """Train; returns (final NNETTrainState, logged metric records)."""
    p = argparse.ArgumentParser(description="normal-net training")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--ckpt_dir", default="checkpoints/nnet")
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--max_steps", default=0, type=int)
    p.add_argument("--log_every", default=10, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    from sndepth_tpu_torch.train import loop
    from sndepth_tpu_torch.train import nnet as nt

    h, w = args.img_height, args.img_width
    if args.data_dir and os.path.isdir(args.data_dir):
        from sndepth_tpu_torch.data.kitti_sequence import batch_iterator
        from sndepth_tpu_torch.data.nyu import NYUv2Dataset
        ds = NYUv2Dataset(args.data_dir, args.split, h, w)
        batches = batch_iterator(ds, args.batch_size, shuffle=True,
                                 loop=True)
        max_steps = args.max_steps or 10_000
        print(f"training on {len(ds)} NYUv2 samples")
    else:
        batches = synthetic_batches(args.batch_size, h, w)
        max_steps = args.max_steps or 100
        print("no dataset found; training on synthetic stream")

    state = nt.create_train_state(device=args.device)
    records = loop.run_steps(lambda b: nt.train_step(state, b), batches,
                             max_steps, device=args.device,
                             log_every=args.log_every)
    print(f"checkpoint -> {loop.save_nnet_checkpoint(state, args.ckpt_dir)}")
    return state, records


if __name__ == "__main__":
    main()
