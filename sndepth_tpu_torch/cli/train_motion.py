"""CLI: MotionFusionNet training on one GPU.

The flags and log lines of ``python -m sndepth_tpu.cli.train_motion``, plus
``--device``: Adam at 0.01 decayed by 0.9 every 3000 steps, batch 16,
cross-entropy (reference `train.py`), on the KITTIMotion reader where
``--data_dir`` holds ``train/label``, else on the seeded synthetic stream at
``--height`` x ``--width``; the net computes in ``--dtype`` (bf16 by
default). The checkpoint goes to ``--ckpt_dir`` at the end: ``motion.pth``
is what ``evaluate_motion``, ``predict_motion`` and ``predict
--motion_ckpt`` serve.

Usage:
    python -m sndepth_tpu_torch.cli.train_motion --max_steps 20
    python -m sndepth_tpu_torch.cli.train_motion --data_dir data/imgs
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    """Train; returns (final MotionTrainState, logged metric records)."""
    p = argparse.ArgumentParser(description="Motion segmentation training")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--ckpt_dir", default="checkpoints/motion")
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--epochs", default=800, type=int)
    p.add_argument("--max_steps", default=0, type=int)
    p.add_argument("--log_every", default=10, type=int)
    p.add_argument("--height", default=64, type=int,
                   help="synthetic-stream image height")
    p.add_argument("--width", default=128, type=int)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                   help="compute dtype of the net (the head stays f32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.data.kitti_motion import (
        KITTIMotionDataset, synthetic_motion_batches)
    from sndepth_tpu_torch.data.kitti_sequence import batch_iterator
    from sndepth_tpu_torch.train import loop, motion

    if os.path.isdir(os.path.join(args.data_dir, "train", "label")):
        ds = KITTIMotionDataset(args.data_dir, train=True)
        h, w = ds[0]["image"].shape[:2]
        steps_per_epoch = max(len(ds) // args.batch_size, 1)
        max_steps = args.max_steps or steps_per_epoch * args.epochs
        batches = batch_iterator(ds, args.batch_size, shuffle=True,
                                 loop=True)
        print(f"training on {len(ds)} samples at {h}x{w}")
    else:
        max_steps = args.max_steps or 200
        batches = synthetic_motion_batches(args.batch_size, args.height,
                                           args.width)
        print("no dataset found; training on synthetic stream")

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    state = motion.create_train_state(device=args.device, dtype=dtype)
    records = loop.run_steps(lambda b: motion.train_step(state, b), batches,
                             max_steps, device=args.device,
                             log_every=args.log_every)
    print(f"checkpoint -> "
          f"{loop.save_motion_checkpoint(state, args.ckpt_dir)}")
    return state, records


if __name__ == "__main__":
    main()
