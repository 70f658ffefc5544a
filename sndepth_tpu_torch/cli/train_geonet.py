"""CLI: self-supervised GeoNet stage-1 training on one GPU.

The flags and defaults of ``python -m sndepth_tpu.cli.train_geonet``
(reference `models/baseline.py:43-123`), plus ``--device``. Without
``--data_dir`` (or if its index file is missing) it trains on the
synthetic stream.

Usage:
    python -m sndepth_tpu_torch.cli.train_geonet --max_steps 20
    python -m sndepth_tpu_torch.cli.train_geonet --data_dir /path/to/kitti \
        --ckpt_dir ckpts --graphs_dir logs --epochs 30
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GeoNet self-supervised training")
    p.add_argument("--data_dir", default=None,
                   help="KITTI formatted_data root containing train.txt")
    p.add_argument("--ckpt_dir", default="checkpoints/geonet")
    p.add_argument("--graphs_dir", default="logs/geonet")
    p.add_argument("--sequence_length", default=3, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--max_steps", default=0, type=int,
                   help="override epochs with a fixed step count")
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--num_scales", default=4, type=int)
    p.add_argument("--seed", default=8964, type=int)
    p.add_argument("--simi_alpha", default=0.85, type=float)
    p.add_argument("--loss_weight_rigid_warp", default=1.0, type=float)
    p.add_argument("--loss_weight_disparity_smooth", default=0.5, type=float)
    p.add_argument("--learning_rate", default=2e-4, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--beta", default=0.999, type=float)
    p.add_argument("--output_ckpt_iter", default=5000, type=int)
    p.add_argument("--log_every", default=100, type=int)
    p.add_argument("--data_workers", default=8, type=int)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile_at", default=0, type=int,
                   help="trace this step with torch.profiler (0 = off): "
                        "a Chrome trace in <graphs_dir>/trace and the "
                        "kernel time by group on stdout")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    return p


def main(argv=None):
    """Train; returns (final TrainState, logged metric records)."""
    args = build_parser().parse_args(argv)

    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.prefetch import threaded_batches
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.train.loop import train_geonet

    config = GeoNetConfig(
        sequence_length=args.sequence_length, batch_size=args.batch_size,
        img_height=args.img_height, img_width=args.img_width,
        num_scales=args.num_scales, seed=args.seed,
        simi_alpha=args.simi_alpha,
        loss_weight_rigid_warp=args.loss_weight_rigid_warp,
        loss_weight_disparity_smooth=args.loss_weight_disparity_smooth,
        learning_rate=args.learning_rate, adam_beta1=args.momentum,
        adam_beta2=args.beta, epochs=args.epochs,
        compute_dtype=(torch.bfloat16 if args.dtype == "bfloat16"
                       else torch.float32))

    if args.data_dir and os.path.exists(
            os.path.join(args.data_dir, "train.txt")):
        from sndepth_tpu_torch.data.kitti_sequence import (SequenceDataset,
                                                           batch_iterator)
        dataset = SequenceDataset(
            args.data_dir, "train", args.sequence_length, args.img_width,
            args.img_height, seed=args.seed)
        steps_per_epoch = max(len(dataset) // args.batch_size, 1)
        max_steps = args.max_steps or steps_per_epoch * args.epochs

        def make_iter(seed=args.seed):
            return batch_iterator(dataset, args.batch_size, shuffle=True,
                                  seed=seed, loop=True)

        batches = threaded_batches(make_iter,
                                   num_threads=max(args.data_workers, 1))
        print(f"training on {len(dataset)} sequences "
              f"({steps_per_epoch} steps/epoch)")
    else:
        max_steps = args.max_steps or 1000
        print("no --data_dir index found; training on synthetic stream")
        batches = synthetic_batches(args.batch_size, args.img_height,
                                    args.img_width,
                                    num_source=args.sequence_length - 1,
                                    seed=args.seed)

    return train_geonet(config, batches, max_steps, device=args.device,
                        ckpt_dir=args.ckpt_dir, log_dir=args.graphs_dir,
                        log_every=args.log_every,
                        ckpt_every=args.output_ckpt_iter, resume=args.resume,
                        profile_at=args.profile_at or None)


if __name__ == "__main__":
    main()
