"""CLI: MotionFusionNet mean-IoU evaluation on one device.

The flags and output of ``python -m sndepth_tpu.cli.evaluate_motion``, plus
``--device``: the 3-class mIoU of each batch of the KITTIMotion ``val``
split, averaged over the batches (reference `evaluate.py:29-44`; a batch
whose mIoU is NaN adds nothing but is counted). ``--ckpt_dir`` is a
``train_motion`` checkpoint directory (its ``motion.pth``) or a state dict
file in the reference's key names, such as its ``best.pt``.

Usage:
    python -m sndepth_tpu_torch.cli.evaluate_motion --data_dir data/imgs \
        --ckpt_dir checkpoints/motion
"""

from __future__ import annotations

import argparse
import math


def main(argv=None) -> dict:
    """Evaluate; returns ``{"miou"}``."""
    p = argparse.ArgumentParser(description="Motion segmentation eval")
    p.add_argument("--data_dir", default="data/imgs")
    p.add_argument("--ckpt_dir", default="checkpoints/motion")
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--metrics_json", default=None,
                   help="also dump the metrics as JSON (one object)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.data.kitti_motion import KITTIMotionDataset
    from sndepth_tpu_torch.data.kitti_sequence import batch_iterator
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.models.motionseg import MotionFusionNet
    from sndepth_tpu_torch.train import loop, motion

    device = torch.device(args.device)
    ds = KITTIMotionDataset(args.data_dir, train=False)
    model = MotionFusionNet()
    model.load_state_dict(loop.load_motion_weights(args.ckpt_dir))
    model.to(device)

    total, count = 0.0, 0
    for batch in batch_iterator(ds, args.batch_size, shuffle=False,
                                drop_last=False):
        miou = float(motion.eval_step(model, to_device(batch, device))[
            "miou"])
        if not math.isnan(miou):
            total += miou
        count += 1
    metrics = {"miou": total / max(count, 1)}
    print(f"mIoU:{metrics['miou']}")
    if args.metrics_json:
        import json
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
