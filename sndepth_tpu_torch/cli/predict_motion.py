"""CLI: motion segmentation of one image and its flow image.

The flags and output of ``python -m sndepth_tpu.cli.predict_motion``, plus
``--device`` (reference `predict_motion.py:13-34`): both images padded with
zeros to multiples of 16 for the stride-16 head, MotionFusionNet's class
map cropped back, blended half and half over the image in the class colours
(black, red, green) and saved to ``--out``; then the class histogram. The
weights come from ``--ckpt_dir`` (a ``train_motion`` directory or a state
dict file in the reference's key names), random from seed 0 with a warning
where there is none.

Usage:
    python -m sndepth_tpu_torch.cli.predict_motion image.png flow.png \
        --ckpt_dir checkpoints/motion
"""

from __future__ import annotations

import argparse

import numpy as np

CLASS_COLORS = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.uint8)


def main(argv=None) -> np.ndarray:
    """Segment; returns the class map (H, W)."""
    p = argparse.ArgumentParser(description="Motion segmentation demo")
    p.add_argument("image")
    p.add_argument("flow")
    p.add_argument("--ckpt_dir", default="checkpoints/motion")
    p.add_argument("--out", default="motion_pred.png")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from sndepth_tpu_torch.pipelines import MotionStage
    from sndepth_tpu_torch.train import loop

    img = np.asarray(Image.open(args.image).convert("RGB"),
                     np.float32) / 255.0
    flow = np.asarray(Image.open(args.flow).convert("RGB"),
                      np.float32) / 255.0
    h, w = img.shape[:2]
    ph, pw = -h % 16, -w % 16
    img_p = np.pad(img, ((0, ph), (0, pw), (0, 0)))
    flow_p = np.pad(flow, ((0, ph), (0, pw), (0, 0)))

    try:
        state_dict = loop.load_motion_weights(args.ckpt_dir)
    except FileNotFoundError:
        print("warning: no checkpoint found, using random init")
        state_dict = None
    stage = MotionStage(state_dict, device=args.device)
    pred = stage(*(torch.from_numpy(a).permute(2, 0, 1)[None]
                   for a in (img_p, flow_p)))
    pred = pred[0, :h, :w].cpu().numpy()
    overlay = (0.5 * img * 255 + 0.5 * CLASS_COLORS[pred]).astype(np.uint8)
    Image.fromarray(overlay).save(args.out)
    classes, counts = np.unique(pred, return_counts=True)
    print(f"saved {args.out}; class histogram: "
          f"{dict(zip(classes.tolist(), counts.tolist()))}")
    return pred


if __name__ == "__main__":
    main()
