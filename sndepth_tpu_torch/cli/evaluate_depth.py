"""CLI: Eigen-style depth evaluation (reference `models/test_disp.py`).

The flags and output of ``python -m sndepth_tpu.cli.evaluate_depth``, plus
``--device``: run DispNetS over test frames (or read precomputed
disparities), zoom each prediction to the ground truth's size, scale it by
the ratio of medians, clip to [min_depth, max_depth] and print the 9-metric
table in the reference's format (`test_disp.py:118-123`).

Ground truth: an ``.npz`` with ``gt_depths`` (a list or array of H x W
depth maps) and optional ``masks``. Predictions: ``--pred_file`` (a
disparity ``.npy``), or DispNetS from ``--ckpt_dir`` (the newest
``step_*.pt`` that ``train_geonet`` wrote; random weights from the config's
seed without it) over the frames listed in ``--img_list``.

Usage:
    python -m sndepth_tpu_torch.cli.evaluate_depth --gt_file gt.npz \
        --img_list test_files.txt --ckpt_dir checkpoints/geonet
"""

from __future__ import annotations

import argparse
import os

import numpy as np

ERROR_NAMES = ("abs_diff", "abs_rel", "sq_rel", "rms", "log_rms",
               "abs_log", "a1", "a2", "a3")


def predict_disparities(ckpt_dir: str | None, image_paths: list[str],
                        img_height: int, img_width: int,
                        device="cuda") -> np.ndarray:
    """Finest DispNetS disparity (N, H, W) of each frame, float32."""
    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.kitti_sequence import EvalSequenceDataset
    from sndepth_tpu_torch.train import geonet, loop

    device = torch.device(device)
    config = GeoNetConfig(img_height=img_height, img_width=img_width,
                          compute_dtype=torch.float32)
    state = geonet.create_train_state(config, device)
    path = loop.latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if path is not None:
        loop.restore_checkpoint(state, path)
    else:
        print("warning: no checkpoint; evaluating random weights")
    net = state.disp_net.eval()
    ds = EvalSequenceDataset(image_paths, img_width, img_height)
    disps = []
    with torch.no_grad():
        for i in range(len(ds)):
            tgt = torch.from_numpy(ds[i]["tgt"]).to(device)
            x = (tgt.float() / 255.0 * 2.0 - 1.0).permute(2, 0, 1)[None]
            disps.append(net(x)[0][0, 0].cpu().numpy())
    return np.stack(disps)


def main(argv=None) -> dict:
    """Evaluate; returns the mean metrics by name."""
    p = argparse.ArgumentParser(description="KITTI Eigen depth evaluation")
    p.add_argument("--gt_file", required=True,
                   help=".npz with gt_depths (and optional masks)")
    p.add_argument("--pred_file", default=None,
                   help="precomputed disparities .npy (else run the net)")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--img_list", default=None,
                   help="txt file of test image paths")
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--min_depth", default=1e-3, type=float)
    p.add_argument("--max_depth", default=80.0, type=float)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--metrics_json", default=None,
                   help="also dump the mean metrics as JSON (one object)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the net (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    from scipy.ndimage import zoom

    from sndepth_tpu_torch.utils.metrics import compute_depth_errors

    gt_data = np.load(args.gt_file, allow_pickle=True)
    gt_depths = gt_data["gt_depths"]
    masks = gt_data["masks"] if "masks" in gt_data else None

    if args.pred_file:
        pred_disps = np.load(args.pred_file)
    else:
        with open(args.img_list) as f:
            paths = [line.strip() for line in f if line.strip()]
        pred_disps = predict_disparities(args.ckpt_dir, paths,
                                         args.img_height, args.img_width,
                                         args.device)

    errors = []
    for i, gt in enumerate(gt_depths):
        gt = np.asarray(gt, np.float32)
        pred_depth = 1.0 / np.maximum(pred_disps[i], 1e-12)
        zoomed = zoom(pred_depth, (gt.shape[0] / pred_depth.shape[0],
                                   gt.shape[1] / pred_depth.shape[1]))
        zoomed = zoomed.clip(args.min_depth, args.max_depth)
        if masks is not None:
            m = np.asarray(masks[i], bool)
            gt_v, pred_v = gt[m], zoomed[m]
        else:
            valid = gt > args.min_depth
            gt_v, pred_v = gt[valid], zoomed[valid]
        scale = np.median(gt_v) / np.median(pred_v)
        e = compute_depth_errors(gt_v, pred_v * scale)
        errors.append([float(e[k]) for k in ERROR_NAMES])

    mean_errors = np.mean(errors, axis=0)
    print("Results with scale factor determined by GT/prediction ratio "
          "(like the original paper) : ")
    print(("{:>10}, " * 9).format(*ERROR_NAMES).rstrip(", "))
    print(("{:10.4f}, " * 9).format(*mean_errors).rstrip(", "))
    metrics = {k: float(v) for k, v in zip(ERROR_NAMES, mean_errors)}
    if args.metrics_json:
        import json
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "predictions.npy"), pred_disps)
    return metrics


if __name__ == "__main__":
    main()
