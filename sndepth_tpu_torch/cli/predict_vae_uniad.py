"""CLI: the full perception pipeline on one device: GeoNet depth -> NNET
refined depth -> the AutoencoderKL's RGBD latents -> UniAD tracking, DINO
features and the pose denoiser.

The flags and artifacts of ``python -m sndepth_tpu.cli.predict_vae_uniad``
(reference `predict_vae_uniad.py:24-86`), plus ``--device``. Each frame (B
= 1) of the seeded synthetic stream goes through
:class:`~sndepth_tpu_torch.pipelines.GeoNetStage` (float32),
:class:`~sndepth_tpu_torch.pipelines.NNETStage` fed GeoNet's depth and the
target image in [0, 1], :class:`~sndepth_tpu_torch.pipelines.VAEStage`
(the image with NNET's refined depth) and
:class:`~sndepth_tpu_torch.pipelines.TrackStage`, which tracks the image as
the one camera of an identity ``lidar2img`` with its state carried from
frame to frame and denoises poses from the image's features. The frame's
track boxes (100, 9) go to ``track_boxes_{t}.npy`` under ``--out_dir``.
Weights are random from fixed seeds.

Usage:
    python -m sndepth_tpu_torch.cli.predict_vae_uniad --frames 2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> list[dict]:
    """Run the pipeline; returns, for each frame, the saved path, the
    latent's shape, the active tracks, the poses' shape and the frame's
    host time in ms (on a CUDA device, up to the card's end of it)."""
    p = argparse.ArgumentParser(description="GeoNet+VAE+UniAD pipeline")
    p.add_argument("--out_dir", default="outputs/predict_vae_uniad")
    p.add_argument("--img_height", default=64, type=int)
    p.add_argument("--img_width", default=64, type=int)
    p.add_argument("--frames", default=2, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.pipelines import (GeoNetStage, NNETStage,
                                             TrackStage, VAEStage)

    device = torch.device(args.device)
    b, h, w = 1, args.img_height, args.img_width
    config = GeoNetConfig(batch_size=b, img_height=h, img_width=w,
                          compute_dtype=torch.float32)
    geonet = GeoNetStage(config, device=device)
    nnet = NNETStage(device=device)
    vae = VAEStage(device=device)
    track = TrackStage(num_cams=1, image_hw=(h, w), device=device)

    it = synthetic_batches(b, h, w)
    os.makedirs(args.out_dir, exist_ok=True)
    state = track.init_state()
    l2i = torch.eye(4, device=device)[None, None]
    written = []
    for t in range(args.frames):
        batch = next(it)
        t0 = time.perf_counter()
        g = geonet(batch)
        rgb01 = (g["tgt_norm"] + 1.0) * 0.5
        refined = nnet(g["depth"], rgb01)
        mean, _ = vae(rgb01, refined["depth"][..., 0].float())
        state, results, poses = track(rgb01[None], l2i, state, rgb01)
        boxes = results["bboxes"].cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        n_active = int((state.tracks.obj_idxes >= 0).sum())
        print(f"frame {t}: latent {tuple(mean.shape)}, {n_active} active "
              f"tracks, denoised poses {tuple(poses.shape)}", flush=True)
        path = os.path.join(args.out_dir, f"track_boxes_{t}.npy")
        np.save(path, boxes)
        written.append({"path": path, "latent_shape": tuple(mean.shape),
                        "active_tracks": n_active,
                        "poses_shape": tuple(poses.shape), "ms": ms})
    print("done")
    return written


if __name__ == "__main__":
    main()
