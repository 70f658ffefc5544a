"""CLI: GeoNet depth -> NNET refined depth -> the AutoencoderKL's RGBD
latents, on one device.

The flags and artifacts of ``python -m sndepth_tpu.cli.predict_vae``
(reference `predict_vae.py:54-63`), plus ``--device``. Each batch (B = 1) of
the seeded synthetic stream goes through
:class:`~sndepth_tpu_torch.pipelines.GeoNetStage` (float32),
:class:`~sndepth_tpu_torch.pipelines.NNETStage` fed GeoNet's depth and the
target image in [0, 1], and :class:`~sndepth_tpu_torch.pipelines.VAEStage`,
which encodes the image with NNET's refined depth; the posterior's mean is
saved as ``latent_mean_{i}.npy`` (1, H/8, W/8, 4) under ``--out_dir``.
Weights are random from fixed seeds (GeoNet from the config's, NNET and the
autoencoder from 0).

Usage:
    python -m sndepth_tpu_torch.cli.predict_vae --max_batches 2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> list[dict]:
    """Run the pipeline; returns, for each batch, the saved path, the
    latent mean and the batch's host time in ms (on a CUDA device, up to
    the card's end of it)."""
    p = argparse.ArgumentParser(description="GeoNet+NNET+VAE pipeline")
    p.add_argument("--out_dir", default="outputs/predict_vae")
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--max_batches", default=1, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.pipelines import GeoNetStage, NNETStage, VAEStage

    device = torch.device(args.device)
    b, h, w = 1, args.img_height, args.img_width
    config = GeoNetConfig(batch_size=b, img_height=h, img_width=w,
                          compute_dtype=torch.float32)
    geonet = GeoNetStage(config, device=device)
    nnet = NNETStage(device=device)
    vae = VAEStage(device=device)

    it = synthetic_batches(b, h, w)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for i in range(args.max_batches):
        batch = next(it)
        t0 = time.perf_counter()
        g = geonet(batch)
        rgb01 = (g["tgt_norm"] + 1.0) * 0.5
        refined = nnet(g["depth"], rgb01)
        mean, _ = vae(rgb01, refined["depth"][..., 0].float())
        mean = mean.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(args.out_dir, f"latent_mean_{i}.npy")
        np.save(path, mean)
        print(f"frame {i}: latent {mean.shape}", flush=True)
        written.append({"path": path, "mean": mean, "ms": ms})
    return written


if __name__ == "__main__":
    main()
