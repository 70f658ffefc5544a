"""CLI: GeoNet depth, NNET normals and refined depth, then frame-pair RAFT3D
scene flow, on one device.

The flags and artifacts of ``python -m sndepth_tpu.cli.predict_raft3d``
(reference `predict_raft3d.py:36-58`), plus ``--device``:
each batch of the synthetic stream (the JAX CLI reads no other frames;
``--root`` and ``--synthetic`` are taken as it takes them) goes through
:class:`~sndepth_tpu_torch.pipelines.GeoNetStage` (float32),
:class:`~sndepth_tpu_torch.pipelines.NNETStage` (bf16 convolution stacks,
as the JAX stage's default) fed GeoNet's depth as its log2-depth argument,
as the JAX CLI feeds it, and :class:`~sndepth_tpu_torch.pipelines.
RAFT3DStage` (``--dtype``) on the target and the first source frame with
the refined depth clipped to [0.1, 80] for both frames. Writes
``tau_{i}.png``, ``phi_{i}.png`` and ``depth_{i}.png`` under ``--out_dir``.
Every stage's weights are random, from fixed seeds (GeoNet from the
config's, NNET and RAFT3D from 0), and the stream's seed is 0.

Usage:
    python -m sndepth_tpu_torch.cli.predict_raft3d --synthetic \
        --max_batches 2
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> list[dict]:
    """Run the pipeline; returns, for each batch, the paths it wrote, the
    shapes of the field and the batch's host time in ms (on a CUDA device,
    up to the card's end of it)."""
    p = argparse.ArgumentParser(description="GeoNet+NNET+RAFT3D pipeline")
    p.add_argument("--root", default="data/raft_datasets")
    p.add_argument("--out_dir", default="outputs/predict_raft3d")
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--iters", default=16, type=int)
    p.add_argument("--max_batches", default=1, type=int)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="RAFT3D encoder/GRU compute dtype (corr/GN/SE3 "
                        "stay f32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import time

    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.pipelines import (GeoNetStage, NNETStage,
                                             RAFT3DStage)
    from sndepth_tpu_torch.utils.visualize import save_image

    b, h, w = 1, args.img_height, args.img_width
    device = torch.device(args.device)
    config = GeoNetConfig(batch_size=b, img_height=h, img_width=w,
                          compute_dtype=torch.float32)
    geonet = GeoNetStage(config, device=device)
    nnet = NNETStage(device=device)
    raft3d = RAFT3DStage(iters=args.iters, device=device,
                         dtype=torch.bfloat16 if args.dtype == "bf16"
                         else torch.float32)

    it = synthetic_batches(b, h, w)
    os.makedirs(args.out_dir, exist_ok=True)
    k = torch.tensor([[w * 0.58, h * 1.92, w / 2.0, h / 2.0]], device=device)
    written = []
    for i in range(args.max_batches):
        batch = next(it)
        t0 = time.perf_counter()
        g = geonet(batch)
        img1 = (g["tgt_norm"] + 1.0) * 0.5
        img2 = (g["src_norm"][:, :3] + 1.0) * 0.5
        refined = nnet(g["depth"], img1)
        depth1 = refined["depth"][..., 0].float().clamp(0.1, 80.0)
        Ts, tau_phi = raft3d(img1, img2, depth1, depth1, k)
        tau_phi = tau_phi[0].cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        paths = {name: os.path.join(args.out_dir, f"{name}_{i}.png")
                 for name in ("tau", "phi", "depth")}
        save_image(paths["tau"], tau_phi[..., :3])
        save_image(paths["phi"], tau_phi[..., 3:])
        save_image(paths["depth"], depth1[0].cpu().numpy())
        print(f"frame {i}: Ts field {tuple(Ts.shape)}, tau/phi saved",
              flush=True)
        written.append({"paths": paths, "Ts": tuple(Ts.shape),
                        "tau_phi": tau_phi.shape, "ms": ms})
    return written


if __name__ == "__main__":
    main()
