"""CLI: the fused prediction on one device: GeoNet depth and pose -> NNET
normals and refined depth -> optical flow -> MotionFusionNet segmentation.

The flags and artifacts of ``python -m sndepth_tpu.cli.predict`` (reference
`predict.py:40-85`), plus ``--device``. Each batch, of the RAFT3D-style
test tree ``{root}/testing/seq/*.png`` or, with ``--synthetic`` or without
that tree, of the seeded synthetic stream, goes through
:class:`~sndepth_tpu_torch.pipelines.GeoNetStage` (float32),
:class:`~sndepth_tpu_torch.pipelines.NNETStage` (bf16 convolution stacks)
fed GeoNet's depth as its log2-depth argument, a dense flow, its HSV
colouring, and :class:`~sndepth_tpu_torch.pipelines.MotionStage`. The flow
(``--flow_source``) is the rigid flow of the first source's pose over NNET's
refined depth (``rigid``, the default), or the optical flow of
:class:`~sndepth_tpu_torch.pipelines.Raft2DFlowStage` (``raft2d``, the
native RAFT2D; ``raft2d_large``, torchvision's ``raft_large``, whose
windowed lookup launches the gather kernel 4 times an iteration on the
card) from the target frame to the second source frame, both in [0, 1],
``--raft2d_iters`` iterations. The joins are the JAX CLI's: the intrinsics
are the batch's 3x3 ones where it has them, else (the test tree's
4-vectors) a K made from the image size; ``poses.csv`` holds the last
batch's poses. Writes ``depth_{i}.png``, ``norm_{i}.png``, ``flow_{i}.png``
and ``seg_{i}.png`` under ``--out_dir``.

Weights: GeoNet from the newest ``train_geonet`` checkpoint in
``--geonet_ckpt``, MotionFusionNet from ``--motion_ckpt`` (a
``train_motion`` directory or a reference state dict) and RAFT2DLarge from
``--raft2d_ckpt`` (a torchvision ``raft_large`` ``.pth``), else random from
fixed seeds (GeoNet from the config's, NNET, RAFT2D and MotionFusionNet
from 0).

Usage:
    python -m sndepth_tpu_torch.cli.predict --synthetic --max_batches 2
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _batches(args):
    if not args.synthetic and os.path.isdir(
            os.path.join(args.root, "testing", "seq")):
        from sndepth_tpu_torch.data.kitti_sequence import batch_iterator
        from sndepth_tpu_torch.data.raft3d_kitti import KITTIEvalDataset
        ds = KITTIEvalDataset(args.root, args.img_width, args.img_height)
        yield from batch_iterator(ds, args.batch_size, shuffle=False,
                                  drop_last=False)
    else:
        from sndepth_tpu_torch.data.synthetic import synthetic_batches
        it = synthetic_batches(args.batch_size, args.img_height,
                               args.img_width)
        for _ in range(args.max_batches or 1):
            yield next(it)


def main(argv=None) -> list[dict]:
    """Run the pipeline; returns, for each batch, the paths it wrote, the
    class map and the batch's host time in ms (on a CUDA device, up to the
    card's end of it)."""
    p = argparse.ArgumentParser(description="fused predict pipeline")
    p.add_argument("--root", default="data/raft_datasets")
    p.add_argument("--out_dir", default="outputs/predict")
    p.add_argument("--geonet_ckpt", default=None)
    p.add_argument("--motion_ckpt", default=None)
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--max_batches", default=0, type=int)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--flow_source", default="rigid",
                   choices=["rigid", "raft2d", "raft2d_large"],
                   help="dense flow for motion fusion: pose-induced rigid "
                        "flow, the native RAFT2D, or the torchvision-"
                        "raft_large-compatible RAFT2DLarge")
    p.add_argument("--raft2d_iters", default=12, type=int)
    p.add_argument("--raft2d_ckpt", default=None,
                   help="torchvision raft_large .pth for --flow_source "
                        "raft2d_large")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    if args.raft2d_ckpt and args.flow_source != "raft2d_large":
        p.error("--raft2d_ckpt is a raft_large checkpoint: it needs "
                "--flow_source raft2d_large")

    import time

    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.ops.camera import compute_rigid_flow
    from sndepth_tpu_torch.pipelines import (GeoNetStage, MotionStage,
                                             NNETStage, Raft2DFlowStage)
    from sndepth_tpu_torch.train import loop
    from sndepth_tpu_torch.utils.weights import raft2d_large_checkpoint
    from sndepth_tpu_torch.utils.visualize import (flow_to_rgb, pose_to_csv,
                                                   save_image)

    device = torch.device(args.device)
    b, h, w = args.batch_size, args.img_height, args.img_width
    config = GeoNetConfig(batch_size=b, img_height=h, img_width=w,
                          compute_dtype=torch.float32)
    geonet_sd = None
    if args.geonet_ckpt:
        path = loop.latest_checkpoint(args.geonet_ckpt)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {args.geonet_ckpt}")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        geonet_sd = {k: ckpt[k] for k in ("disp_net", "pose_net")}
    geonet = GeoNetStage(config, geonet_sd, device=device)
    nnet = NNETStage(device=device)
    motion = MotionStage(loop.load_motion_weights(args.motion_ckpt)
                         if args.motion_ckpt else None, device=device)
    raft2d = None
    if args.flow_source != "rigid":
        raft2d = Raft2DFlowStage(
            raft2d_large_checkpoint(args.raft2d_ckpt)
            if args.raft2d_ckpt else None, iters=args.raft2d_iters,
            arch="large" if args.flow_source == "raft2d_large" else "native",
            device=device)

    os.makedirs(args.out_dir, exist_ok=True)
    written, poses = [], None
    for i, batch in enumerate(_batches(args)):
        if args.max_batches and i >= args.max_batches:
            break
        t0 = time.perf_counter()
        g = geonet(batch)
        rgb01 = (g["tgt_norm"] + 1.0) * 0.5
        n = nnet(g["depth"], rgb01)
        k = batch.get("intrinsics")
        if k is None or k.shape[-1] == 4:
            kmat = np.tile(np.array([[[w * 0.58, 0, w / 2],
                                      [0, h * 1.92, h / 2],
                                      [0, 0, 1]]], np.float32), (b, 1, 1))
        else:
            kmat = np.asarray(k)
        if raft2d is not None:
            flow = raft2d(rgb01, (g["src_norm"][:, 3:] + 1.0) * 0.5)
        else:
            flow = compute_rigid_flow(g["poses"][:, 0], n["depth"][..., 0],
                                      torch.as_tensor(kmat).to(device),
                                      False).permute(0, 2, 3, 1)
        flow = flow.cpu().numpy()
        flow_rgb = np.stack([flow_to_rgb(f) for f in flow])
        seg = motion(rgb01, torch.from_numpy(flow_rgb).permute(0, 3, 1, 2))
        seg = seg.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        depth = n["depth"].float().cpu().numpy()
        normals = n["normals"].float().cpu().numpy()
        paths = []
        for j in range(b):
            idx = i * b + j
            files = {name: os.path.join(args.out_dir, f"{name}_{idx}.png")
                     for name in ("depth", "norm", "flow", "seg")}
            save_image(files["depth"], depth[j])
            save_image(files["norm"], normals[j])
            save_image(files["flow"], flow[j])
            save_image(files["seg"], seg[j].astype(np.float32))
            paths.append(files)
        poses = g["poses"].cpu().numpy()
        print(f"batch {i}: wrote depth/norm/flow/seg", flush=True)
        written.append({"paths": paths, "seg": seg, "ms": ms})

    if poses is not None:
        pose_to_csv(poses, os.path.join(args.out_dir, "poses.csv"))
    print("done")
    return written


if __name__ == "__main__":
    main()
