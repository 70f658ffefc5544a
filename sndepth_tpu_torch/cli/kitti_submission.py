"""CLI: RAFT3D KITTI scene-flow submission writer.

The flags and artifacts of ``python -m sndepth_tpu.cli.kitti_submission``,
plus ``--device``: iterate ``{root}/testing/seq``, run ``--iters``
refinement iterations on each frame and its successor, and write the
flow / T / tau / phi artifacts under ``--out_dir``. Depths are a constant
plane of 4, as in the JAX CLI (the reference substitutes external disparity
sources there). Without ``--ckpt_dir`` the weights are random from a seed.

``--ckpt_dir`` holds ``raft3d.pth``: a state_dict of
:class:`sndepth_tpu_torch.models.raft3d.RAFT3D`, bare or under ``"model"`` or
``"state_dict"``, with or without ``module.`` prefixes (a reference
checkpoint loads as it is; its keys that the model does not have are
ignored, a key the model lacks is an error).

``--data_parallel`` under torchrun (``torchrun --nproc_per_node N -m
sndepth_tpu_torch.cli.kitti_submission --data_parallel ...``): rank r of W
takes frames r, r + W, ... and writes their artifacts, so the ranks
together write the files one process writes. Without a process group it is
the one-process run, as the JAX CLI is on one device.

Usage:
    python -m sndepth_tpu_torch.cli.kitti_submission --root data/raft_datasets
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_raft3d_checkpoint(model, path: str) -> None:
    """Load the checkpoint at ``path`` into ``model`` (see the module
    docstring for the forms it takes)."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} keys of the model, "
                       f"the first: {missing[0]}")


def main(argv=None) -> int:
    """Run the writer; returns the number of frames this process
    wrote."""
    p = argparse.ArgumentParser(description="RAFT3D KITTI submission")
    p.add_argument("--root", default="data/raft_datasets")
    p.add_argument("--out_dir", default="outputs/raft3d")
    p.add_argument("--iters", default=16, type=int)
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--max_frames", default=0, type=int)
    p.add_argument("--ckpt_dir", default=None,
                   help="directory holding raft3d.pth (optional)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="RAFT3D encoder/GRU compute dtype")
    p.add_argument("--data_parallel", action="store_true",
                   help="share the frames among the ranks of a torchrun "
                        "group (the reference wraps the model in "
                        "torch.nn.DataParallel here, "
                        "`kitti_submission.py:196`)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.parallel import multihost

    from sndepth_tpu_torch.data.raft3d_kitti import (KITTIEvalDataset,
                                                     write_prediction)
    from sndepth_tpu_torch.ops.projective import induced_flow
    from sndepth_tpu_torch.pipelines import RAFT3DStage

    ds = KITTIEvalDataset(args.root, args.img_width, args.img_height)
    if len(ds) == 0:
        print(f"no frames under {args.root}/testing/seq — nothing to do")
        return 0

    rank, world = 0, 1
    if args.data_parallel:
        multihost.initialize_multihost(device=args.device)
        rank, world = multihost.rank(), multihost.world_size()
        if rank == 0:
            print(f"data-parallel over {world} process(es)")
    stage = RAFT3DStage(
        iters=args.iters, device=multihost.local_device(args.device),
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32)
    if args.ckpt_dir:
        load_raft3d_checkpoint(stage.model,
                               os.path.join(args.ckpt_dir, "raft3d.pth"))
    h, w = args.img_height, args.img_width
    depth = torch.full((1, h, w), 4.0, device=stage.device)

    n = min(len(ds), args.max_frames) if args.max_frames else len(ds)
    mine = range(rank, n, world)
    for i in mine:
        sample = ds[i]
        img1 = torch.from_numpy(sample["tgt"]).permute(2, 0, 1)[None]
        img2 = torch.from_numpy(
            np.ascontiguousarray(sample["src"][..., 3:])).permute(2, 0, 1)[None]
        k = torch.from_numpy(sample["intrinsics"])[None].to(stage.device)
        Ts, tau_phi = stage(img1.float() / 255.0, img2.float() / 255.0,
                            depth, depth, k)
        flow2d, _, _ = induced_flow(Ts, depth, k)
        Ts, tau_phi, flow2d = (t[0].cpu().numpy()
                               for t in (Ts, tau_phi, flow2d))
        write_prediction(args.out_dir, i, flow2d[..., :2], Ts,
                         tau_phi[..., :3], tau_phi[..., 3:])
        print(f"[{i + 1}/{n}] wrote prediction", flush=True)
    return len(mine)


if __name__ == "__main__":
    main()
