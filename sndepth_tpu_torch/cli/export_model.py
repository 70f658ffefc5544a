"""CLI: export an inference model as a serving artifact
(``serving/export.py``: ``model.pt2`` and ``meta.json``).

The flags of ``python -m sndepth_tpu.cli.export_model``, with ``--device``
for its ``--platform``: the artifact runs on the device it was exported on
(exporting for ``cuda`` needs the card). Layouts are the port's: images
(B, 3, H, W) for ``dispnet`` (the finest disparity out, (B, 1, H, W)),
(B, H, W, 3) for ``nnet`` (the finest normal map and its concentration
out, (B, H, W, 4)), and for ``raft3d`` two (B, 3, H, W) images in
[0, 1], two (B, H, W) depths and (B, 4) intrinsics (the SE3 field out,
(B, H, W, 7)). ``--ckpt_dir`` reads the port's checkpoints: the latest
``step_*.pt`` of ``cli/train_geonet`` (or of ``cli/convert_weights
geonet``), ``nnet.pth``, ``raft3d.pth``; without it the weights are random
from a seed.

Usage:
    python -m sndepth_tpu_torch.cli.export_model --model raft3d \\
        --out_dir artifacts/raft3d --ckpt_dir checkpoints/raft3d
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.nn as nn


class DispFinest(nn.Module):
    """DispNetS's finest disparity."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, img):
        return self.net(img)[0]


class NormalsTest(nn.Module):
    """NormalNet in test mode: its finest map."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, rgb):
        return self.net(rgb, "test")[-1]


class SceneFlow(nn.Module):
    """RAFT3D's SE3 field after ``iters`` refinements."""

    def __init__(self, net, iters: int):
        super().__init__()
        self.net, self.iters = net, iters

    def forward(self, image1, image2, depth1, depth2, intrinsics):
        return self.net(image1, image2, depth1, depth2, intrinsics,
                        iters=self.iters)


def build(model: str, b: int, h: int, w: int, iters: int = 16,
          ckpt_dir: str | None = None, seed: int = 0):
    """(serving module, example inputs) of ``model`` on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    if model == "dispnet":
        from sndepth_tpu_torch.models.dispnet import DispNetS, init_weights
        from sndepth_tpu_torch.train import checkpoint as ckpt_lib
        net = DispNetS(dtype=torch.bfloat16)
        init_weights(net, gen)
        if ckpt_dir:
            net.load_state_dict(ckpt_lib.restore_checkpoint(ckpt_dir)
                                ["disp_net"])
        return DispFinest(net), [torch.rand(b, 3, h, w, generator=gen)
                                 * 2.0 - 1.0]
    if model == "nnet":
        from sndepth_tpu_torch.models import nnet as nnet_lib
        from sndepth_tpu_torch.train.loop import NNET_MODEL_FILE
        from sndepth_tpu_torch.train.nnet import NormalNet
        net = NormalNet(torch.bfloat16)
        nnet_lib.init_weights(net, gen)
        if ckpt_dir:
            net.load_state_dict(torch.load(
                os.path.join(ckpt_dir, NNET_MODEL_FILE), map_location="cpu",
                weights_only=True))
        return NormalsTest(net), [torch.rand(b, h, w, 3, generator=gen)
                                  * 255.0]
    from sndepth_tpu_torch.cli.kitti_submission import load_raft3d_checkpoint
    from sndepth_tpu_torch.models import raft3d
    net = raft3d.RAFT3D()
    raft3d.init_weights(net, gen)
    if ckpt_dir:
        load_raft3d_checkpoint(net, os.path.join(ckpt_dir, "raft3d.pth"))
    img = lambda: torch.rand(b, 3, h, w, generator=gen)  # noqa: E731
    depth = lambda: 2.0 + torch.rand(b, h, w, generator=gen)  # noqa: E731
    k = torch.tensor([[w * 0.58, w * 0.58, w / 2, h / 2]]).expand(b, 4)
    return SceneFlow(net, iters), [img(), img(), depth(), depth(),
                                   k.contiguous()]


def main(argv=None) -> str:
    """Export; returns the artifact directory."""
    p = argparse.ArgumentParser(description="Export a serving artifact")
    p.add_argument("--model", choices=["dispnet", "nnet", "raft3d"],
                   default="dispnet")
    p.add_argument("--iters", default=16, type=int,
                   help="RAFT3D refinement iterations (raft3d export)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--batch", default=1, type=int)
    p.add_argument("--device", default="cuda",
                   help="device the artifact runs on (cuda, cpu)")
    p.add_argument("--ckpt_dir", default=None,
                   help="restore the weights from a checkpoint directory "
                        "(cli/train_geonet for dispnet, cli/train_nnet for "
                        "nnet, cli/train_raft3d for raft3d; default: "
                        "random from a seed)")
    args = p.parse_args(argv)

    from sndepth_tpu_torch.serving import export as sx
    b, h, w = args.batch, args.img_height, args.img_width
    module, inputs = build(args.model, b, h, w, args.iters, args.ckpt_dir)
    out = sx.save_artifact(args.out_dir, module, inputs, args.device)
    print(f"exported {args.model} ({b}x{h}x{w}"
          + (f", {args.iters} iters" if args.model == "raft3d" else "")
          + f") on {args.device} -> {out}")
    return out


if __name__ == "__main__":
    main()
