"""CLI: the RAFT3D demo on one frame pair: saves the tau / phi panel of the
scene flow.

The flags and artifact of ``python -m sndepth_tpu.cli.demo`` (reference
`demo.py:52-92`), plus ``--device``. Two images and their depths (png or
pfm, through :func:`~sndepth_tpu_torch.data.frame_codecs.read_gen`; a
missing first depth is 4 everywhere, a missing second one the first), edge
padded to multiples of 8, or without images a synthetic pair (a seeded
64x96 image and the same rolled by 3 columns, depth 4), go through
:class:`~sndepth_tpu_torch.pipelines.RAFT3DStage` (float32, random weights
from seed 0, ``--iters`` iterations; on the card the Gauss-Newton build and
the depth sampler run as kernels) with the intrinsics
[0.6 W, 0.6 W, W / 2, H / 2]. The saved png holds tau (the translation
part of the field's logarithm) beside phi (its rotation), each min-max
normalised.

Usage:
    python -m sndepth_tpu_torch.cli.demo
    python -m sndepth_tpu_torch.cli.demo --image1 a.png --image2 b.png \
        --depth1 a.pfm --depth2 b.pfm
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _inputs(args):
    """(img1, img2) (H, W, 3) in [0, 1] and (depth1, depth2) (H, W), H and
    W multiples of 8."""
    from sndepth_tpu_torch.data.frame_codecs import read_gen
    if not (args.image1 and args.image2):
        rng = np.random.RandomState(0)
        img1 = rng.rand(64, 96, 3).astype(np.float32)
        d1 = np.full((64, 96), 4.0, np.float32)
        return img1, np.roll(img1, 3, axis=1), d1, d1
    img1 = np.asarray(read_gen(args.image1), np.float32) / 255.0
    img2 = np.asarray(read_gen(args.image2), np.float32) / 255.0
    d1 = (np.asarray(read_gen(args.depth1), np.float32) if args.depth1
          else np.full(img1.shape[:2], 4.0, np.float32))
    d2 = np.asarray(read_gen(args.depth2), np.float32) if args.depth2 else d1
    h, w = img1.shape[:2]
    pad = ((0, -h % 8), (0, -w % 8))
    return (np.pad(img1, pad + ((0, 0),), mode="edge"),
            np.pad(img2, pad + ((0, 0),), mode="edge"),
            np.pad(d1, pad, mode="edge"), np.pad(d2, pad, mode="edge"))


def main(argv=None) -> dict:
    """Run the demo; returns the panel's path, tau / phi (H, W, 6) and the
    frame's host time in ms (on a CUDA device, up to the card's end of
    it)."""
    p = argparse.ArgumentParser(description="RAFT3D demo")
    p.add_argument("--image1", default=None)
    p.add_argument("--image2", default=None)
    p.add_argument("--depth1", default=None)
    p.add_argument("--depth2", default=None)
    p.add_argument("--iters", default=16, type=int)
    p.add_argument("--out", default="demo_output_raft3d.png")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from sndepth_tpu_torch.pipelines import RAFT3DStage
    from sndepth_tpu_torch.utils.visualize import normalize01

    img1, img2, d1, d2 = _inputs(args)
    hh, ww = img1.shape[:2]
    device = torch.device(args.device)
    stage = RAFT3DStage(iters=args.iters, device=device)
    image = lambda a: torch.from_numpy(a).permute(2, 0, 1)[None]
    k = torch.tensor([[ww * 0.6, ww * 0.6, ww / 2.0, hh / 2.0]])
    t0 = time.perf_counter()
    _, tau_phi = stage(image(img1), image(img2), torch.from_numpy(d1)[None],
                       torch.from_numpy(d2)[None], k)
    tau_phi = tau_phi[0].cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    panel = np.concatenate([normalize01(tau_phi[..., :3]),
                            normalize01(tau_phi[..., 3:])], axis=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    Image.fromarray((panel * 255).astype(np.uint8)).save(args.out)
    print(f"saved {args.out}; tau range [{float(tau_phi[..., :3].min()):.4f}, "
          f"{float(tau_phi[..., :3].max()):.4f}]")
    return {"path": args.out, "tau_phi": tau_phi, "ms": ms}


if __name__ == "__main__":
    main()
