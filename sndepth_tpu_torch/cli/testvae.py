"""CLI: the AutoencoderKL smoke test (reference `testvae.py:162-166`).

The flags and output of ``python -m sndepth_tpu.cli.testvae``, plus
``--device``: encodes a random 4-channel batch (standard normal, seed 0)
with the reference's RGBD autoencoder in float32 and random weights (seed
1), and prints the shapes of the posterior's mean and variance, each
(B, 4, H/8, W/8).

Usage:
    python -m sndepth_tpu_torch.cli.testvae
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Returns the posterior's ``mean`` and ``var``."""
    p = argparse.ArgumentParser(description="AutoencoderKL smoke test")
    p.add_argument("--batch", default=4, type=int)
    p.add_argument("--height", default=128, type=int)
    p.add_argument("--width", default=416, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.models.vae import get_autoencoder
    from sndepth_tpu_torch.ops.layers import init_weights

    device = torch.device(args.device)
    model = get_autoencoder()
    init_weights(model, torch.Generator().manual_seed(1))
    model.to(device).eval()
    x = torch.randn(args.batch, 4, args.height, args.width,
                    generator=torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        posterior = model.encode(x)
    print("posterior mean:", tuple(posterior.mean.shape))
    print("posterior var:", tuple(posterior.var.shape))
    return {"mean": posterior.mean, "var": posterior.var}


if __name__ == "__main__":
    main()
