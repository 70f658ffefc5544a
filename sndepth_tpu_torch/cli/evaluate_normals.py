"""CLI: surface-normal evaluation on NYUv2-format data.

The flags and output of ``python -m sndepth_tpu.cli.evaluate_normals``,
plus ``--device``; prints the reference's metric line
(`utils/utils_coders.py:88-100`): ``mean median rmse 5 7.5 11.25 22.5 30``.

Predictions: ``--pred_file`` (normals ``.npy``, (N, H, W, 3)), or the
EfficientNet-B5 encoder and the normal decoder run on each image. Their
weights: ``--ckpt_dir`` holds ``nnet.pth``, the NNET state_dict that
``utils.weights.nnet_state_dict_from_jax`` makes (``encoder.*`` with timm's
names, ``decoder.*``, ``refiner.*``), of which the encoder and the decoder
are read; random weights from seed 0 without it.

Usage:
    python -m sndepth_tpu_torch.cli.evaluate_normals --data_dir data/nyu \
        --ckpt_dir checkpoints/nnet
"""

from __future__ import annotations

import argparse
import os

import numpy as np

NNET_FILE = "nnet.pth"
HEADER = "mean median rmse 5 7.5 11.25 22.5 30"


def load_normal_net(model, path: str) -> None:
    """Load the encoder and decoder weights at ``path`` into ``model`` (a
    module with ``encoder`` and ``decoder``); keys of other parts, such as
    the refiner's, are ignored."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict({k: v for k, v in sd.items()
                           if k.startswith(("encoder.", "decoder."))})


def normal_net(device):
    """EfficientNet-B5 encoder + normal decoder (GN), float32, in eval
    mode on ``device``; ``net(rgb)`` maps (B, H, W, 3) RGB in [0, 1] to the
    decoder's full-resolution normals (B, H, W, 3)."""
    import torch

    from sndepth_tpu_torch.models import nnet as nnet_lib
    from sndepth_tpu_torch.models.efficientnet import EfficientNetEncoder
    from sndepth_tpu_torch.models.normal_decoder import NormalDecoder

    class NormalNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = EfficientNetEncoder()
            self.decoder = NormalDecoder(self.encoder.channels())

        def forward(self, rgb):
            x = nnet_lib.bgr_preprocess(rgb) / 255.0
            return self.decoder(self.encoder(x.permute(0, 3, 1, 2)))[-1][
                ..., :3]

    net = NormalNet()
    nnet_lib.init_weights(net, torch.Generator().manual_seed(0))
    return net.to(device).eval()


def main(argv=None) -> dict:
    """Evaluate; returns the metrics by name."""
    p = argparse.ArgumentParser(description="NYUv2 normal evaluation")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--img_height", default=128, type=int)
    p.add_argument("--img_width", default=416, type=int)
    p.add_argument("--pred_file", default=None,
                   help="precomputed normals .npy (N, H, W, 3); else run "
                        "the NNET encoder and decoder")
    p.add_argument("--ckpt_dir", default=None,
                   help=f"directory holding {NNET_FILE} (optional)")
    p.add_argument("--log_file", default="normal_eval.txt")
    p.add_argument("--metrics_json", default=None,
                   help="also dump the metrics as JSON (one object)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the net (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    import torch

    from sndepth_tpu_torch.data.nyu import NYUv2Dataset
    from sndepth_tpu_torch.utils.metrics import (compute_normal_errors,
                                                 normal_angular_errors)

    ds = NYUv2Dataset(args.data_dir, args.split, args.img_height,
                      args.img_width)
    if args.pred_file:
        preds = np.load(args.pred_file)
    else:
        device = torch.device(args.device)
        net = normal_net(device)
        if args.ckpt_dir:
            load_normal_net(net, os.path.join(args.ckpt_dir, NNET_FILE))
        else:
            print("warning: no checkpoint; random weights")
        with torch.no_grad():
            preds = np.stack([
                net(torch.from_numpy(ds[i]["rgb"])[None].to(device))[0]
                .cpu().numpy() for i in range(len(ds))])

    errors = np.concatenate([
        normal_angular_errors(preds[i], ds[i]["normals"],
                              ds[i]["mask"].ravel()).numpy()
        for i in range(len(ds))])
    metrics = {k: float(v) for k, v in compute_normal_errors(errors).items()}
    line = " ".join("%.3f" % metrics[k] for k in
                    ("mean", "median", "rmse", "a1", "a2", "a3", "a4", "a5"))
    print(HEADER)
    print(line)
    with open(args.log_file, "a") as f:
        f.write(f"{HEADER}\n{line}\n\n")
    if args.metrics_json:
        import json
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
