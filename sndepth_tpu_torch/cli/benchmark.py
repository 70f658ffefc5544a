"""CLI: per-family train-step throughput on one GPU.

The flags, defaults and output of ``python -m sndepth_tpu.cli.benchmark``
(one JSON line per family), plus ``--device``. A family's step runs twice
to warm up and then ``--iters`` times on one batch that already lies on the
device; the loop is timed with CUDA events on the device's stream (with the
host clock around a synchronised loop on the CPU).

Families:
  geonet   self-supervised stage-1 train step (DispNetS + PoseNet + loss)
  flow     stage-2 full-flow train step (FlowNet + geometric consistency)
The JAX package's other families (nnet, motion, vae, raft3d) are not ported
yet: asking for one exits with an error, and ``all`` runs the ported ones.

Usage:
    python -m sndepth_tpu_torch.cli.benchmark --family flow
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

PORTED = ("geonet", "flow")
NOT_PORTED = ("nnet", "motion", "vae", "raft3d")


def _result(family: str, ms: float, value: float, unit: str) -> dict:
    record = {"family": family, "ms_per_step": round(ms, 1),
              "value": round(value, 1), "unit": unit}
    print(json.dumps(record), flush=True)
    return record


def _geonet_like(train_flow: bool, batch: int, h: int, w: int, iters: int,
                 device) -> dict:
    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.train import geonet

    device = torch.device(device)
    cfg = GeoNetConfig(batch_size=batch, img_height=h, img_width=w,
                       compute_dtype=torch.bfloat16, train_flow=train_flow)
    rng = np.random.RandomState(0)
    data = {
        "tgt": rng.randint(0, 256, (batch, h, w, 3), np.uint8),
        "src": rng.randint(0, 256, (batch, h, w, 6), np.uint8),
        "intrinsics": np.tile(np.array(
            [[[w * 0.58, 0, w / 2], [0, h * 1.92, h / 2], [0, 0, 1]]],
            np.float32), (batch, 1, 1)),
    }
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    state = geonet.create_train_state(cfg, device)
    for _ in range(2):
        m = geonet.train_step(state, data, cfg)
    float(m["loss_total"])
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            m = geonet.train_step(state, data, cfg)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) * 1e-3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            m = geonet.train_step(state, data, cfg)
        dt = (time.perf_counter() - t0) / iters
    if not np.isfinite(float(m["loss_total"])):
        raise FloatingPointError("non-finite loss in the timed loop")
    fam = "flow" if train_flow else "geonet"
    return _result(fam, dt * 1e3, batch * 3 / dt, "frames/sec")


def main(argv=None) -> list[dict]:
    """Run the chosen families; returns their result records."""
    p = argparse.ArgumentParser(description="Family benchmarks")
    p.add_argument("--family", default="all",
                   choices=["all", *PORTED, *NOT_PORTED])
    p.add_argument("--iters", default=10, type=int)
    p.add_argument("--batch", default=0, type=int,
                   help="override the family's default batch")
    p.add_argument("--img_height", default=0, type=int)
    p.add_argument("--img_width", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    if args.family in NOT_PORTED:
        p.exit(2, f"family {args.family}: not ported yet\n")
    if args.iters < 1:
        p.error("--iters must be at least 1")

    h, w = args.img_height or 128, args.img_width or 416
    fam = args.family
    results = []
    if fam in ("all", "geonet"):
        results.append(_geonet_like(False, args.batch or 128, h, w,
                                    args.iters, args.device))
    if fam in ("all", "flow"):
        results.append(_geonet_like(True, args.batch or 32, h, w,
                                    args.iters, args.device))
    return results


if __name__ == "__main__":
    main()
