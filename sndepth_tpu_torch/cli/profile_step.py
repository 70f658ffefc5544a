"""CLI: where one warm step's time goes on the GPU.

Runs the ``geonet`` (stage 1) or ``flow`` (stage 2) train step or the
``raft3d`` inference frame (B = 1, 16 iterations) of
``sndepth_tpu_torch.cli.benchmark``, or the ``raft3d_train`` step (12
iterations, the train CLI's defaults: 256x832, B = 2, bf16), on inputs that
lie on the card, warms it up, then traces ``--steps`` steps with
``torch.profiler`` and prints one JSON object: the host's wall time per
step, the summed device time of the kernels, the device's idle share
(1 - kernel time / wall time), the number of kernel launches, the kernel
time by group and the largest kernels by name. The hand-written kernels are groups of their own.

Usage:
    python -m sndepth_tpu_torch.cli.profile_step --family flow --batch 32
    python -m sndepth_tpu_torch.cli.profile_step --family raft3d \
        --img_height 376 --img_width 1248
    python -m sndepth_tpu_torch.cli.profile_step --family raft3d_train
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from sndepth_tpu_torch.utils.profiling import device_kernels


def _train_step(family: str, batch: int, h: int, w: int, device):
    """A warm train step of the family as a function of no arguments."""
    import torch

    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.train import geonet

    cfg = GeoNetConfig(batch_size=batch, img_height=h, img_width=w,
                       train_flow=family == "flow")
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
    return lambda: geonet.train_step(state, data, cfg)


def _raft3d_train_step(batch: int, h: int, w: int, dtype: str, device):
    """A RAFT3D train step (12 iterations, seeded weights and batch) as a
    function of no arguments."""
    import torch

    from sndepth_tpu_torch.cli.train_raft3d import synthetic_batches
    from sndepth_tpu_torch.models.raft3d import RAFT3D, init_weights
    from sndepth_tpu_torch.train import raft3d as rt

    model = RAFT3D(dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    state = rt.create_train_state(model, device)
    data = {k: torch.from_numpy(v).to(device)
            for k, v in next(synthetic_batches(batch, h, w)).items()}
    return lambda: rt.train_step(state, data)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Profile one warm step")
    p.add_argument("--family", default="flow",
                   choices=["geonet", "flow", "raft3d", "raft3d_train"])
    p.add_argument("--batch", default=0, type=int,
                   help="override the family's default batch (128 / 32; "
                        "raft3d runs one frame pair, raft3d_train 2)")
    p.add_argument("--steps", default=2, type=int, help="steps to trace")
    p.add_argument("--img_height", default=0, type=int,
                   help="default 128 (raft3d_train: 256)")
    p.add_argument("--img_width", default=0, type=int,
                   help="default 416 (raft3d_train: 832)")
    p.add_argument("--dtype", default=None, choices=["f32", "bf16"],
                   help="raft3d, raft3d_train: encoder/GRU compute dtype "
                        "(default f32; raft3d_train: bf16)")
    args = p.parse_args(argv)
    training = args.family == "raft3d_train"
    args.img_height = args.img_height or (256 if training else 128)
    args.img_width = args.img_width or (832 if training else 416)
    args.dtype = args.dtype or ("bf16" if training else "f32")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        p.exit(2, "profile_step needs a CUDA device\n")
    h, w = args.img_height, args.img_width
    device = torch.device("cuda")
    if args.family == "raft3d":
        from sndepth_tpu_torch.cli.benchmark import raft3d_frame
        batch = 1
        stage, frame = raft3d_frame(h, w, device, args.dtype)
        step = lambda: stage(*frame)
    elif training:
        batch = args.batch or 2
        step = _raft3d_train_step(batch, h, w, args.dtype, device)
    else:
        batch = args.batch or (32 if args.family == "flow" else 128)
        step = _train_step(args.family, batch, h, w, device)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    by_group, by_name, launches = device_kernels(prof, args.steps)
    kernel_ms = sum(by_group.values())
    if not kernel_ms > 0:
        p.exit(3, "the profiler recorded no device time\n")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "family": args.family, "batch": batch, "hw": [h, w],
        "device": torch.cuda.get_device_name(0),
        "steps_traced": args.steps, "wall_ms_per_step": wall_ms,
        "kernel_ms_per_step": kernel_ms,
        "idle_share": 1.0 - kernel_ms / wall_ms,
        "launches_per_step": launches / args.steps,
        "ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:100], "ms": v[0],
                         "launches_per_step": v[1] / args.steps}
                        for n, v in top],
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
