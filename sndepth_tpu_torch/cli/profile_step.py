"""CLI: where one warm step's time goes on the GPU.

Runs the ``geonet`` (stage 1) or ``flow`` (stage 2) train step, the
``nnet`` (B = 4 at 480x640) or ``motion`` (B = 16 at 384x768) bf16 train
step, the ``vae`` call (B = 8 at 128x416, float32) or the ``raft3d``
inference frame (B = 1, 16 iterations) of
``sndepth_tpu_torch.cli.benchmark``, the ``raft3d_train`` step (12
iterations, the train CLI's defaults: 256x832, B = 2, bf16), a ``uniad``
frame of the reference config (6 cameras at 928x1600, float32, chained
frames with an ego shift) or a ``uniad_train`` step of it (``remat``, a
clip of 2 frames, 6 cameras at 224x416), on inputs that
lie on the card, warms it up, times ``--steps`` untraced steps, then
traces as many with ``torch.profiler`` and prints one JSON object: the
host's wall time per step untraced and traced, the summed device time of
the kernels, the device's busy time (the union of its operations'
intervals) and idle share (1 - busy time / the untraced step), the number
of kernel launches, the kernel time by group and the largest kernels by
name (the hand-written kernels are groups of their own), and by the
program's spans (``utils/tracing.SPANS``): each span's host ms and calls a
step, the device ms and launches of the kernels each launched, and the
idle ms a step by the innermost span and host operation open in the gap
(``"geonet#backward / host idle"``), and what the launch and step counters
(``utils/tracing.COUNTERS``) moved over every step it ran. The GeoNet
step runs eagerly until a step has updated Adam (the first, when its loss
is finite), then replays CUDA graphs of itself, captured at the next
step: its work then shows under ``geonet#replay`` and ``geonet#adam``.

Usage:
    python -m sndepth_tpu_torch.cli.profile_step --family flow --batch 32
    python -m sndepth_tpu_torch.cli.profile_step --family raft3d \
        --img_height 376 --img_width 1248
    python -m sndepth_tpu_torch.cli.profile_step --family raft3d_train
    python -m sndepth_tpu_torch.cli.profile_step --family motion
    python -m sndepth_tpu_torch.cli.profile_step --family vae
    python -m sndepth_tpu_torch.cli.profile_step --family uniad
    python -m sndepth_tpu_torch.cli.profile_step --family uniad_train
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from sndepth_tpu_torch.utils import profiling, tracing


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


def uniad_frame(h: int, w: int, device, seed: int = 0):
    """The reference UniAD config with seeded weights, its offsets spread
    over a few pixels (``spread_offsets``), six
    seeded camera images at h x w on the surround rig, and a function of no
    arguments that runs one chained inference frame, after the first with
    an ego shift and rotation; returns (model, images, lidar2img, frame)."""
    import torch

    from sndepth_tpu_torch.models import uniad_track as ut
    from sndepth_tpu_torch.utils.uniad import surround_lidar2img

    model = ut.uniad_reference_config()
    gen = torch.Generator().manual_seed(seed)
    ut.init_weights(model, gen)
    model = model.to(device).eval()
    imgs = torch.rand(model.num_cams, 1, 3, h, w, generator=gen).to(device)
    l2i = surround_lidar2img(h, w).to(device)
    shift = torch.tensor([[0.02, -0.01]], device=device)
    rot = torch.tensor([3.0], device=device)
    with torch.no_grad():
        ut.spread_offsets(model, lambda: model(imgs, l2i, model.init_state()),
                          gen)
    carry = {"state": model.init_state()}

    @torch.no_grad()
    def frame():
        first = not bool(carry["state"].has_prev)
        state, results = model(imgs, l2i, carry["state"],
                               timestamp=carry["state"].timestamp + 0.5,
                               ego_shift=None if first else shift,
                               ego_rotation_deg=None if first else rot)
        carry["state"] = state
        return state, results

    return model, imgs, l2i, frame


def uniad_train_step(h: int, w: int, device, t_frames: int = 2,
                     seed: int = 0):
    """A train step of the reference UniAD config with ``remat`` on the JAX
    CLI's synthetic clip (T frames, 6 cameras at h x w, 4 GTs), as a
    function of no arguments; returns (state, clip, step)."""
    import torch

    from sndepth_tpu_torch.models import uniad_track as ut
    from sndepth_tpu_torch.train import uniad as tu

    model = ut.uniad_reference_config(remat=True)
    ut.init_weights(model, torch.Generator().manual_seed(seed))
    clip = tu.clip_to(tu.synthetic_clip(model, t_frames=t_frames,
                                        img_hw=(h, w)), device)
    state = tu.create_train_state(model, device, seed=seed)
    return state, clip, lambda: tu.train_step(state, clip)


def _timed_ms(step, n: int) -> float:
    """Host ms a call of ``step`` over ``n`` calls, the card synchronised
    at both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Profile one warm step")
    p.add_argument("--family", default="flow",
                   choices=["geonet", "flow", "nnet", "motion", "vae",
                            "raft3d", "raft3d_train", "uniad",
                            "uniad_train"])
    p.add_argument("--batch", default=0, type=int,
                   help="override the family's default batch (128 / 32; "
                        "nnet 4, motion 16, vae 8; raft3d runs one frame "
                        "pair, "
                        "raft3d_train 2; uniad runs one frame of 6 "
                        "cameras, uniad_train a clip of 2 frames)")
    p.add_argument("--steps", default=2, type=int, help="steps to trace")
    p.add_argument("--img_height", default=0, type=int,
                   help="default 128 (raft3d_train: 256, nnet: 480, "
                        "motion: 384, uniad: 928, uniad_train: 224)")
    p.add_argument("--img_width", default=0, type=int,
                   help="default 416 (raft3d_train: 832, nnet: 640, "
                        "motion: 768, uniad: 1600, uniad_train: 416)")
    p.add_argument("--dtype", default=None, choices=["f32", "bf16"],
                   help="raft3d, raft3d_train: encoder/GRU compute dtype "
                        "(default f32; raft3d_train: bf16)")
    args = p.parse_args(argv)
    training = args.family == "raft3d_train"
    hw = {"raft3d_train": (256, 832), "nnet": (480, 640),
          "motion": (384, 768), "uniad": (928, 1600),
          "uniad_train": (224, 416)}.get(args.family, (128, 416))
    args.img_height = args.img_height or hw[0]
    args.img_width = args.img_width or hw[1]
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
    elif args.family == "uniad":
        batch = 1
        step = uniad_frame(h, w, device)[3]
    elif args.family == "uniad_train":
        batch = 1
        step = uniad_train_step(h, w, device)[2]
    elif training:
        batch = args.batch or 2
        step = _raft3d_train_step(batch, h, w, args.dtype, device)
    elif args.family == "vae":
        from sndepth_tpu_torch.cli.benchmark import vae_step
        batch = args.batch or 8
        step = vae_step(batch, h, w, device)
    elif args.family in ("nnet", "motion"):
        from sndepth_tpu_torch.cli import benchmark
        batch = args.batch or (4 if args.family == "nnet" else 16)
        make = (benchmark.nnet_step if args.family == "nnet"
                else benchmark.motion_step)
        step = make(batch, h, w, device)
    else:
        batch = args.batch or (32 if args.family == "flow" else 128)
        step = _train_step(args.family, batch, h, w, device)
    n = args.steps
    counts0 = tracing.counts()
    for _ in range(3):
        step()
    untraced_ms = _timed_ms(step, n)

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = _timed_ms(step, n)
    spans = tracing.snapshot()
    counts = {k: v - counts0[k] for k, v in tracing.counts().items()
              if v != counts0[k]}

    by_group, by_name, launches = profiling.device_kernels(prof, n)
    kernel_ms = sum(by_group.values())
    if not kernel_ms > 0:
        p.exit(3, "the profiler recorded no device time\n")
    events = prof.events()
    busy_ms = profiling.busy_ms(events) / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "family": args.family, "batch": batch, "hw": [h, w],
        "device": torch.cuda.get_device_name(0),
        "steps_traced": n, "untraced_ms_per_step": untraced_ms,
        "wall_ms_per_step": wall_ms, "kernel_ms_per_step": kernel_ms,
        "busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / untraced_ms,
        "launches_per_step": launches / n,
        "ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": name[:100], "ms": v[0],
                         "launches_per_step": v[1] / n}
                        for name, v in top],
        "spans": {name: {"host_ms": s * 1e3 / n, "calls": calls / n}
                  for name, (calls, s) in sorted(spans.items())},
        "device_by_span": profiling.by_span(events, n),
        "idle_ms_by_span": profiling.idle_by_span(events, n),
        "steps_run": 3 + 2 * n, "counters": counts,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
