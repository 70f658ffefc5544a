"""CLI: per-family throughput on one GPU.

The flags, defaults and output of ``python -m sndepth_tpu.cli.benchmark``
(one JSON line per family), plus ``--device`` and ``--dtype``. A family's
step runs to warm up and then ``--iters`` times on inputs that already lie
on the device; the loop is timed with CUDA events on the device's stream
(with the host clock around a synchronised loop on the CPU).

Families:
  geonet   self-supervised stage-1 train step (DispNetS + PoseNet + loss)
  flow     stage-2 full-flow train step (FlowNet + geometric consistency)
  nnet     normal-net train step (EfficientNet-B5 + decoder), bf16, B = 4 at
           480x640, in img/sec
  motion   MotionFusionNet train step, bf16, B = 16 at 384x768, in img/sec
  vae      the RGBD AutoencoderKL, B = 8 at 128x416: encode, draw from the
           posterior, decode, the reconstruction fed back as the next
           call's input, float32 as in JAX, in img/sec
  raft3d   RAFT3D scene-flow inference: one frame pair a call (B = 1), 16
           refinement iterations, each call's second frame made from the
           call before so that no two calls do the same work; ``--dtype``
           is the type of the encoders and the GRU (f32 or bf16)

Usage:
    python -m sndepth_tpu_torch.cli.benchmark --family flow
    python -m sndepth_tpu_torch.cli.benchmark --family motion
    python -m sndepth_tpu_torch.cli.benchmark --family vae
    python -m sndepth_tpu_torch.cli.benchmark --family raft3d \
        --img_height 376 --img_width 1248
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

FAMILIES = ("geonet", "flow", "nnet", "motion", "vae", "raft3d")


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
    last = {}

    def step():
        last["m"] = geonet.train_step(state, data, cfg)

    dt = _timed(step, iters, device)
    if not np.isfinite(float(last["m"]["loss_total"])):
        raise FloatingPointError("non-finite loss in the timed loop")
    fam = "flow" if train_flow else "geonet"
    return _result(fam, dt * 1e3, batch * 3 / dt, "frames/sec")


def _timed(fn, iters: int, device) -> float:
    """Seconds per call of ``fn`` over ``iters`` calls: CUDA events on the
    card, the host clock on the CPU."""
    import torch
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def nnet_step(batch: int, h: int, w: int, device):
    """The ``nnet`` family's bf16 train step on seeded inputs on ``device``
    (the JAX benchmark's: random images, normals in [-1, 1), every pixel
    valid), as a function of no arguments returning its metrics."""
    import torch

    from sndepth_tpu_torch.train import nnet as nt

    device = torch.device(device)
    rng = np.random.RandomState(0)
    data = {"rgb": rng.rand(batch, h, w, 3).astype(np.float32),
            "normals": (rng.rand(batch, h, w, 3) * 2 - 1).astype(np.float32),
            "mask": np.ones((batch, h, w), bool)}
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    state = nt.create_train_state(device=device, dtype=torch.bfloat16)
    return lambda: nt.train_step(state, data)


def motion_step(batch: int, h: int, w: int, device):
    """The ``motion`` family's bf16 train step on seeded inputs on
    ``device``, as a function of no arguments returning its metrics."""
    import torch

    from sndepth_tpu_torch.train import motion

    device = torch.device(device)
    rng = np.random.RandomState(0)
    data = {"image": rng.rand(batch, h, w, 3).astype(np.float32),
            "flow": rng.rand(batch, h, w, 3).astype(np.float32),
            "label": rng.randint(0, 3, (batch, h, w)).astype(np.int64)}
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    state = motion.create_train_state(device=device, dtype=torch.bfloat16)
    return lambda: motion.train_step(state, data)


def _train_family(family: str, make, batch: int, h: int, w: int,
                  iters: int, device) -> dict:
    """Time ``make(batch, h, w, device)``'s step after two warm-up steps."""
    import torch

    device = torch.device(device)
    step = make(batch, h, w, device)
    for _ in range(2):
        m = step()
    float(m["loss"])
    last = {}

    def timed():
        last["m"] = step()

    dt = _timed(timed, iters, device)
    if not np.isfinite(float(last["m"]["loss"])):
        raise FloatingPointError("non-finite loss in the timed loop")
    return _result(family, dt * 1e3, batch / dt, "img/sec")


def vae_step(batch: int, h: int, w: int, device):
    """The ``vae`` family's call on ``device``: the autoencoder (random
    weights from seed 0) encodes a seeded RGBD batch, draws from the
    posterior (noise from a seeded generator on the device), decodes, and
    keeps the reconstruction as the next call's input. Returns the call as
    a function of no arguments, returning (reconstruction, sum of the
    posterior's mean)."""
    import torch

    from sndepth_tpu_torch.models.vae import AutoencoderKL
    from sndepth_tpu_torch.ops.layers import init_weights

    device = torch.device(device)
    model = AutoencoderKL()
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(device).eval()
    rng = np.random.RandomState(0)
    state = {"x": torch.from_numpy(
        rng.rand(batch, 4, h, w).astype(np.float32)).to(device)}
    gen = torch.Generator(device=device).manual_seed(1)

    @torch.no_grad()
    def step():
        posterior = model.encode(state["x"])
        recon = model.decode(posterior.sample(generator=gen))
        # The reconstruction is the next input: no two calls do the same
        # work.
        state["x"] = recon[:, :4]
        return recon, posterior.mean.sum()

    return step


def _vae(batch: int, h: int, w: int, iters: int, device) -> dict:
    import torch

    step = vae_step(batch, h, w, device)
    float(step()[1])
    last = {}

    def timed():
        last["out"] = step()

    dt = _timed(timed, iters, torch.device(device))
    if not bool(torch.isfinite(last["out"][0]).all()):
        raise FloatingPointError("non-finite reconstruction in the timed "
                                 "loop")
    return _result("vae", dt * 1e3, batch / dt, "img/sec")


def raft3d_frame(h: int, w: int, device, dtype: str):
    """The ``raft3d`` family's stage (16 iterations, seeded weights) and its
    seeded inputs on ``device``: ``(stage, (img1, img2, depth1, depth2,
    intrinsics))`` for one frame pair."""
    import torch

    from sndepth_tpu_torch.pipelines import RAFT3DStage

    device = torch.device(device)
    stage = RAFT3DStage(
        iters=16, device=device,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    rng = np.random.RandomState(0)
    img1, img2 = (torch.from_numpy(
        rng.rand(1, 3, h, w).astype(np.float32)).to(device) for _ in range(2))
    d = torch.from_numpy((2 + rng.rand(1, h, w)).astype(np.float32)).to(device)
    k = torch.tensor([[w * 0.58, h * 1.92, w / 2, h / 2]], device=device)
    return stage, (img1, img2, d, d, k)


def _raft3d(h: int, w: int, iters: int, device, dtype: str) -> dict:
    import torch

    stage, (img1, img2, d1, d2, k) = raft3d_frame(h, w, device, dtype)
    state = {"cur": img2}
    _, tp = stage(img1, state["cur"], d1, d2, k)
    float(tp.sum())

    def frame():
        _, tp = stage(img1, state["cur"], d1, d2, k)
        # Distinct work each call.
        state["cur"] = img1 + tp[..., :3].permute(0, 3, 1, 2) * 0.001
        state["tp"] = tp

    dt = _timed(frame, iters, torch.device(device))
    if not bool(torch.isfinite(state["tp"]).all()):
        raise FloatingPointError("non-finite field in the timed loop")
    return _result("raft3d", dt * 1e3, 1.0 / dt, "frames/sec")


def main(argv=None) -> list[dict]:
    """Run the chosen families; returns their result records."""
    p = argparse.ArgumentParser(description="Family benchmarks")
    p.add_argument("--family", default="all", choices=["all", *FAMILIES])
    p.add_argument("--iters", default=10, type=int)
    p.add_argument("--batch", default=0, type=int,
                   help="override the family's default batch")
    p.add_argument("--img_height", default=0, type=int)
    p.add_argument("--img_width", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="raft3d: encoder/GRU compute dtype")
    args = p.parse_args(argv)
    if args.iters < 1:
        p.error("--iters must be at least 1")

    def dims(dh, dw):
        return args.img_height or dh, args.img_width or dw

    h, w = dims(128, 416)
    fam = args.family
    results = []
    if fam in ("all", "geonet"):
        results.append(_geonet_like(False, args.batch or 128, h, w,
                                    args.iters, args.device))
    if fam in ("all", "flow"):
        results.append(_geonet_like(True, args.batch or 32, h, w,
                                    args.iters, args.device))
    if fam in ("all", "nnet"):
        results.append(_train_family("nnet", nnet_step, args.batch or 4,
                                     *dims(480, 640), args.iters,
                                     args.device))
    if fam in ("all", "motion"):
        results.append(_train_family("motion", motion_step, args.batch or 16,
                                     *dims(384, 768), args.iters,
                                     args.device))
    if fam in ("all", "vae"):
        results.append(_vae(args.batch or 8, h, w, args.iters, args.device))
    if fam in ("all", "raft3d"):
        results.append(_raft3d(h, w, args.iters, args.device, args.dtype))
    return results


if __name__ == "__main__":
    main()
