#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives GeoNet stage-1 training of ``sndepth_tpu_torch`` (DispNetS +
PoseNet at full width, 128x416, 3-frame snippets) through the kernels
written for Hopper, and fails unless every phase passes:

  env       card name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc builds the CUDA kernels; the Triton kernel compiles
  photo     K1 (pair photo loss, CUDA) against its plain version at B=4,
            ns=2 on all 4 scales (rigid-flow and wild out-of-image
            coordinates); then both timed with CUDA events at B=4 and B=128
  smooth    K2 (smoothness, Triton) the same way, N = 3B
  step      one float32 train step at 128x416, B=2, from the same seeded
            weights on the CPU (plain versions) and on the GPU (kernels)
  train     the CLI for 20 steps (bf16, B=4, synthetic stream): finite,
            descending loss, 4 launches of each kernel per step; then a
            short B=128 run for frames/sec; then the step alone on a batch
            already on the card, at B=4 and B=128

Each phase prints one JSON line; the full report goes to
``chiprun_out/chip_smoke_report.json``. The last lines are the kernels
line, the nvidia-smi line and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")
DEV = "cuda"
SCALES = ((128, 416), (64, 208), (32, 104), (16, 52))
ALPHA = 0.85
REPORT: dict = {}


def emit(phase: str, **record) -> None:
    REPORT[phase] = record
    print(json.dumps({"phase": phase, **record}), flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_env() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def phase_build() -> None:
    import torch
    from sndepth_tpu_torch.kernels import build
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    t0 = time.perf_counter()
    _, report = build.compile_source("photo_pair.cu")
    t_nvcc = time.perf_counter() - t0
    build.load_library("photo_pair.cu")
    t0 = time.perf_counter()
    K2._launch(torch.ones(3, 1, 16, 52, device=DEV),
               torch.zeros(3, 3, 16, 52, device=DEV))
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", nvcc_s=round(t_nvcc, 2), triton_s=round(t_triton, 2),
         ptxas=ptxas)


def _pyramid_inputs(b: int, seed: int):
    """Per-scale (tgt, srcs, images) from the synthetic stream, on the GPU."""
    import torch
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.ops.pyramid import scale_pyramid
    from sndepth_tpu_torch.train.geonet import preprocess_batch, stack_views
    batch = preprocess_batch(to_device(
        next(synthetic_batches(b, *SCALES[0], seed=seed)),
        torch.device(DEV)))
    views = stack_views(batch)
    pyr = scale_pyramid(views.reshape(b * 3, *views.shape[2:]), len(SCALES))
    return batch, pyr


def _coords(b: int, ns: int, h: int, w: int, k: "torch.Tensor", s: int,
            gen, wild: bool):
    """Forward/backward coords (B, ns, 2, h, w): grid + rigid flow from a
    seeded pose and depth, or grid + uniform noise of +-60 pixels."""
    import torch
    from sndepth_tpu_torch.ops.camera import (compute_multi_scale_intrinsics,
                                              compute_rigid_flow)
    from sndepth_tpu_torch.ops.warp import pixel_grid
    grid = pixel_grid(h, w, device=DEV)
    if wild:
        return tuple((grid + (torch.rand(b, ns, 2, h, w, generator=gen) * 120
                              - 60).to(DEV)).contiguous() for _ in range(2))
    ks = compute_multi_scale_intrinsics(k, len(SCALES))[:, s]
    ks = ks[:, None].expand(b, ns, 3, 3).reshape(b * ns, 3, 3)
    pose = ((torch.rand(b * ns, 6, generator=gen) - 0.5)
            * torch.tensor([0.4, 0.1, 0.4, 0.02, 0.02, 0.02])).to(DEV)
    out = []
    for reverse in (False, True):
        depth = (1.0 / (torch.rand(b * ns, h, w, generator=gen) * 10 + 0.01)
                 ).to(DEV)
        flow = compute_rigid_flow(pose, depth, ks, reverse)
        out.append((grid + flow).reshape(b, ns, 2, h, w).contiguous())
    return tuple(out)


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_photo() -> dict:
    import torch
    from sndepth_tpu_torch.kernels import photo_loss as K1
    gen = torch.Generator().manual_seed(1)
    b, ns = 4, 2
    batch, pyr = _pyramid_inputs(b, seed=11)
    checks, max_err, max_loss_rel = [], 0.0, 0.0
    for s, (h, w) in enumerate(SCALES):
        v = pyr[s].reshape(b, 3, 3, h, w)
        tgt, srcs = v[:, 0].contiguous(), v[:, 1:].contiguous()
        for wild in (False, True):
            cf, cb = _coords(b, ns, h, w, batch["intrinsics"], s, gen, wild)
            lk, dfk, dbk = K1.photo_pair_sums(tgt, srcs, cf, cb, ALPHA)
            lp, dfp, dbp = K1.photo_pair_sums_reference(tgt, srcs, cf, cb,
                                                        ALPHA)
            torch.cuda.synchronize()
            loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
            err = max(_max_err(dfk, dfp), _max_err(dbk, dbp))
            for got, want in ((dfk, dfp), (dbk, dbp)):
                if not torch.isfinite(got).all():
                    raise AssertionError(f"K1 non-finite gradient at {h}x{w}")
                # Same tolerance as the CPU tests against the JAX kernel.
                torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
            if loss_rel > 1e-5:
                raise AssertionError(f"K1 loss {float(lk)} vs plain "
                                     f"{float(lp)} at {h}x{w}")
            checks.append({"hw": [h, w], "wild": wild, "loss": float(lk),
                           "loss_rel_err": loss_rel, "grad_max_abs_err": err})
            max_err = max(max_err, err)
            max_loss_rel = max(max_loss_rel, loss_rel)
    timings = {}
    for bt in (4, 128):
        _, pyr_t = _pyramid_inputs(bt, seed=12)
        per_scale = []
        for s, (h, w) in enumerate(SCALES):
            v = pyr_t[s].reshape(bt, 3, 3, h, w)
            tgt, srcs = v[:, 0].contiguous(), v[:, 1:].contiguous()
            cf, cb = _coords(bt, ns, h, w, batch["intrinsics"][:1].expand(
                bt, 3, 3), s, gen, False)
            per_scale.append({
                "hw": [h, w],
                "kernel_ms": time_ms(lambda: K1._launch(tgt, srcs, cf, cb,
                                                        ALPHA)),
                "plain_ms": time_ms(lambda: K1.photo_pair_sums_reference(
                    tgt, srcs, cf, cb, ALPHA))})
        timings[f"B{bt}"] = per_scale
    emit("photo", checks=checks, timings=timings)
    return {"max_abs_err": max_err, "loss_max_rel_err": max_loss_rel,
            "timings": timings}


def phase_smooth() -> dict:
    import torch
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    gen = torch.Generator().manual_seed(2)
    checks, max_err = [], 0.0
    _, pyr = _pyramid_inputs(4, seed=13)
    for s, (h, w) in enumerate(SCALES):
        n = pyr[s].shape[0]
        depth = (1.0 / (torch.rand(n, 1, h, w, generator=gen) * 10 + 0.01)
                 ).to(DEV)
        img = pyr[s].contiguous()
        sxk, syk, dxk, dyk = K2.smooth_sums(depth, img)
        sxp, syp, dxp, dyp = K2.smooth_sums_reference(depth, img)
        torch.cuda.synchronize()
        rel = max(abs(float(sxk) - float(sxp)) / float(sxp),
                  abs(float(syk) - float(syp)) / float(syp))
        err = max(_max_err(dxk, dxp), _max_err(dyk, dyp))
        for got, want in ((dxk, dxp), (dyk, dyp)):
            if not torch.isfinite(got).all():
                raise AssertionError(f"K2 non-finite gradient at {h}x{w}")
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
        if rel > 1e-5:
            raise AssertionError(f"K2 sums off by {rel} at {h}x{w}")
        checks.append({"hw": [h, w], "sums_rel_err": rel,
                       "grad_max_abs_err": err})
        max_err = max(max_err, err)
    timings = {}
    for bt in (4, 128):
        _, pyr_t = _pyramid_inputs(bt, seed=14)
        per_scale = []
        for s, (h, w) in enumerate(SCALES):
            img = pyr_t[s].contiguous()
            depth = (torch.rand(img.shape[0], 1, h, w, generator=gen) * 10
                     + 0.1).to(DEV)
            per_scale.append({
                "hw": [h, w],
                "kernel_ms": time_ms(lambda: K2._launch(depth, img)),
                "plain_ms": time_ms(lambda: K2.smooth_sums_reference(
                    depth, img))})
        timings[f"B{bt}"] = per_scale
    emit("smooth", checks=checks, timings=timings)
    return {"max_abs_err": max_err, "timings": timings}


def phase_step() -> None:
    """One float32 step from the same seeded weights on CPU and GPU."""
    import torch
    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.train import geonet
    cfg = GeoNetConfig(batch_size=2, compute_dtype=torch.float32)
    batch = next(synthetic_batches(2, cfg.img_height, cfg.img_width, seed=5))
    res = {}
    for dev in ("cpu", DEV):
        state = geonet.create_train_state(cfg, dev)
        met = geonet.train_step(state, to_device(batch, torch.device(dev)),
                                cfg)
        res[dev] = {
            "loss": float(met["loss_total"]),
            "grads": {n: p.grad.detach().cpu() for n, p in _named(state)},
            "params": {n: p.detach().cpu() for n, p in _named(state)}}
    cpu, gpu = res["cpu"], res[DEV]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_err = {}
    for n, g in gpu["grads"].items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite GPU gradient {n}")
        grad_err[n] = float((g - cpu["grads"][n]).norm()
                            / cpu["grads"][n].norm().clamp_min(1e-30))
    lr = cfg.learning_rate
    n_off = n_all = 0
    max_param = 0.0
    for n, p in gpu["params"].items():
        d = (p - cpu["params"][n]).abs()
        max_param = max(max_param, float(d.max()))
        n_off += int((d > 0.01 * lr).sum())
        n_all += d.numel()
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    emit("step", loss_cpu=cpu["loss"], loss_gpu=gpu["loss"],
         loss_rel_err=loss_rel, grad_rel_err_worst=worst,
         param_max_abs_err=max_param, param_frac_off=n_off / n_all)
    # Per-tensor gradient error is the norm of the difference over the norm
    # of the CPU gradient. The deepest DispNetS layers (1x4 maps at 128x416)
    # get gradients ~1e-8 that are sums of cancelling terms: float32
    # convolutions with other algorithms put them ~1e-2 apart (measured
    # 8.9e-3 on an H100, with the kernels or the plain versions alike), and
    # two GPU runs of the same step ~4e-4 apart. After Adam, entries whose
    # gradient is within rounding of zero may take the other sign: at most
    # 1% of them, none by more than 2 * lr.
    if not (loss_rel <= 1e-4 and worst[0][1] <= 2e-2
            and max_param <= 2 * lr and n_off <= 0.01 * n_all):
        raise AssertionError("CPU and GPU train steps disagree")


def _named(state):
    for prefix, net in (("disp.", state.disp_net), ("pose.", state.pose_net)):
        for n, p in net.named_parameters():
            yield prefix + n, p


def _train(extra: list[str], max_steps: int) -> tuple[list[dict], float]:
    """The CLI on the synthetic stream; returns its per-step records and the
    median seconds per step after the first three."""
    from sndepth_tpu_torch.cli import train_geonet
    _, records = train_geonet.main(
        ["--max_steps", str(max_steps), "--log_every", "1",
         "--output_ckpt_iter", str(max_steps),
         "--ckpt_dir", os.path.join(WORK_DIR, "ckpt"),
         "--graphs_dir", os.path.join(WORK_DIR, "logs"),
         "--device", DEV] + extra)
    if len(records) != max_steps:
        raise AssertionError(f"{len(records)} of {max_steps} steps logged")
    dts = sorted(1.0 / r["steps_per_sec"] for r in records[3:])
    return records, dts[len(dts) // 2]


def _device_step_ms(batch_size: int, steps: int = 5) -> float:
    """Median ms of a bf16 train step on one batch already on the card,
    after three warm-up steps: the step without the host's input work."""
    import torch
    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.train import geonet
    cfg = GeoNetConfig(batch_size=batch_size)
    state = geonet.create_train_state(cfg, DEV)
    batch = to_device(next(synthetic_batches(batch_size, *SCALES[0], seed=7)),
                      torch.device(DEV))
    times = []
    for i in range(3 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        geonet.train_step(state, batch, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times = sorted(times[3:])
    return times[len(times) // 2] * 1e3


def phase_train() -> dict:
    from sndepth_tpu_torch.kernels import photo_loss as K1
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    steps = 20
    K1.photo_pair_sums.launches = 0
    K2.smooth_sums.launches = 0
    records, dt = _train([], steps)
    launches = {"photo_pair": K1.photo_pair_sums.launches,
                "smooth": K2.smooth_sums.launches}
    losses = [r["loss_total"] for r in records]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"loss did not descend: {losses}")
    if launches != {"photo_pair": 4 * steps, "smooth": 4 * steps}:
        raise AssertionError(f"launches {launches}, want {4 * steps} each")

    big_steps = 6
    K1.photo_pair_sums.launches = 0
    K2.smooth_sums.launches = 0
    big, dt_big = _train(["--batch_size", "128"], big_steps)
    big_launches = (K1.photo_pair_sums.launches, K2.smooth_sums.launches)
    if big_launches != (4 * big_steps, 4 * big_steps):
        raise AssertionError(f"B=128 launches {big_launches}")
    if not all(abs(r["loss_total"]) < float("inf") for r in big):
        raise AssertionError("non-finite loss at B=128")
    dev_b4, dev_b128 = _device_step_ms(4), _device_step_ms(128)
    emit("train", steps=steps, losses=losses, loss_first5=first,
         loss_last5=last, launches=launches, ms_per_step_b4=dt * 1e3,
         b128_steps=big_steps, ms_per_step_b128=dt_big * 1e3,
         frames_per_sec_b128=128 * 3 / dt_big,
         device_batch_ms_per_step_b4=dev_b4,
         device_batch_ms_per_step_b128=dev_b128,
         device_batch_frames_per_sec_b128=128 * 3 / dev_b128 * 1e3)
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "sndepth_tpu_torch")):
        print("chip_smoke: sndepth_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    photo = phase_photo()
    smooth = phase_smooth()
    phase_step()
    launches = phase_train()

    def kernel_ms(t, key):
        return sum(s[key] for s in t["B4"])

    kernels = [
        {"name": "photo_pair", "route": "cuda",
         "source": "sndepth_tpu_torch/kernels/csrc/photo_pair.cu",
         "replaces": "sndepth_tpu/kernels/photo_loss.py:614",
         "launches": launches["photo_pair"],
         "max_abs_err": photo["max_abs_err"],
         "ms": kernel_ms(photo["timings"], "kernel_ms"),
         "plain_ms": kernel_ms(photo["timings"], "plain_ms")},
        {"name": "smooth", "route": "triton",
         "source": "sndepth_tpu_torch/kernels/smooth_loss.py",
         "replaces": "sndepth_tpu/kernels/smooth_loss.py:142",
         "launches": launches["smooth"],
         "max_abs_err": smooth["max_abs_err"],
         "ms": kernel_ms(smooth["timings"], "kernel_ms"),
         "plain_ms": kernel_ms(smooth["timings"], "plain_ms")},
    ]
    REPORT["kernels"] = kernels
    REPORT["seconds"] = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
