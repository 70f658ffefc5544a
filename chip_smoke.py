#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives GeoNet training of ``sndepth_tpu_torch`` at full width (DispNetS,
PoseNet and, in stage 2, FlowNet at the reference channel counts, 128x416,
3-frame snippets, 4 scales), RAFT3D scene-flow inference at full width
(hidden 128, 4 correlation levels, ResNet-50 FPN context net, 16 iterations,
at 128x416 and 376x1248) and RAFT3D training at full width (256x832, B = 2,
12 iterations, bf16 encoders), the NNET normal stack at full width and the
fused GeoNet -> NNET -> RAFT3D prediction through the kernels written for
Hopper, and fails unless every phase passes:

  env        card name and power limit (nvidia-smi), torch and CUDA versions
  build      one nvcc per CUDA source, all started together
  photo      K1 (pair photo loss, CUDA) against its plain version at B=4,
             ns=2 on all 4 scales (rigid-flow and wild out-of-image
             coordinates); then both timed with CUDA events at B=4 and B=128
             (stage 1's batch) beside the bound, a scale and the 4 in all
  smooth     K2 (smoothness, CUDA) against its plain version on depth
             (D = 1) and flow (D = 2) planes: the 4 scales at B=4, the
             stage-2 shapes, a ragged 33x97 plane and the stage-1 calls at
             B=4 and B=128 (N = 3B), which it also times; the same bits on
             two runs, and on two streams at once
  warp       K5 (bilinear gather, both modes), K5b (its coordinate
             gradient) and K6 (its splat) against their plain versions at
             the stage-2 shapes, with small, rigid (over a noisy and over a
             smooth depth) and wild coordinates, and the share of K6's tiles
             that accumulate in shared memory; the autograd function around
             them against autograd through the plain sampler
  dssim      K7 (DSSIM map and its adjoint) against autograd through the
             plain version, with both sides, dY only and dX only, at the
             stage-2 shape and on a ragged 33x97 plane
  photo_modes  K3 (one direction) and K4 (weighted pair) of the photo kernel
             against their plain versions on all 4 scales
  gn_build   K8 (dense-SE3 Gauss-Newton build, CUDA) against its plain
             version at n = 832 and n = 7332, radius 32 and 3, B = 1 and 2,
             and on the inputs a real iteration of the model hands it; H
             symmetric bit for bit, and the same bits from run to run
  gn_build_bwd  K8b (the backward of the build, one CUDA kernel) against
             autograd through the plain version at n = 832, 3328 and 7332,
             radius 32 and 3, B = 1 and 2: all eight gradients and the
             train step's subset, on random cotangents and on what a real
             train step hands them; finite at a masked zero-depth pair;
             through ``torch.autograd``
  kernel_times  every kernel at the shapes one stage-2 step at B=32 gives
             it: kernel, plain version, library call where there is one,
             and the least time the card could take (bytes over 3.35 TB/s
             against operations over 67 TFLOP/s float32); and a step's
             calls of each kernel timed at its own shapes: each shape's
             time and bound times the calls the step makes there (``step``)
  kernel_times_raft3d  the same for K8 at both RAFT3D sizes (operations
             counted over the in-radius pairs), for K5 and K5b as the depth
             sampler calls them, with the host's share of a call, and for
             K8b at the training sizes, asked for all gradients and for the
             train step's subset, with the share of its running lanes that
             are in the radius
  step, step_flow  one float32 train step at 128x416, B=2, from the same
             seeded weights on the CPU (plain versions) and on the GPU
             (kernels), stage 1 and stage 2
  raft3d_step  RAFT3D in float32 at 128x416, CPU against GPU from the same
             seeded weights: one iteration from the same carry, the forward
             with 2 iterations and with 16
  raft3d_train_step  one float32 RAFT3D train step at 128x416, B = 1, 2
             iterations, CPU against GPU from the same seeded weights: loss,
             epe2d, per-tensor gradients, parameters after AdamW
  train      stage 1 through the CLI (bf16, B=4, synthetic stream): finite,
             descending loss, 4 launches of K1 and K2 per step; a short
             B=128 run for frames/sec; the step alone on a batch already on
             the card
  train_flow  stage 2 through ``train_geonet`` and through the benchmark
             CLI's ``flow`` family (bf16, B=32): finite loss and every
             kernel's launches per step as the code path predicts

  raft3d     RAFT3D through the benchmark CLI's ``raft3d`` family at 128x416
             and 376x1248, float32 and bf16, and through the submission
             writer on a generated ``testing/seq`` tree, artifacts read
             back: 16 launches of K8 and of K5 a frame
  raft3d_train  RAFT3D training through ``cli/train_raft3d.py`` on the
             synthetic stream at its defaults: finite loss, moving
             parameters, 12 launches a step of K8, K8b and K5 and none of
             K6, every kernel launch of one step counted by the profiler,
             ms/step and peak memory; the step alone on
             card-resident batches at 256x832, B = 2 and 376x1248, B = 1;
             the written ``raft3d.pth`` served for one frame by the
             submission writer
  nnet       the NNET serving stage at full width (EfficientNet-B5, the GN
             decoder, the refiner) at 128x416: float32 card against CPU from
             the same seeded weights (D2N's output handed across, D2N held
             apart on the same inputs), bf16 on the card finite with unit
             normals; frame times and peak memory
  predict_raft3d  the fused GeoNet -> NNET -> RAFT3D CLI on two synthetic
             batches: its files read back, 16 launches of K8 and of K5 a
             frame, frame times

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
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# A product in float32 accuracy on the tensor cores: three TF32 products
# (lo.hi + hi.lo + hi.hi) at the dense TF32 rate.
TF32X3_FLOPS_PER_S = 495e12 / 3
FLOW_BATCH = 32                 # the flow family's batch; n = 2 * 32 pairs
# Launches one stage-2 train step makes (2 sources, 4 scales): K1 on scales
# 1-3; K2 on 4 depth pyramids and 2 directions x 4 scales of flow (both
# channels of a flow in one call); K3 on scale 0; K4 on 4 scales; K5 for 2
# image warps and 2 x 4 warps of a flow by a flow; K5b for the same 10,
# whose coordinates (a rigid flow from the depth and pose nets, a full flow)
# all want a gradient; K6 for the 8 warped flows (the warped frames are
# data); K7 for 2 error maps, forward and backward.
FLOW_STEP_LAUNCHES = {"photo_pair": 3, "smooth": 12, "photo_single": 1,
                      "photo_pair_weighted": 4, "warp_gather": 10,
                      "warp_coord_grad": 10, "warp_splat": 8,
                      "dssim_fwd": 2, "dssim_bwd": 2}
REPORT: dict = {}


def write_report() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(REPORT, f, indent=1)


def emit(phase: str, **record) -> None:
    """Print the phase's record and add it to the report on disk, so that a
    run that fails later still leaves what it measured."""
    REPORT[phase] = record
    print(json.dumps({"phase": phase, **record}), flush=True)
    write_report()


# Cycles of the spin that each timed call is enqueued behind: ~0.2 ms at the
# H100's 1.98 GHz, longer than any wrapper takes to enqueue its launches.
SPIN_CYCLES = 400_000


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after a warm-up.
    Each call is enqueued behind a spin on the card, so the window opens
    when the card gets to it and not while the host is still in the
    wrapper: it holds the card's time for the call, or, for a function of
    more launches than the spin hides, what the host adds after it. The
    host's own time a call is :func:`_host_us`'s."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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


CUDA_SOURCES = ("photo_pair.cu", "warp.cu", "dssim.cu", "gn_build.cu",
                "gn_build_bwd.cu", "smooth_loss.cu")


def phase_build() -> None:
    from sndepth_tpu_torch.kernels import build
    t0 = time.perf_counter()
    built = build.compile_sources(list(CUDA_SOURCES))
    t_nvcc = time.perf_counter() - t0
    for source in CUDA_SOURCES:
        build.load_library(source)
    ptxas = {source: [ln.strip() for ln in report.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]
             for source, (_, report) in built.items()}
    emit("build", nvcc_s=round(t_nvcc, 2), ptxas=ptxas)


def _counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from sndepth_tpu_torch.kernels import dssim as K7
    from sndepth_tpu_torch.kernels import gn_build as K8
    from sndepth_tpu_torch.kernels import photo_loss as K1
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    from sndepth_tpu_torch.kernels import warp as K5
    return {"photo_pair": K1.photo_pair_sums, "smooth": K2.smooth_sums,
            "photo_single": K1.photo_sums,
            "photo_pair_weighted": K1.photo_pair_weighted_sums,
            "warp_gather": K5.warp_gather,
            "warp_coord_grad": K5.warp_coord_grad,
            "warp_splat": K5.warp_splat,
            "dssim_fwd": K7.dssim_forward, "dssim_bwd": K7.dssim_backward,
            "gn_build": K8.gn_build_hg, "gn_build_bwd": K8.gn_build_bwd}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


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
            gen, wild: bool, smooth: bool = False):
    """Forward/backward coords (B, ns, 2, h, w): grid + rigid flow from a
    seeded pose and depth, or grid + uniform noise of +-60 pixels. The
    depth is drawn a pixel at a time (inverse depth uniform in 0.01-10, so
    neighbouring flows differ by tens of pixels), or with ``smooth`` on a
    grid 16 times coarser and upsampled (2-50 m, a flow that varies over
    tens of pixels, as a depth network's does)."""
    import torch
    import torch.nn.functional as F
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
        if smooth:
            coarse = torch.rand(b * ns, 1, max(h // 16, 2), max(w // 16, 2),
                                generator=gen) * 48 + 2
            depth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                                  align_corners=True)[:, 0].to(DEV)
        else:
            depth = (1.0 / (torch.rand(b * ns, h, w, generator=gen) * 10
                            + 0.01)).to(DEV)
        flow = compute_rigid_flow(pose, depth, ks, reverse)
        out.append((grid + flow).reshape(b, ns, 2, h, w).contiguous())
    return tuple(out)


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def _scale_total(per_scale: list) -> dict:
    """A kernel's times over the scales of one step, and its bound."""
    t_bytes = sum(r["bytes_ms"] for r in per_scale)
    t_flops = sum(r["flops_ms"] for r in per_scale)
    extra = {k: sum(r[k] for r in per_scale)
             for k in ("kernel_flops_ms", "pr2_bound_ms")
             if k in per_scale[0]}
    return {"kernel_ms": sum(r["kernel_ms"] for r in per_scale),
            "plain_ms": sum(r["plain_ms"] for r in per_scale),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            **extra}


def _photo_tie_case(tgt, ns: int) -> dict:
    """K1 against its plain version where every window ties: the sources
    equal the target and the coordinates are the pixel grid, so each
    direction samples the frame it compares with, and every window inside
    the image has SSIM exactly 1 and takes the clip's 0.5 tie factor (the
    edge_zero sampler gives 0 on the last row and column, whose windows do
    not tie). The tolerances of the other cases."""
    import torch
    from sndepth_tpu_torch.kernels import photo_loss as K1
    from sndepth_tpu_torch.ops.warp import pixel_grid
    b, _, h, w = tgt.shape
    srcs = tgt[:, None].expand(b, ns, 3, h, w).contiguous()
    grid = pixel_grid(h, w, device=DEV).reshape(1, 1, 2, h, w)
    cf = grid.expand(b, ns, 2, h, w).contiguous()
    cb = cf.clone()
    lk, dfk, dbk = K1.photo_pair_sums(tgt, srcs, cf, cb, ALPHA)
    lp, dfp, dbp = K1.photo_pair_sums_reference(tgt, srcs, cf, cb, ALPHA)
    torch.cuda.synchronize()
    _assert_finite(f"K1 equal windows at {h}x{w}", dfk, dbk)
    for got, want in ((dfk, dfp), (dbk, dbp)):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    if loss_rel > 1e-5:
        raise AssertionError(f"K1 equal windows: loss {float(lk)} vs plain "
                             f"{float(lp)} at {h}x{w}")
    return {"loss": float(lk), "loss_rel_err": loss_rel,
            "grad_max_abs_err": max(_max_err(dfk, dfp), _max_err(dbk, dbp))}


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
        tie = _photo_tie_case(tgt, srcs.shape[1])
        checks.append({"hw": [h, w], "case": "equal_windows_tie", **tie})
        max_err = max(max_err, tie["grad_max_abs_err"])
        max_loss_rel = max(max_loss_rel, tie["loss_rel_err"])
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
                    tgt, srcs, cf, cb, ALPHA)),
                **_photo_bound(_nbytes(tgt, srcs, cf, cb, cf, cb),
                               2 * bt * ns * h * w)})
        timings[f"B{bt}"] = per_scale
        timings[f"B{bt}_total"] = _scale_total(per_scale)
    emit("photo", checks=checks, timings=timings)
    return {"max_abs_err": max_err, "loss_max_rel_err": max_loss_rel,
            "timings": timings}


def _smooth_check(label: str, depth, img) -> dict:
    """K2 against its plain version (sums rel 1e-5, gradients atol 1e-6 +
    rtol 1e-5), and the same bits on a second run."""
    import torch
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    got = K2.smooth_sums(depth, img)
    again = K2.smooth_sums(depth, img)
    sxp, syp, dxp, dyp = K2.smooth_sums_reference(depth, img)
    torch.cuda.synchronize()
    sxk, syk, dxk, dyk = got
    rel = max(abs(float(sxk) - float(sxp)) / float(sxp),
              abs(float(syk) - float(syp)) / float(syp))
    for k, want in ((dxk, dxp), (dyk, dyp)):
        if not torch.isfinite(k).all():
            raise AssertionError(f"K2 non-finite gradient, {label}")
        torch.testing.assert_close(k, want, atol=1e-6, rtol=1e-5)
    if rel > 1e-5:
        raise AssertionError(f"K2 sums off by {rel}, {label}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K2 differs between two runs, {label}")
    return {"case": label, "shape": list(depth.shape), "sums_rel_err": rel,
            "grad_max_abs_err": max(_max_err(dxk, dxp), _max_err(dyk, dyp))}


def _smooth_streams(depth, img, calls: int = 4) -> dict:
    """K2 on two streams at once, ``calls`` calls each in turn: each stream
    keeps its own ticket, so every call gives the bits of a call alone."""
    import torch
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    alone = K2.smooth_sums(depth, img)
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(calls):
        for st in streams:
            with torch.cuda.stream(st):
                got.append(K2.smooth_sums(depth, img))
    torch.cuda.synchronize()
    for out in got:
        if not all(torch.equal(a, b) for a, b in zip(out, alone)):
            raise AssertionError("K2 on two streams differs from a call "
                                 "alone")
    return {"case": "two_streams", "shape": list(depth.shape),
            "calls": len(got)}


def phase_smooth() -> dict:
    import torch
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    gen = torch.Generator().manual_seed(2)

    def planes(n, d, h, w):
        return (1.0 / (torch.rand(n, d, h, w, generator=gen) * 10 + 0.01)
                ).to(DEV)

    checks = []
    _, pyr = _pyramid_inputs(4, seed=13)
    for s, (h, w) in enumerate(SCALES):
        img = pyr[s].contiguous()
        for d in (1, 2):
            checks.append(_smooth_check(f"B4_D{d}", planes(img.shape[0], d,
                                                           h, w), img))
    del pyr
    # The stage-2 shapes: the depth pyramid (3 views of 32 samples) and the
    # flows (64 pairs, both channels).
    _, pyr = _pyramid_inputs(FLOW_BATCH, seed=15)
    for s, (h, w) in enumerate(SCALES):
        img = pyr[s].contiguous()
        n_pairs = 2 * FLOW_BATCH
        checks.append(_smooth_check("stage2_depth", planes(img.shape[0], 1,
                                                           h, w), img))
        checks.append(_smooth_check("stage2_flow", planes(n_pairs, 2, h, w),
                                    img[:n_pairs].contiguous()))
    del pyr
    ragged = (torch.rand(5, 3, 33, 97, generator=gen) * 2 - 1).to(DEV)
    for d in (1, 2):
        checks.append(_smooth_check(f"ragged_D{d}", planes(5, d, 33, 97),
                                    ragged))
    timings = {}
    for bt in (4, 128):
        _, pyr_t = _pyramid_inputs(bt, seed=14)
        per_scale = []
        for s, (h, w) in enumerate(SCALES):
            img = pyr_t[s].contiguous()
            depth = (torch.rand(img.shape[0], 1, h, w, generator=gen) * 10
                     + 0.1).to(DEV)
            # The timed calls are the stage-1 step's: held to the plain
            # version too, since their size picks the segment length.
            checks.append(_smooth_check(f"B{bt}_timed", depth, img))
            if bt == 128 and s in (0, len(SCALES) - 1):
                checks.append(_smooth_streams(depth, img))
            per_scale.append({
                "hw": [h, w],
                "kernel_ms": time_ms(lambda: K2._launch(depth, img)),
                "plain_ms": time_ms(lambda: K2.smooth_sums_reference(
                    depth, img)),
                **_bound(_nbytes(depth, img, depth, depth),
                         SMOOTH_FLOPS * img.shape[0] * h * w)})
        timings[f"B{bt}"] = per_scale
        timings[f"B{bt}_total"] = _scale_total(per_scale)
    max_err = max(c.get("grad_max_abs_err", 0.0) for c in checks)
    emit("smooth", checks=checks, timings=timings)
    return {"max_abs_err": max_err, "timings": timings}


def _pair_inputs(nb: int, seed: int, gen, smooth: bool = False):
    """Stage-2 style inputs of n = 2 * nb (target, source) pairs per scale:
    tgt, src (n, 3, h, w) and forward/backward coords (n, 2, h, w) from
    seeded rigid flows (over a smooth depth with ``smooth``)."""
    from sndepth_tpu_torch.ops.warp import pixel_grid
    batch, pyr = _pyramid_inputs(nb, seed)
    out = []
    for s, (h, w) in enumerate(SCALES):
        v = pyr[s].reshape(nb, 3, 3, h, w)
        tgt = v[:, :1].expand(nb, 2, 3, h, w).reshape(-1, 3, h, w).contiguous()
        src = v[:, 1:].reshape(-1, 3, h, w).contiguous()
        # The seeded depths reach 0.1, which throws single pixels thousands
        # of pixels out; flows are held to 60 pixels, beyond which an
        # edge_zero tap's weights (up to the distance squared) only measure
        # float32 cancellation.
        grid = pixel_grid(h, w, device=DEV)
        cf, cb = ((grid + (c.reshape(-1, 2, h, w) - grid).clamp(-60.0, 60.0))
                  .contiguous() for c in _coords(
                      nb, 2, h, w, batch["intrinsics"], s, gen, False,
                      smooth))
        out.append((tgt, src, cf, cb))
    return out


def _wild(like, gen):
    """Coordinates up to 60 pixels off the grid, far outside the image."""
    import torch
    from sndepth_tpu_torch.ops.warp import pixel_grid
    h, w = like.shape[2:]
    return (pixel_grid(h, w, device=DEV)
            + (torch.rand(like.shape, generator=gen) * 120 - 60).to(DEV))


def _assert_finite(name: str, *tensors) -> None:
    import torch
    for t in tensors:
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite values")


def _sampler_inputs(h8: int, w8: int, gen):
    """What ``depth_sampler`` hands K5 in a RAFT3D iteration at an h8 x w8
    grid: one inverse-depth plane and coordinates a few pixels off the grid,
    every eighth of them thrown far outside the image."""
    import torch
    from sndepth_tpu_torch.ops.warp import pixel_grid
    depth = (torch.rand(1, 1, h8, w8, generator=gen) + 0.2).to(DEV)
    offset = torch.rand(1, 2, h8, w8, generator=gen) * 6 - 3
    far = torch.rand(1, 1, h8, w8, generator=gen) < 0.125
    offset = offset + far * (torch.rand(1, 2, h8, w8, generator=gen) - 0.5) \
        * 4 * w8
    return depth, (pixel_grid(h8, w8, device=DEV) + offset.to(DEV))


def _splat_tiles(coords, g, hs: int, ws: int, mode: str):
    """K6 in its tile path, which it takes for a plane too large for shared
    memory, at any plane size."""
    from sndepth_tpu_torch.kernels import warp as K5
    return K5._launch_splat(coords, g, hs, ws, mode, plane_cells=0)


def _splat_path(hs: int, ws: int) -> str:
    """The path K6 takes for (hs, ws) source planes on this card: ``plane``
    where one fits a block's shared memory, else ``tiles``."""
    import torch
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    return "plane" if (hs * ws + 3) // 4 * 16 <= limit else "tiles"


def phase_warp() -> dict:
    """K5 (the gather), K5b (its coordinate gradient) and K6 (its splat)
    against their plain versions at the stage-2 shapes, the autograd
    function around them against autograd through the plain sampler, and
    K5 and K5b as the RAFT3D frame calls them."""
    import torch
    from sndepth_tpu_torch.kernels import warp as K5
    from sndepth_tpu_torch.ops.warp import pixel_grid
    gen = torch.Generator().manual_seed(3)
    pairs = _pair_inputs(FLOW_BATCH, 21, gen)
    smooth_pairs = _pair_inputs(FLOW_BATCH, 23, gen, smooth=True)
    tgt0, src0, cf0, cb0 = pairs[0]
    small = (pixel_grid(*SCALES[0], device=DEV)
             + (torch.rand(cf0.shape, generator=gen) * 3 - 1.5).to(DEV))
    cases = [("image_small_flow", src0, small), ("image_rigid", src0, cf0),
             ("image_smooth_rigid", src0, smooth_pairs[0][2]),
             ("image_wild", src0, _wild(cf0, gen)),
             # a target plane of another size than the source plane
             ("image_half_size_target", src0, pairs[1][2] * 2.0)]
    for s, (h, w) in enumerate(SCALES):
        grid = pixel_grid(h, w, device=DEV)
        # a flow warped by a flow, as the consistency masks do
        for kind, (_, _, cf, cb) in (("", pairs[s]),
                                     ("smooth_", smooth_pairs[s])):
            cases.append((f"flow_{kind}scale{s}", (cb - grid).contiguous(),
                          cf))
    cases.append(("flow_small_flow", src0[:, :2].contiguous(), small))
    checks = []
    gather_err = coord_err = splat_err = far_err = autograd_err = 0.0
    for name, imgs, coords in cases:
        g = torch.randn(imgs.shape[0], imgs.shape[1], *coords.shape[2:],
                        generator=gen).to(DEV)
        hs, ws = imgs.shape[2:]
        for mode in K5.MODES:
            got = K5.warp_gather(imgs, coords, mode)
            want = K5.warp_gather_reference(imgs, coords, mode)
            dc_k = K5.warp_coord_grad(imgs, coords, g, mode)
            dc_p = K5.warp_coord_grad_reference(imgs, coords, g, mode)
            torch.cuda.synchronize()
            _assert_finite(f"K5 {name} {mode}", got, dc_k)
            # The kernels repeat the plain versions' arithmetic step by step
            # (no fused multiply-add), so only the last bits may differ.
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(dc_k, dc_p, atol=1e-5, rtol=1e-5)
            err5, err5b = _max_err(got, want), _max_err(dc_k, dc_p)
            # K6 in the path these planes take and in its tile path.
            d_k = K5.warp_splat(coords, g, hs, ws, mode)
            d_t = _splat_tiles(coords, g, hs, ws, mode)
            d_p = K5.warp_splat_reference(coords, g, hs, ws, mode)
            d_64 = K5.warp_splat_reference(coords.double(), g.double(), hs,
                                           ws, mode)
            torch.cuda.synchronize()
            _assert_finite(f"K6 {name} {mode}", d_k, d_t)
            # Atomic adds sum in an order that changes from run to run, in
            # the kernel and in index_add_ alike; where clamped far-out taps
            # pile onto a border pixel the terms are large and cancel. The
            # kernel may be off the float32 plain version by a few times
            # what that version is off a float64 evaluation.
            err6, err6_t = _max_err(d_k, d_p), _max_err(d_t, d_p)
            tol6 = 1e-5 + 4.0 * _max_err(d_p.double(), d_64)
            if max(err6, err6_t) > tol6:
                raise AssertionError(f"K6 {name} {mode}: {err6} (tile path "
                                     f"{err6_t}) > {tol6}")
            err6 = max(err6, err6_t)
            # Far-out edge_zero taps weigh up to the distance squared (3600
            # here): their error measures float32 cancellation and is kept
            # apart from that of the cases whose weights stay near [0, 1],
            # as the training step's do.
            w_max = max(float(w.abs().max())
                        for w in K5._taps(coords, hs, ws, mode)[1])
            far = w_max > 4.0
            # The autograd function around the kernels against autograd
            # through the plain sampler: samples and coordinate gradients to
            # 1e-4; image gradients to 1e-4 where the weights stay near
            # [0, 1], else to K6's tolerance above (they are K6's output).
            res = []
            for fn in (K5.bilinear_sample, K5.sampler_reference):
                i = imgs.clone().requires_grad_(True)
                c = coords.clone().requires_grad_(True)
                out = fn(i, c, mode)
                out.backward(g)
                res.append((out.detach(), c.grad, i.grad))
                del out, i, c
            (out_a, dc_a, di_a), (out_r, dc_r, di_r) = res
            torch.testing.assert_close(out_a, out_r, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(dc_a, dc_r, atol=1e-4, rtol=1e-4)
            if far:
                err_i = _max_err(di_a, d_p)
                if err_i > tol6:
                    raise AssertionError(f"autograd {name} {mode}: image "
                                         f"gradient {err_i} > {tol6}")
            else:
                torch.testing.assert_close(di_a, di_r, atol=1e-4, rtol=1e-4)
            err_ag = max(_max_err(out_a, out_r), _max_err(dc_a, dc_r))
            del res, out_a, dc_a, di_a, out_r, dc_r, di_r, d_k, d_t, d_p, d_64
            checks.append({
                "case": name, "mode": mode, "gather_err": err5,
                "coord_grad_err": err5b, "splat_err": err6,
                "splat_tile_path_err": err6_t, "splat_tol": tol6,
                "autograd_err": err_ag, "max_tap_weight": w_max,
                "far_out": far, "splat_path": _splat_path(hs, ws),
                "tile_path_shared_share": K5.splat_shared_share(
                    coords, hs, ws, imgs.shape[1], mode)})
            gather_err = max(gather_err, err5)
            coord_err = max(coord_err, err5b)
            autograd_err = max(autograd_err, err_ag)
            if far:
                far_err = max(far_err, err6)
            else:
                splat_err = max(splat_err, err6)
    # K5 and K5b as ``depth_sampler`` calls them 16 times a RAFT3D frame:
    # zero_pad mode, one channel, at both frame sizes' 1/8 grids. Held to
    # the same tolerances as above.
    sampler = []
    for h, w in RAFT_SIZES:
        depth, coords = _sampler_inputs(h // 8, w // 8, gen)
        g = torch.randn(depth.shape, generator=gen).to(DEV)
        got = K5.warp_gather(depth, coords, "zero_pad")
        want = K5.warp_gather_reference(depth, coords, "zero_pad")
        dc_k = K5.warp_coord_grad(depth, coords, g, "zero_pad")
        dc_p = K5.warp_coord_grad_reference(depth, coords, g, "zero_pad")
        torch.cuda.synchronize()
        _assert_finite(f"K5 zero_pad {tuple(depth.shape)}", got, dc_k)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dc_k, dc_p, atol=1e-5, rtol=1e-5)
        xy = coords.permute(0, 2, 3, 1)
        outside = ((xy < -1) | (xy > xy.new_tensor([w // 8, h // 8]))).any(-1)
        if not (outside.any() and (got[0, 0][outside[0]] == 0).all()
                and (dc_k.permute(0, 2, 3, 1)[outside] == 0).all()):
            raise AssertionError("K5 zero_pad: a sample wholly outside the "
                                 "image must read 0 and have no coordinate "
                                 "gradient, and the case needs one")
        err5, err5b = _max_err(got, want), _max_err(dc_k, dc_p)
        sampler.append({"shape": "x".join(map(str, depth.shape)),
                        "mode": "zero_pad", "gather_err": err5,
                        "coord_grad_err": err5b,
                        "outside_share": float(outside.float().mean())})
        gather_err = max(gather_err, err5)
        coord_err = max(coord_err, err5b)
    emit("warp", checks=checks, raft3d_sampler=sampler,
         splat_far_out_max_abs_err=far_err,
         autograd_max_abs_err=autograd_err)
    return {"warp_gather": gather_err, "warp_coord_grad": coord_err,
            "warp_splat": splat_err}


def phase_dssim() -> dict:
    """K7 forward and backward against autograd through the plain version;
    the backward with both sides, dY only (as the step calls it) and dX
    only, the one-sided calls bit-equal to the two-sided one."""
    import torch
    from sndepth_tpu_torch.kernels import dssim as K7
    from sndepth_tpu_torch.kernels import warp as K5
    gen = torch.Generator().manual_seed(4)
    tgt0, src0, cf0, _ = _pair_inputs(FLOW_BATCH, 22, gen)[0]
    warped = K5.warp_gather_reference(src0, cf0, "edge_zero")
    ragged_x = torch.rand(4, 3, 33, 97, generator=gen).to(DEV)
    ragged_y = torch.rand(4, 3, 33, 97, generator=gen).to(DEV)
    checks, fwd_err, bwd_err = [], 0.0, 0.0
    for name, x, y in (("warped", tgt0, warped), ("frames", tgt0, src0),
                       ("equal_windows_tie", tgt0, tgt0.clone()),
                       ("saturated", tgt0, -tgt0),
                       ("ragged_33x97", ragged_x, ragged_y)):
        g = torch.randn(x.shape, generator=gen).to(DEV)
        out = K7.dssim_forward(x, y)
        dx, dy = K7.dssim_backward(x, y, g)
        only_dy = K7.dssim_backward(x, y, g, need_dx=False)
        only_dx = K7.dssim_backward(x, y, g, need_dy=False)
        x_ = x.clone().requires_grad_(True)
        y_ = y.clone().requires_grad_(True)
        ref = K7.dssim_reference(x_, y_)
        rx, ry = torch.autograd.grad(ref, (x_, y_), g)
        torch.cuda.synchronize()
        _assert_finite(f"K7 {name}", out, dx, dy)
        # The map: pools sum in another order than avg_pool2d, and SSIM
        # divides by small denominators. The adjoint: the tolerance of the
        # photo kernel, whose adjoint is the same algebra.
        torch.testing.assert_close(out, ref.detach(), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dx, rx, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(dy, ry, atol=2e-4, rtol=1e-3)
        if only_dy[0] is not None or not torch.equal(only_dy[1], dy):
            raise AssertionError("K7 backward with dX skipped differs")
        if only_dx[1] is not None or not torch.equal(only_dx[0], dx):
            raise AssertionError("K7 backward with dY skipped differs")
        checks.append({"case": name, "map_err": _max_err(out, ref.detach()),
                       "grad_err": max(_max_err(dx, rx), _max_err(dy, ry))})
        fwd_err = max(fwd_err, checks[-1]["map_err"])
        bwd_err = max(bwd_err, checks[-1]["grad_err"])
    emit("dssim", checks=checks)
    return {"dssim_fwd": fwd_err, "dssim_bwd": bwd_err}


def phase_photo_modes() -> dict:
    """K3 and K4 against their plain versions on the four scales; K3 run in
    both directions equals K1."""
    import torch
    from sndepth_tpu_torch.kernels import photo_loss as K1
    gen = torch.Generator().manual_seed(5)
    tol = dict(atol=2e-4, rtol=1e-3)   # as K1 against its plain version
    checks, err3, err4 = [], 0.0, 0.0
    for s, (tgt, src, cf, cb) in enumerate(_pair_inputs(FLOW_BATCH, 23, gen)):
        for wild in (False, True):
            if wild:
                cf, cb = _wild(cf, gen), _wild(cb, gen)
            # K3 as the stage-2 step calls it: the backward direction.
            l3, d3 = K1.photo_sums(src, tgt, cb, ALPHA)
            p3, q3 = K1.photo_sums_reference(src, tgt, cb, ALPHA)
            # K4 with masks as weights (the step's are these over a count:
            # unnormalised here so that the tolerance bites).
            wf, wb = ((torch.randint(0, 3, (tgt.shape[0], 1, *tgt.shape[2:]),
                                     generator=gen) * 0.5).to(DEV)
                      for _ in range(2))
            args = (tgt, src[:, None], cf[:, None].contiguous(),
                    cb[:, None].contiguous())
            l4, df4, db4 = K1.photo_pair_weighted_sums(*args, wf, wb, ALPHA)
            p4, qf4, qb4 = K1.photo_pair_sums_reference(*args, ALPHA, wf, wb)
            l1, df1, db1 = K1.photo_pair_sums(*args, ALPHA)
            l3f, d3f = K1.photo_sums(tgt, src, cf.contiguous(), ALPHA)
            torch.cuda.synchronize()
            _assert_finite(f"K3/K4 scale {s}", d3, df4, db4)
            torch.testing.assert_close(d3, q3, **tol)
            torch.testing.assert_close(df4, qf4, **tol)
            torch.testing.assert_close(db4, qb4, **tol)
            rel = {"k3": abs(float(l3) - float(p3)) / abs(float(p3)),
                   "k4": abs(float(l4) - float(p4)) / abs(float(p4)),
                   "k3+k3_vs_k1": abs(float(l3) + float(l3f) - float(l1))
                   / abs(float(l1))}
            if max(rel.values()) > 1e-5:
                raise AssertionError(f"photo modes, scale {s}: losses {rel}")
            if not (torch.equal(d3f, df1[:, 0]) and torch.equal(d3, db1[:, 0])):
                raise AssertionError("K3 gradients differ from K1's")
            e3 = _max_err(d3, q3)
            e4 = max(_max_err(df4, qf4), _max_err(db4, qb4))
            checks.append({"hw": list(SCALES[s]), "wild": wild,
                           "k3_grad_err": e3, "k4_grad_err": e4,
                           "loss_rel_err": rel})
            err3, err4 = max(err3, e3), max(err4, e4)
    emit("photo_modes", checks=checks)
    return {"photo_single": err3, "photo_pair_weighted": err4}


RAFT_SIZES = ((128, 416), (376, 1248))   # the CLI default; a KITTI frame /8
GN_RADIUS = 32
# Float32 operations the Gauss-Newton build needs for an in-radius ordered
# pair (i, j), counted from the arithmetic of csrc/gn_build.cu. The
# attention is symmetric (dist_ij = dist_ji), so the 32-wide embedding
# product 2 x_i . x_j (64 an evaluation) and the distance and sigmoid (~8)
# are needed once per unordered pair: 32 and ~4 an ordered pair; the product
# counts at the tensor cores' rate for float32 accuracy. Then the
# transformed point and its inverse depth (~20), the residuals (~11), the 13
# Jacobian entries (~27), 13 weighted entries (~16) and the 54 accumulated
# products (108): 218, 32 of them in the product.
GN_PAIR_FLOPS = 218
GN_PAIR_MMA_FLOPS = 32
# What the kernel does, reported apart (`kernel_flops_ms`): each owner
# evaluates the product and the sigmoid of its own pairs, so both run for
# every ordered pair: 254, the product's 64 on the tensor cores where the
# kernel runs in clusters (csrc/gn_build.cu), else on the float32 pipe. PR
# 4-7 counted these 254 at the float32 rate as the bound.
GN_KERNEL_PAIR_FLOPS = 254
GN_KERNEL_PAIR_MMA_FLOPS = 64


def _gn_inputs(b: int, h: int, w: int, seed: int):
    """Seeded inputs of the Gauss-Newton build on an h x w grid: rotations
    near the identity, points in front of the camera, unit-scale targets,
    weights in [0, 1]."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    n = h * w
    rot = np.eye(3)[None, None] + 0.05 * rng.randn(b, n, 3, 3)
    trans = rng.randn(b, n, 3) * 0.1
    trans[..., 2] += 2.0
    x = rng.randn(b, n, 32) * 0.3
    X = rng.rand(b, n, 3)
    X[..., 2] += 1.0
    tgt, wgt = rng.randn(b, n, 3), rng.rand(b, n, 3)
    intr = np.tile(np.array([[20.0, 21.0, 4.0, 3.0]]), (b, 1))
    f = [torch.from_numpy(a.astype(np.float32)).to(DEV)
         for a in (rot, trans, x, X, tgt, wgt, intr)]
    gy = torch.arange(h, device=DEV).repeat_interleave(w)
    gx = torch.arange(w, device=DEV).repeat(h)
    rot, trans, x, X, tgt, wgt, intr = f
    return rot, trans, x, (x * x).sum(-1), gy, gx, X, tgt, wgt, intr


def _in_radius_pairs(h: int, w: int, radius: int) -> int:
    """Pairs (i, j) of an h x w grid within ``radius`` on both axes."""
    def axis(n):
        return sum(min(n - 1, p + radius) - max(0, p - radius) + 1
                   for p in range(n))
    return axis(h) * axis(w)


def _raft_frame(h: int, w: int, seed: int, b: int = 1):
    """A seeded frame pair, depths and intrinsics for RAFT3D, on the CPU."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    img1, img2 = (torch.from_numpy(rng.rand(b, 3, h, w).astype(np.float32))
                  for _ in range(2))
    d1, d2 = (torch.from_numpy((2 + rng.rand(b, h, w)).astype(np.float32))
              for _ in range(2))
    k = torch.tensor([[w * 0.58, h * 1.92, w / 2, h / 2]] * b)
    return img1, img2, d1, d2, k


def _raft_train_batch(b: int, h: int, w: int, seed: int):
    """A seeded RAFT3D training batch on the card, in the readers' layout:
    images (B, H, W, 3), depths, a zero flow target, full validity."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    batch = {
        "image1": rng.rand(b, h, w, 3), "image2": rng.rand(b, h, w, 3),
        "depth1": 2 + rng.rand(b, h, w), "depth2": 2 + rng.rand(b, h, w),
        "flow": np.zeros((b, h, w, 3)), "valid": np.ones((b, h, w)),
        "intrinsics": np.tile(np.array([w * 0.6, w * 0.6, w / 2, h / 2]),
                              (b, 1))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(DEV)
            for k, v in batch.items()}


def _gn_model_case():
    """The build's inputs as the third iteration of a seeded RAFT3D at
    128x416 hands them over: rotations and translations of the SE3 field,
    the embedding and the sigmoid confidences of the update block."""
    import torch
    from sndepth_tpu_torch import pipelines
    from sndepth_tpu_torch.models import raft3d
    stage = pipelines.RAFT3DStage(iters=3, device=DEV, seed=3)
    calls = []
    kernel = raft3d.gn_build_hg

    def record(*args):
        calls.append(args)
        return kernel(*args)

    raft3d.gn_build_hg = record
    try:
        stage(*_raft_frame(*RAFT_SIZES[0], seed=41))
    finally:
        raft3d.gn_build_hg = kernel
    torch.cuda.synchronize()
    return calls[-1]


def phase_gn_build() -> dict:
    """K8 against its plain version on the card."""
    import torch
    from sndepth_tpu_torch.kernels import gn_build as K8
    cases = [(f"seeded_{h}x{w}_r{r}_B{b}", _gn_inputs(b, h, w, 50 + b + r), r)
             for (h, w) in ((16, 52), (47, 156)) for r in (GN_RADIUS, 3)
             for b in (1, 2)]
    *model_args, model_radius = _gn_model_case()
    cases.append(("model_iteration_16x52", tuple(model_args), model_radius))
    checks, worst_abs, worst_scaled = [], 0.0, 0.0
    for name, args, radius in cases:
        Hk, gk = K8.gn_build_hg(*args, radius)
        Hk2, gk2 = K8.gn_build_hg(*args, radius)
        Hp, gp = K8.gn_build_hg_reference(*args, radius)
        torch.cuda.synchronize()
        _assert_finite(f"K8 {name}", Hk, gk, Hp, gp)
        if not torch.equal(Hk, Hk.transpose(-1, -2)):
            raise AssertionError(f"K8 {name}: H is not exactly symmetric")
        # A fixed order of sums, no atomics: the same bits from run to run.
        if not (torch.equal(Hk, Hk2) and torch.equal(gk, gk2)):
            raise AssertionError(f"K8 {name}: two runs differ")
        # Each entry is a float32 sum of up to (2r+1)^2 = 4225 products taken
        # in another order than the plain version's blocked sums, and the
        # entries of H span orders of magnitude (fx^2 between a translation
        # and a rotation column). An entry is held to 2e-5 of its own size
        # plus 2e-5 of the mean size of that entry position over the pixels:
        # a tenth of the 2e-4 the TPU kernel is held to against its XLA
        # version, and ~10 times what the first run on an H100 showed.
        rec = {"case": name, "n": int(args[3].shape[1]), "radius": radius}
        for key, got, want in (("H", Hk, Hp), ("g", gk, gp)):
            scale = want.abs().mean(dim=(0, 1), keepdim=True)
            tol = 2e-5 * want.abs() + 2e-5 * scale
            diff = (got - want).abs()
            scaled = float((diff / tol.clamp_min(1e-30)).max())
            rec[f"{key}_max_abs_err"] = float(diff.max())
            rec[f"{key}_max_abs"] = float(want.abs().max())
            rec[f"{key}_err_over_tol"] = scaled
            worst_abs = max(worst_abs, float(diff.max()))
            worst_scaled = max(worst_scaled, scaled)
            if not scaled <= 1.0:
                raise AssertionError(f"K8 {name}: {key} off by {scaled} x "
                                     "the tolerance")
        checks.append(rec)
    # How far float32 itself is from the sums: both versions against a
    # float64 evaluation of the plain version, at the largest case.
    name, args, radius = cases[4]
    H64, g64 = K8.gn_build_hg_reference(
        *(a.double() if a.is_floating_point() else a for a in args), radius)
    Hk, gk = K8._launch(*args, radius)
    Hp, gp = K8.gn_build_hg_reference(*args, radius)
    scale = H64.abs().mean(dim=(0, 1), keepdim=True).clamp_min(1e-30)
    f64 = {"case": name,
           "kernel_vs_f64": float(((Hk - H64).abs() / scale).max()),
           "plain_vs_f64": float(((Hp - H64).abs() / scale).max())}
    # A pair outside the radius whose transformed depth is exactly 0: the
    # plain version, like the TPU kernel, forms 0 * inf = NaN in that
    # pixel's sums; the kernel skips the pair, stays finite there and
    # equals the plain version everywhere else.
    args = list(_gn_inputs(1, 16, 52, 70))
    args[0][:] = torch.eye(3, device=DEV)
    args[6][..., 2] += 1.0
    args[6][0, 831, 2] = 1.5
    args[1][0, 0, 2] = -1.5
    Hk, gk = K8.gn_build_hg(*args, 3)
    Hp, gp = K8.gn_build_hg_reference(*args, 3)
    torch.cuda.synchronize()
    _assert_finite("K8 masked pair at zero depth", Hk, gk)
    if torch.isfinite(Hp[0, 0]).all():
        raise AssertionError("the plain build is finite at the zero-depth "
                             "pair: the case does not test what it says")
    torch.testing.assert_close(Hk[:, 1:], Hp[:, 1:], rtol=2e-5, atol=1e-3)
    torch.testing.assert_close(gk[:, 1:], gp[:, 1:], rtol=2e-5, atol=1e-3)
    emit("gn_build", checks=checks, float64=f64,
         tolerance="2e-5 * |entry| + 2e-5 * mean |entry position|")
    return {"gn_build": worst_abs, "gn_build_err_over_tol": worst_scaled}

GN_BWD_NAMES = ("rot", "trans", "x", "sq", "X", "tgt", "wgt", "intrinsics")
# The gradients the train step wants: the pose is detached, depth and
# intrinsics are data.
GN_BWD_TRAIN = (False, False, True, True, False, True, True, False)
# K8b against its plain version: a gradient entry is a float32 sum of up to
# (2r+1)^2 = 4225 signed pair adjoints, each a sum of ~60 products, taken in
# another order than autograd's blocked contractions. An entry is held to
# GN_BWD_TOL of its own size plus GN_BWD_TOL of the mean size of its entry
# position over the pixels (K8's form). Calibrated on an H100 against a
# float64 evaluation of the plain version at 32x104, B = 2: the kernels are
# up to 1.2e-5 of the mean size off it and the float32 plain version up to
# 3.3e-5 (the phase records both); the largest difference between the two
# over all cases was 0.18 of this tolerance.
GN_BWD_TOL = 5e-5


def _gn_bwd_compare(name: str, got, want, skip=None) -> tuple[float, float]:
    """Hold the eight gradients ``got`` against ``want`` (``None`` in
    ``got``: not asked for) after asserting them finite; ``skip(key, t)``
    cuts both to what can be compared, ``None`` for nothing. Returns the
    largest absolute error and the largest error over its tolerance."""
    import torch
    worst_abs = worst_scaled = 0.0
    for key, g, w in zip(GN_BWD_NAMES, got, want):
        if g is None:
            continue
        _assert_finite(f"K8b {name} d {key}", g)
        if g.shape != w.shape:
            raise AssertionError(f"K8b {name}: d {key} is {tuple(g.shape)}, "
                                 f"want {tuple(w.shape)}")
        if skip is not None:
            g, w = skip(key, g), skip(key, w)
            if w is None:
                continue
        # The intrinsics have no pixel axis: their entries are whole sums.
        dims = (0,) if key == "intrinsics" else (0, 1)
        scale = w.abs().mean(dim=dims, keepdim=True)
        tol = GN_BWD_TOL * w.abs() + GN_BWD_TOL * scale
        diff = (g - w).abs()
        scaled = float((diff / tol.clamp_min(1e-30)).max())
        if not scaled <= 1.0:
            raise AssertionError(f"K8b {name}: d {key} off by {scaled} x the "
                                 f"tolerance (max abs {float(diff.max())})")
        worst_abs = max(worst_abs, float(diff.max()))
        worst_scaled = max(worst_scaled, scaled)
    return worst_abs, worst_scaled


def _gn_bwd_model_case():
    """What the backward of the last of three iterations of a seeded RAFT3D
    train step at 128x416 hands the kernels: the build's inputs, the radius,
    the cotangents of H and g, and which gradients are wanted."""
    import torch
    from sndepth_tpu_torch.kernels import gn_build as K8
    from sndepth_tpu_torch.train import raft3d as rt
    state = rt.create_train_state(device=DEV, seed=3)
    calls = []
    kernel = K8.gn_build_hg_bwd

    def record(*args):
        calls.append(args)
        return kernel(*args)

    K8.gn_build_hg_bwd = record
    try:
        loss, _ = rt.raft3d_loss(state.model, _raft_train_batch(
            1, *RAFT_SIZES[0], seed=43), iters=3)
        loss.backward()
    finally:
        K8.gn_build_hg_bwd = kernel
    torch.cuda.synchronize()
    # Backward runs the iterations last to first.
    *args, radius, ct_H, ct_g, want = calls[0]
    return args, radius, ct_H, ct_g, want


def phase_gn_build_bwd() -> dict:
    """K8b against the plain version (autograd through the plain build) on
    the card: all eight gradients, and the subset a train step asks for."""
    import torch
    from sndepth_tpu_torch.kernels import gn_build as K8
    gen = torch.Generator().manual_seed(8)
    checks, worst = [], {"abs": 0.0, "scaled": 0.0}

    def run(name, args, radius, ct_H, ct_g, want, skip=None):
        ref = K8.gn_build_hg_bwd_reference(*args, radius, ct_H, ct_g)
        got = K8.gn_build_hg_bwd(*args, radius, ct_H, ct_g, want)
        torch.cuda.synchronize()
        for key, g, w in zip(GN_BWD_NAMES, got, want):
            if (g is None) == w:
                raise AssertionError(f"K8b {name}: d {key} wanted {w}, got "
                                     f"{'nothing' if g is None else 'one'}")
        a, sc = _gn_bwd_compare(name, got, ref, skip)
        worst["abs"] = max(worst["abs"], a)
        worst["scaled"] = max(worst["scaled"], sc)
        checks.append({"case": name, "n": int(args[3].shape[1]),
                       "radius": radius, "max_abs_err": a,
                       "err_over_tol": sc})
        return ref, got

    def cotangents(b, n):
        return (torch.randn(b, n, 6, 6, generator=gen).to(DEV),
                torch.randn(b, n, 6, generator=gen).to(DEV))

    for h, w in ((16, 52), (32, 104), (47, 156)):
        for radius in (GN_RADIUS, 3):
            for b in (1, 2):
                args = _gn_inputs(b, h, w, 80 + b + radius)
                ct_H, ct_g = cotangents(b, h * w)
                name = f"seeded_{h}x{w}_r{radius}_B{b}"
                run(name, args, radius, ct_H, ct_g, (True,) * 8)
                if b == 2:
                    run(name + "_train_subset", args, radius, ct_H, ct_g,
                        GN_BWD_TRAIN)
    args, radius, ct_H, ct_g, want = _gn_bwd_model_case()
    if tuple(want) != GN_BWD_TRAIN:
        raise AssertionError(f"the train step asks the build for {want}")
    run("model_iteration_16x52", args, radius, ct_H, ct_g, want)
    run("model_iteration_16x52_all", args, radius, ct_H, ct_g, (True,) * 8)

    # How far float32 itself is from the sums: kernel and plain version
    # against a float64 evaluation of the plain version, at 32x104, B = 2.
    args = _gn_inputs(2, 32, 104, 90)
    ct_H, ct_g = cotangents(2, 32 * 104)
    to64 = lambda t: t.double() if t.is_floating_point() else t
    ref64 = K8.gn_build_hg_bwd_reference(*map(to64, args), GN_RADIUS,
                                         ct_H.double(), ct_g.double())
    ref32 = K8.gn_build_hg_bwd_reference(*args, GN_RADIUS, ct_H, ct_g)
    got = K8.gn_build_hg_bwd(*args, GN_RADIUS, ct_H, ct_g)
    f64 = {}
    for key, g, r32, r64 in zip(GN_BWD_NAMES, got, ref32, ref64):
        dims = (0,) if key == "intrinsics" else (0, 1)
        scale = r64.abs().mean(dim=dims, keepdim=True).clamp_min(1e-30)
        f64[key] = {"kernel_vs_f64": float(((g - r64).abs() / scale).max()),
                    "plain_vs_f64": float(((r32 - r64).abs() / scale).max())}

    # A pair (i = 0, j = 831) outside radius 3 whose transformed depth is
    # exactly 0: the plain version forms 0 * inf = NaN in what belongs to
    # pixel 0, to pixel 831 and in the intrinsics; the kernel skips the pair,
    # stay finite everywhere and equal the plain version elsewhere.
    args = list(_gn_inputs(1, 16, 52, 70))
    args[0][:] = torch.eye(3, device=DEV)
    args[6][..., 2] += 1.0
    args[6][0, 831, 2] = 1.5
    args[1][0, 0, 2] = -1.5
    ct_H, ct_g = cotangents(1, 832)

    def skip(key, t):
        return None if key == "intrinsics" else t[:, 1:831]

    ref, got = run("masked_pair_at_zero_depth", args, 3, ct_H, ct_g,
                   (True,) * 8, skip)
    if torch.isfinite(ref[0][0, 0]).all():
        raise AssertionError("the plain backward is finite at the zero-depth "
                             "pair: the case does not test what it says")

    # Through autograd: the Function's backward launches the kernel once and
    # hands back gradients of the inputs' type, None where none is wanted.
    args = list(_gn_inputs(1, 16, 52, 91))
    for k in (2, 3, 7, 8):
        args[k] = args[k].clone().requires_grad_(True)
    before = K8.gn_build_bwd.launches
    H, g = K8.gn_build_hg(*args, GN_RADIUS)
    ct_H, ct_g = cotangents(1, 832)
    grads = torch.autograd.grad([H, g], [args[k] for k in (2, 3, 7, 8)],
                                [ct_H, ct_g])
    ref = K8.gn_build_hg_bwd_reference(*args, GN_RADIUS, ct_H, ct_g)
    _gn_bwd_compare("autograd", [None, None, grads[0], grads[1], None,
                                 grads[2], grads[3], None], ref)
    after = K8.gn_build_bwd.launches
    if after != before + 1 or any(
            g.dtype != torch.float32 for g in grads):
        raise AssertionError(f"autograd through K8: launches {before} -> "
                             f"{after}")
    emit("gn_build_bwd", checks=checks, float64=f64,
         tolerance=f"{GN_BWD_TOL} * |entry| + {GN_BWD_TOL} * mean |entry "
                   "position|")
    return {"gn_build_bwd": worst["abs"],
            "gn_build_bwd_err_over_tol": worst["scaled"]}


# Float32 operations the backward needs for an in-radius ordered pair
# (i, j), counted from the arithmetic of csrc/gn_pair.cuh. The attention is
# symmetric (dist_ij = dist_ji), so the embedding product 2 x_i . x_j and
# the sigmoid are needed once per unordered pair: 32 and ~4 an ordered
# pair. Then the pair's adjoint, once (241: the transformed point and its
# inverse ~20, the 13 Jacobian entries and 3 residuals ~36, v = A J over
# the non-zero columns 118, the quadratic forms and cg . J ~52, q and S
# ~15); d dist (2); d x_i and d x_j from dd_ij + dd_ji (32 multiply-adds
# each, once per unordered pair: 64); d sq (1); d tgt and d wgt (9): 353,
# of which the two matrix products (96) count at the tensor cores' rate for
# float32 accuracy. All gradients add the pair's geometry chain (d J, d r ->
# d P, d intrinsics ~150), d rot, d trans and d intrinsics (25) and d X
# (15): 543.
GN_BWD_PAIR_FLOPS = {"train": 353, "all": 543}
GN_BWD_PAIR_MMA_FLOPS = 96
# What the kernels do besides, reported apart from the bound. The one-pass
# kernel's visit of (p, q) evaluates the embedding product, the sigmoid and
# the adjoint of both (p, q) and (q, p), so each of these runs twice for
# every pair, once for each owner (+32, +4, +241 and +2 for d dist): 632 a
# visit, 972 with both geometry chains (2 x 150 + 40), of which 128 on the
# tensor cores. The two kernels it replaced did 384 (i) + 393 (j) = 777,
# 559 + 558 = 1117 for all, each with an embedding product and a d x sum of
# its own (256).
GN_BWD_KERNEL_PAIR_FLOPS = {"train": 632, "all": 972}
GN_BWD_KERNEL_PAIR_MMA_FLOPS = 128
GN_BWD_HALVES_PAIR_FLOPS = {"train": 384 + 393, "all": 559 + 558}
GN_BWD_HALVES_PAIR_MMA_FLOPS = 256
GN_BWD_SUBSETS = {"train": GN_BWD_TRAIN, "all": (True,) * 8}
# The build's sizes on the training path: the train CLI's default batch
# (256x832, B = 2) and a KITTI frame (376x1248, B = 1); 128x416 besides.
GN_BWD_SIZES = ((2, 256, 832), (1, 376, 1248), (1, 128, 416))


def _gn_bwd_times() -> tuple[dict, dict]:
    """K8b at the sizes above (radius 32), asked for all its gradients and
    for the train step's subset, beside the plain version, the bound, the
    time of the operations the kernel does (both adjoints of a pair) and of
    those the two replaced kernels did, at the same rates, and the share of
    the kernel's running lanes in the radius. Returns the rows and, for the
    kernels line, the totals over the first two sizes with the train step's
    subset: what one step at each size launches."""
    import torch
    from sndepth_tpu_torch.kernels import gn_build as K8
    gen = torch.Generator().manual_seed(9)
    rows = []
    for b, h, w in GN_BWD_SIZES:
        h8, w8 = h // 8, w // 8
        n = h8 * w8
        args = _gn_inputs(b, h8, w8, 61)
        ct_H = torch.randn(b, n, 6, 6, generator=gen).to(DEV)
        ct_g = torch.randn(b, n, 6, generator=gen).to(DEV)
        kargs = K8._kernel_inputs(*args)
        pairs = b * _in_radius_pairs(h8, w8, GN_RADIUS)
        share = K8.lane_share(args[4].cpu(), args[5].cpu(), GN_RADIUS)
        plain_ms = time_ms(lambda: K8.gn_build_hg_bwd_reference(
            *args, GN_RADIUS, ct_H, ct_g), 3)
        for subset, want in GN_BWD_SUBSETS.items():
            out = K8.gn_build_bwd(kargs, ct_H, ct_g, GN_RADIUS, want)
            n_bytes = _nbytes(*kargs, ct_H, ct_g,
                              *(t for t in out if t is not None))
            done = _bound(n_bytes, GN_BWD_KERNEL_PAIR_FLOPS[subset] * pairs,
                          GN_BWD_KERNEL_PAIR_MMA_FLOPS * pairs)
            halves = _bound(n_bytes, GN_BWD_HALVES_PAIR_FLOPS[subset] * pairs,
                            GN_BWD_HALVES_PAIR_MMA_FLOPS * pairs)
            rows.append({
                "shape": f"{b}x{n} ({h8}x{w8})", "gradients": subset,
                "in_radius_pairs": pairs, "lane_share_in_radius": share,
                "ms": time_ms(
                    lambda: K8.gn_build_bwd(kargs, ct_H, ct_g, GN_RADIUS,
                                            want), 10),
                "plain_ms": plain_ms,
                **_bound(n_bytes, GN_BWD_PAIR_FLOPS[subset] * pairs,
                         GN_BWD_PAIR_MMA_FLOPS * pairs),
                "kernel_flops_ms": done["flops_ms"],
                "halves_flops_ms": halves["flops_ms"], "library_ms": None})
    main = {f"{b}x{(h // 8) * (w // 8)} ({h // 8}x{w // 8})"
            for b, h, w in GN_BWD_SIZES[:2]}
    used = [r for r in rows if r["gradients"] == "train" and r["shape"] in main]
    t_bytes = sum(r["bytes_ms"] for r in used)
    t_flops = sum(r["flops_ms"] for r in used)
    total = {"ms": sum(r["ms"] for r in used),
             "plain_ms": sum(r["plain_ms"] for r in used),
             "bound_ms": max(t_bytes, t_flops),
             "bound_by": "bytes" if t_bytes >= t_flops else "operations",
             "library_ms": None}
    return {"gn_build_bwd": rows}, {"gn_build_bwd": total}


# K8's sizes: the two RAFT3D frames (B = 1; 16 launches a frame) and the
# train CLI's batch (GN_BWD_SIZES' first, B = 2; 12 launches a step).
GN_SIZES = (("frame", 1, *RAFT_SIZES[0]), ("frame", 1, *RAFT_SIZES[1]),
            ("train", *GN_BWD_SIZES[0]))


def _gn_build_rows() -> list[dict]:
    """K8 at GN_SIZES (radius 32) beside its plain version, its bound (what
    the build needs), the time of its own work at the same rates, the bound
    PR 4-7 used (every ordered pair's 254 operations at the float32 rate),
    its cluster size and the share of its running lanes in the radius."""
    from sndepth_tpu_torch.kernels import gn_build as K8
    rows = []
    for path, b, h, w in GN_SIZES:
        h8, w8 = h // 8, w // 8
        n = h8 * w8
        args = _gn_inputs(b, h8, w8, 60)
        Hk, gk = K8.gn_build_hg(*args, GN_RADIUS)
        pairs = b * _in_radius_pairs(h8, w8, GN_RADIUS)
        floats = [a for a in args if a.is_floating_point()]
        # The grid positions reach the kernel as two float32 vectors.
        n_bytes = _nbytes(*floats, Hk, gk) + 2 * 4 * n
        csize = K8.cluster_size(b * -(-n // K8.OWNERS))
        done = _bound(n_bytes, GN_KERNEL_PAIR_FLOPS * pairs,
                      GN_KERNEL_PAIR_MMA_FLOPS * pairs if csize > 1 else 0)
        rows.append({
            "shape": f"{b}x{n} ({h8}x{w8})", "path": path,
            "in_radius_pairs": pairs, "all_pairs": b * n * n,
            "cluster_size": csize,
            "lane_share_in_radius": K8.lane_share(args[4].cpu(),
                                                  args[5].cpu(), GN_RADIUS),
            "ms": time_ms(lambda: K8.gn_build_hg(*args, GN_RADIUS), 10),
            "plain_ms": time_ms(
                lambda: K8.gn_build_hg_reference(*args, GN_RADIUS), 5),
            **_bound(n_bytes, GN_PAIR_FLOPS * pairs,
                     GN_PAIR_MMA_FLOPS * pairs),
            "kernel_flops_ms": done["flops_ms"],
            "pr4_bound_ms": max(n_bytes / HBM_BYTES_PER_S * 1e3,
                                254 * pairs / FP32_FLOPS_PER_S * 1e3),
            "library_ms": None})
    return rows


def phase_kernel_times_raft3d() -> dict:
    """K8 at the two sizes the RAFT3D frame gives it and at the train step's
    (radius 32), beside its plain version and its bound; and K5 and K5b as
    ``depth_sampler`` would call them (``zero_pad``, one channel). No single
    PyTorch call computes the build, so it has no library time."""
    import torch
    gen = torch.Generator().manual_seed(7)
    rows = _gn_build_rows()
    shapes = [r for r in rows if r["path"] == "frame"]
    sampler = {"warp_gather": [], "warp_coord_grad": []}
    for h, w in RAFT_SIZES:
        h8, w8 = h // 8, w // 8
        depth, coords = _sampler_inputs(h8, w8, gen)
        gather, coord = _sampler_rows(depth, coords, gen, "zero_pad",
                                      host=True)
        label = f"1x1x{h8}x{w8}"
        sampler["warp_gather"].append({"shape": label, **gather})
        sampler["warp_coord_grad"].append({"shape": label, **coord})
    # The kernels line's total: one frame's two sizes.
    t_bytes = sum(r["bytes_ms"] for r in shapes)
    t_flops = sum(r["flops_ms"] for r in shapes)
    total = {"ms": sum(r["ms"] for r in shapes),
             "plain_ms": sum(r["plain_ms"] for r in shapes),
             "bound_ms": max(t_bytes, t_flops),
             "bound_by": "bytes" if t_bytes >= t_flops else "operations",
             "library_ms": None}
    bwd_rows, bwd_totals = _gn_bwd_times()
    emit("kernel_times_raft3d", gn_build=rows, gn_build_total=total,
         warp_zero_pad_c1=sampler, torch=torch.__version__, **bwd_rows,
         gn_build_bwd_totals=bwd_totals)
    return {"gn_build": total, **bwd_totals}, sampler


def _log_distance(a, b) -> dict:
    """Distance of two SE3 fields on their logarithms, translation and
    rotation parts apart."""
    from sndepth_tpu_torch.ops import se3
    d = (se3.log(a.cpu()) - se3.log(b.cpu())).abs()
    return {"tau_max": float(d[..., :3].max()),
            "phi_max": float(d[..., 3:].max()),
            "tau_mean": float(d[..., :3].mean()),
            "phi_mean": float(d[..., 3:].mean())}


def _check_field(name: str, Ts) -> float:
    """Finite, and unit quaternions to 1e-3; returns the largest deviation
    of a quaternion's norm from 1."""
    _assert_finite(name, Ts)
    off = float((Ts[..., 3:].norm(dim=-1) - 1.0).abs().max())
    if off > 1e-3:
        raise AssertionError(f"{name}: quaternion norm off 1 by {off}")
    return off


def _raft_pair(bilaplacian: bool):
    """One seeded RAFT3D in float32 twice: on the CPU and on the card."""
    import torch
    from sndepth_tpu_torch.models import raft3d
    cpu = raft3d.RAFT3D(bilaplacian=bilaplacian).eval()
    raft3d.init_weights(cpu, torch.Generator().manual_seed(0))
    gpu = raft3d.RAFT3D(bilaplacian=bilaplacian).eval()
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu.to(DEV)


def phase_raft3d_step() -> None:
    """RAFT3D in float32 at 128x416 from the same seeded weights on the CPU
    (plain versions) and on the card (kernels): one refinement iteration
    from the same carry, the whole forward with 2 iterations, and with 16;
    and the bilaplacian variant's forward with 2 iterations, which runs the
    grid smoother and the 16-wide plain build on the card and so launches
    K5 but never K8."""
    import torch
    from sndepth_tpu_torch.kernels.gn_build import gn_build_hg
    from sndepth_tpu_torch.kernels.warp import warp_gather
    h, w = RAFT_SIZES[0]
    frame = _raft_frame(h, w, seed=42)
    cpu, gpu = _raft_pair(bilaplacian=False)
    # A float32 convolution on the card runs in TF32 unless told otherwise;
    # this comparison is about the port's arithmetic, so it is told.
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            const, net = cpu.features(*frame)
            carry, _ = cpu.iteration(cpu.initial_carry(net), const)
            (Ts_c, net_c, ae_c), mask_c = cpu.iteration(carry, const)
            to_dev = lambda t: t.to(DEV)
            const_g = {k: ([to_dev(t) for t in v] if isinstance(v, list)
                           else to_dev(v)) for k, v in const.items()}
            (Ts_g, net_g, ae_g), mask_g = gpu.iteration(
                tuple(map(to_dev, carry)), const_g)
            torch.cuda.synchronize()
            step = {**_log_distance(Ts_g, Ts_c),
                    "net_max": _max_err(net_g.cpu(), net_c),
                    "ae_max": _max_err(ae_g.cpu(), ae_c),
                    "mask_max": _max_err(mask_g.cpu(), mask_c)}
            runs = {}
            for iters in (2, 16):
                want = cpu(*frame, iters=iters)
                got = gpu(*map(to_dev, frame), iters=iters)
                torch.cuda.synchronize()
                runs[iters] = {**_log_distance(got, want),
                               "quat_norm_off": max(
                                   _check_field(f"cpu {iters}", want),
                                   _check_field(f"gpu {iters}", got.cpu()))}
            del cpu, gpu
            cpu, gpu = _raft_pair(bilaplacian=True)
            built, sampled = gn_build_hg.launches, warp_gather.launches
            want = cpu(*frame, iters=2)
            got = gpu(*map(to_dev, frame), iters=2)
            torch.cuda.synchronize()
            if (gn_build_hg.launches != built
                    or warp_gather.launches != sampled + 2):
                raise AssertionError(
                    "bilaplacian forward: K8 launched "
                    f"{gn_build_hg.launches - built} times (want 0), K5 "
                    f"{warp_gather.launches - sampled} (want 2)")
            runs["bilaplacian"] = {
                **_log_distance(got, want),
                "quat_norm_off": max(_check_field("cpu bilaplacian", want),
                                     _check_field("gpu bilaplacian",
                                                  got.cpu()))}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    emit("raft3d_step", hw=[h, w], one_iteration=step,
         forward_2_iters=runs[2], forward_16_iters=runs[16],
         bilaplacian_forward_2_iters=runs["bilaplacian"],
         tolerance=RAFT_STEP_TOL)
    # Float32 on both sides, other convolution algorithms and other orders
    # of sums: the GRU state and the heads differ in the last digits, and
    # the Gauss-Newton solve carries that into the field.
    for key, limit in RAFT_STEP_TOL["one_iteration"].items():
        if not step[key] <= limit:
            raise AssertionError(f"one iteration, CPU against card: {key} "
                                 f"{step[key]} > {limit}")
    for run, name in ((2, "forward_2_iters"), (16, "forward_16_iters"),
                      ("bilaplacian", "bilaplacian_forward_2_iters")):
        for key, limit in RAFT_STEP_TOL[name].items():
            if not runs[run][key] <= limit:
                raise AssertionError(f"{name}, CPU against card: {key} "
                                     f"{runs[run][key]} > {limit}")


# CPU against card, one float32 RAFT3D train step (TF32 off) from the same
# seeded weights at 128x416, B = 1, 2 iterations: relative difference of the
# loss, of epe2d and of the gradient norm; the worst per-tensor gradient
# difference (norm of the difference over the CPU gradient's norm: the
# lookup's scatter-add and the convolutions' other algorithms sum in another
# order); the largest parameter difference after AdamW in units of the
# step's rate (an entry whose gradient is within rounding of zero may take
# the other sign: 2 rates apart at most, plus the rounding of the two
# updated float32 entries) and the share of entries more than a hundredth of
# a rate apart. Gradients that are zero in exact arithmetic
# (a bias before an instance norm, the embedding's common shift) hold
# rounding noise only, ~1e-7 of the global norm: the denominator is floored
# at 1e-5 of the global gradient norm.
RAFT_TRAIN_STEP_TOL = {"loss_rel": 1e-4, "epe2d_rel": 1e-4,
                       "grad_norm_rel": 1e-3, "grad_rel_worst": 5e-2,
                       "param_over_lr": 2.01, "param_frac_off": 0.01}
RAFT_TRAIN_ITERS = 12           # the train CLI's default
# One train step launches K8 and K5 (depth_sampler) once an iteration in the
# forward pass and K8b once an iteration in the backward pass.
# The sampled plane (1 / depth2) is data, so K6 never launches; the sampled
# coordinates come from the field detached at the top of each iteration and
# from data, so K5b never launches either (the comparison of the counts is
# exact, so a launch of either would fail it).
RAFT_TRAIN_STEP_LAUNCHES = {"gn_build": RAFT_TRAIN_ITERS,
                            "gn_build_bwd": RAFT_TRAIN_ITERS,
                            "warp_gather": RAFT_TRAIN_ITERS}


def phase_raft3d_train_step() -> None:
    """One float32 RAFT3D train step at 128x416, B = 1, 2 iterations, from
    the same seeded weights on the CPU (plain versions) and on the card
    (kernels, forward and backward)."""
    import torch
    from sndepth_tpu_torch.train import raft3d as rt
    h, w = RAFT_SIZES[0]
    batch = _raft_train_batch(1, h, w, seed=44)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    try:
        for dev in ("cpu", DEV):
            state = rt.create_train_state(device=dev, seed=0)
            lr = rt.onecycle_lr(state.step)
            met = rt.train_step(
                state, {k: v.to(dev) for k, v in batch.items()}, iters=2)
            named = list(state.model.named_parameters())
            res[dev] = {
                "metrics": {k: float(v) for k, v in met.items()},
                "grads": {n: p.grad.detach().cpu() for n, p in named},
                "params": {n: p.detach().cpu() for n, p in named},
                "buffers": {n: b.detach().cpu().clone()
                            for n, b in state.model.named_buffers()}}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu, gpu = res["cpu"], res[DEV]
    rel = {f"{k}_rel": abs(gpu["metrics"][k] - v) / abs(v)
           for k, v in cpu["metrics"].items()}
    grad_err = {}
    # The gradients are read after clipping: their global norm is 1.
    floor = 1e-5 * float(torch.stack(
        [g.norm() for g in cpu["grads"].values()]).norm())
    for n, g in gpu["grads"].items():
        _assert_finite(f"card gradient {n}", g)
        grad_err[n] = float((g - cpu["grads"][n]).norm()
                            / cpu["grads"][n].norm().clamp_min(floor))
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:3]
    n_off = n_all = 0
    max_param = 0.0
    for n, p in gpu["params"].items():
        d = (p - cpu["params"][n]).abs()
        max_param = max(max_param, float(d.max()))
        n_off += int((d > 0.01 * lr).sum())
        n_all += d.numel()
    for n, b in gpu["buffers"].items():
        if not torch.equal(b, cpu["buffers"][n]):
            raise AssertionError(f"buffer {n} differs after the step")
    got = {**rel, "grad_rel_worst": worst[0][1],
           "param_over_lr": max_param / lr, "param_frac_off": n_off / n_all}
    emit("raft3d_train_step", hw=[h, w], metrics_cpu=cpu["metrics"],
         metrics_gpu=gpu["metrics"], grad_rel_err_worst=worst, lr=lr, **got,
         tolerance=RAFT_TRAIN_STEP_TOL)
    for key, limit in RAFT_TRAIN_STEP_TOL.items():
        if not got[key] <= limit:
            raise AssertionError(f"RAFT3D train step, CPU against card: "
                                 f"{key} {got[key]} > {limit}")


def _raft3d_device_step(b: int, h: int, w: int, steps: int = 3) -> dict:
    """Median ms of a bf16 RAFT3D train step (12 iterations) on one batch
    already on the card, after two warm-up steps, and the peak device
    memory over those steps."""
    import torch
    from sndepth_tpu_torch.models import raft3d
    from sndepth_tpu_torch.train import raft3d as rt
    model = raft3d.RAFT3D(dtype=torch.bfloat16)
    raft3d.init_weights(model, torch.Generator().manual_seed(0))
    state = rt.create_train_state(model, DEV)
    batch = _raft_train_batch(b, h, w, seed=45)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, last = [], None
    for _ in range(2 + steps):
        t0 = time.perf_counter()
        last = rt.train_step(state, batch, RAFT_TRAIN_ITERS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not _finite(float(last["loss"])) or state.notfinite_count:
        raise AssertionError(f"train step at {b}x{h}x{w}: loss "
                             f"{float(last['loss'])}, "
                             f"{state.notfinite_count} steps skipped")
    times = sorted(times[2:])
    return {"batch": b, "hw": [h, w],
            "ms_per_step": times[len(times) // 2] * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "loss": float(last["loss"])}


def phase_raft3d_train() -> dict:
    """The RAFT3D training path at full width through its entry points: the
    train CLI on the synthetic stream (256x832, B = 2, 12 iterations, bf16),
    the step alone on card-resident batches at that size and at 376x1248,
    B = 1, every kernel launch of one step by the profiler, and the written
    checkpoint served for one frame by the submission writer."""
    import torch
    from sndepth_tpu_torch.cli import kitti_submission, profile_step
    from sndepth_tpu_torch.cli import train_raft3d
    from sndepth_tpu_torch.models import raft3d
    steps = 4
    ckpt_dir = os.path.join(WORK_DIR, "ckpt_raft3d")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, records = train_raft3d.main(
        ["--max_steps", str(steps), "--log_every", "1", "--device", DEV,
         "--ckpt_dir", ckpt_dir, "--root", os.path.join(WORK_DIR, "no_data")])
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * steps for k, v in RAFT_TRAIN_STEP_LAUNCHES.items()}
    if _used(launches) != want:
        raise AssertionError(f"raft3d train: launches {_used(launches)}, "
                             f"want {want}")
    if state.calls != steps or len(records) != steps:
        raise AssertionError(f"{state.calls} of {steps} train steps ran")
    for r in records:
        if not all(_finite(r[k]) for k in ("loss", "epe2d", "grad_norm")):
            raise AssertionError(f"raft3d train step {r['step']}: {r}")
    if state.notfinite_count:
        raise AssertionError("a train step was skipped as non-finite")
    # The weights moved from their seeded start, the BatchNorm statistics
    # did not.
    start = raft3d.RAFT3D()
    raft3d.init_weights(start, torch.Generator().manual_seed(0))
    moved = {n: float((p.detach().cpu() - q.detach()).abs().max())
             for (n, p), q in
             zip(state.model.named_parameters(), start.parameters())}
    # (A bias whose gradient is exactly zero stays at its zero start.)
    still = [n for n, v in moved.items() if not v > 0.0]
    if len(still) > 0.1 * len(moved):
        raise AssertionError(f"{len(still)} of {len(moved)} parameter "
                             f"tensors did not move: {still[:5]}")
    for (n, b), b0 in zip(state.model.named_buffers(), start.buffers()):
        if not torch.equal(b.cpu(), b0):
            raise AssertionError(f"buffer {n} changed in training")
    del state
    dts = sorted(1.0 / r["steps_per_sec"] for r in records[1:])
    cli_ms = dts[len(dts) // 2] * 1e3

    device_steps = [_raft3d_device_step(2, 256, 832),
                    _raft3d_device_step(1, 376, 1248)]
    # Every kernel launch of one warm step at the CLI's defaults, by the
    # profiler.
    profile = profile_step.main(["--family", "raft3d_train", "--steps", "1"])
    step_profile = {k: profile[k] for k in (
        "launches_per_step", "kernel_ms_per_step", "wall_ms_per_step",
        "idle_share", "ms_by_group")}

    # The checkpoint the CLI wrote, served for one frame.
    root = os.path.join(WORK_DIR, "raft_datasets")
    out_dir = os.path.join(WORK_DIR, "raft3d_trained_out")
    _write_kitti_testing_tree(root, 2, seed=9)
    written = kitti_submission.main(
        ["--root", root, "--out_dir", out_dir, "--max_frames", "1",
         "--ckpt_dir", ckpt_dir, "--device", DEV])
    if written != 1:
        raise AssertionError(f"served {written} frames from the checkpoint")
    artifacts = _read_back_submission(out_dir, 0, *RAFT_SIZES[0])
    emit("raft3d_train", steps=steps, batch=2, hw=[256, 832],
         iters=RAFT_TRAIN_ITERS, records=records, launches=_used(launches),
         cli_ms_per_step=cli_ms, cli_peak_memory_bytes=peak,
         device_batch_steps=device_steps, step_profile=step_profile,
         parameter_tensors=len(moved), parameter_tensors_still=still,
         largest_parameter_move=max(moved.values()),
         served_artifacts=artifacts)
    return launches


def _write_kitti_testing_tree(root: str, frames: int, seed: int) -> None:
    """A small ``testing/seq`` tree with its calibration files, made from a
    seed: smooth random frames at half the KITTI size."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    seq = os.path.join(root, "testing", "seq")
    calib = os.path.join(root, "testing", "calib_cam_to_cam")
    os.makedirs(seq, exist_ok=True)
    os.makedirs(calib, exist_ok=True)
    base = rng.rand(24, 78, 3).astype(np.float32)
    for i in range(frames):
        coarse = np.roll(base, i, axis=1) + 0.05 * rng.rand(24, 78, 3)
        img = cv2.resize(coarse.astype(np.float32), (621, 188),
                         interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(os.path.join(seq, f"{i:06d}.png"),
                    np.clip(img * 255, 0, 255).astype(np.uint8))
        with open(os.path.join(calib, f"{i:06d}.txt"), "w") as f:
            f.write("calib_time: 09-Jan-2012 13:57:47\n"
                    "K_02: 241.0 0.0 208.0 0.0 246.0 64.0 0.0 0.0 1.0\n")


def _read_back_submission(out_dir: str, index: int, h: int, w: int) -> dict:
    """Read one frame's artifacts back and hold them against each other:
    the tau / phi dumps are the logarithm of the T dump, and the flow png
    is the 2-D flow that the T dump induces on the constant depth plane."""
    import numpy as np
    import torch
    from sndepth_tpu_torch.data.frame_codecs import read_flow_kitti
    from sndepth_tpu_torch.ops import se3
    from sndepth_tpu_torch.ops.projective import induced_flow
    T = torch.from_numpy(np.loadtxt(
        os.path.join(out_dir, "T", f"{index:06d}.txt"))).float()
    tau, phi = (torch.from_numpy(np.loadtxt(
        os.path.join(out_dir, d, f"{index:06d}.txt"))).float()
        for d in ("tau", "phi"))
    if (T.shape != (h * w, 7) or tau.shape != (h * w, 3)
            or phi.shape != (h * w, 3)):
        raise AssertionError(f"artifact shapes {T.shape}, {tau.shape}")
    quat_off = _check_field("submission T", T)
    logs = torch.cat([tau, phi], -1)
    # The dumps keep 6 decimals, and the logarithm is taken again here on
    # the CPU from the text of T: held to 2e-4 of the largest entry.
    log_err = _max_err(se3.log(T), logs) / max(1.0, float(logs.abs().max()))
    flow, valid = read_flow_kitti(
        os.path.join(out_dir, "flow", f"{index:06d}_10.png"))
    k = torch.tensor([[241.0, 246.0, 208.0, 64.0]])
    want, _, _ = induced_flow(T.reshape(1, h, w, 7),
                              torch.full((1, h, w), 4.0), k)
    want = want[0, ..., :2].numpy()
    # The png holds 64 * uv + 2^15 cut to an integer, within uint16.
    inside = np.abs(want).max(-1) < 500.0
    flow_err = float(np.abs(flow - want)[inside].max()) if inside.any() else 0.0
    if flow.shape != (h, w, 2) or not (valid == 1).all():
        raise AssertionError("flow png: wrong shape or validity")
    if log_err > 2e-4 or flow_err > 1.0 / 64 + 1e-3:
        raise AssertionError(f"submission artifacts disagree: log {log_err}, "
                             f"flow {flow_err}")
    return {"quat_norm_off": quat_off, "log_err": log_err,
            "flow_err": flow_err, "flow_in_range": float(inside.mean())}


# CPU against card in float32 (TF32 off), largest absolute differences: of
# the field's logarithm (translation tau, rotation phi), the GRU state, the
# embedding and the mask after one iteration from the same carry, and of the
# field's logarithm after the whole forward with 2 and with 16 iterations
# (the Gauss-Newton step contracts: 16 iterations of a randomly initialised
# GRU do not amplify the rounding). About 20 times what an H100 showed.
RAFT_STEP_TOL = {
    "one_iteration": {"tau_max": 5e-4, "phi_max": 2e-5, "net_max": 2e-3,
                      "ae_max": 5e-4, "mask_max": 5e-4},
    "forward_2_iters": {"tau_max": 1e-3, "phi_max": 2e-5},
    "forward_16_iters": {"tau_max": 1e-3, "phi_max": 5e-5},
    "bilaplacian_forward_2_iters": {"tau_max": 1e-3, "phi_max": 2e-5},
}
RAFT_ITERS = 16                 # refinement iterations a frame
# K8 and K5 (depth_sampler, zero_pad) launch once an iteration each; an
# inference frame differentiates nothing, so K5b and K6 never launch.
RAFT_FRAME_LAUNCHES = {"gn_build": RAFT_ITERS, "warp_gather": RAFT_ITERS}


def phase_raft3d() -> dict:
    """The RAFT3D main path at full width through its entry points: the
    benchmark CLI's ``raft3d`` family at both sizes in float32 and bf16,
    and the submission writer on a generated tree."""
    from sndepth_tpu_torch.cli import benchmark, kitti_submission
    timed = 3
    results, total = [], {k: 0 for k in RAFT_FRAME_LAUNCHES}
    for h, w in RAFT_SIZES:
        for dtype in ("f32", "bf16"):
            reset_launches()
            result, = benchmark.main(
                ["--family", "raft3d", "--iters", str(timed), "--device", DEV,
                 "--img_height", str(h), "--img_width", str(w),
                 "--dtype", dtype])
            launches = _used(read_launches())
            # One warm-up frame and the timed ones.
            want = {k: v * (timed + 1) for k, v in RAFT_FRAME_LAUNCHES.items()}
            if launches != want:
                raise AssertionError(f"raft3d {h}x{w} {dtype}: launches "
                                     f"{launches}, want {want}")
            if result["family"] != "raft3d" or not result["ms_per_step"] > 0:
                raise AssertionError(f"benchmark result {result}")
            results.append({"hw": [h, w], "dtype": dtype,
                            "ms_per_frame": result["ms_per_step"],
                            "frames_per_sec": result["value"],
                            "launches": launches})
            for k in total:
                total[k] += launches[k]

    frames = 2
    root = os.path.join(WORK_DIR, "raft_datasets")
    out_dir = os.path.join(WORK_DIR, "raft3d_out")
    _write_kitti_testing_tree(root, frames + 1, seed=9)
    reset_launches()
    h, w = RAFT_SIZES[0]
    written = kitti_submission.main(
        ["--root", root, "--out_dir", out_dir, "--max_frames", str(frames),
         "--device", DEV])
    launches = _used(read_launches())
    want = {k: v * frames for k, v in RAFT_FRAME_LAUNCHES.items()}
    if written != frames or launches != want:
        raise AssertionError(f"submission: {written} frames, launches "
                             f"{launches}, want {want}")
    artifacts = [_read_back_submission(out_dir, i, h, w)
                 for i in range(frames)]
    for k in total:
        total[k] += launches[k]
    emit("raft3d", benchmark=results, submission_frames=frames,
         submission_launches=launches, artifacts=artifacts,
         launches_total=total)
    return total


# Float32 operations the photo function needs a pixel, direction and source
# over its 3 channels, counted from csrc/photo_pair.cu's arithmetic: the
# edge_zero sample with its tangents (tap setup ~16, the four weights 4, a
# channel's value 7 and tangents 10: 71); the five moments' separable 3x3
# box sums (3 products, 2 + 2 adds a moment: 23 a channel, 69); the SSIM
# terms (27), the clip and its tie factor (9), the adjoint coefficients
# (19) and the pixel's loss (7): 62 a channel, 186; the three adjoint pools
# (4 adds and a division each: 15 a channel, 45); the contraction (d ssim
# 5, the L1 part 7, two multiply-adds into d coords 4: 16 a channel, 48):
# 419. PR 2-7 counted 600 a pixel from the kernel then, whose pools read all
# nine taps.
PHOTO_FLOPS = 419
# What the kernel does, reported apart (`kernel_flops_ms`), a pixel of its
# 16 x 30 tile: the gathers on the 20 x 34 region (sample values 41 a
# pixel, x 680 / 480; tangents 30, x 512 / 480: 90), each warp's row
# moments over its pass-1 rows and two more (19 a row, column and channel
# over 34 rows of 32 columns, / 480: 129), the windows, SSIM terms, adjoint
# and loss of the 18 x 32 pass-1 region (72 a channel, x 576 / 480: 259),
# the adjoint pools from rows of 3-sums (21 a channel) and the contraction
# (16): 111. ~589 in all.
PHOTO_KERNEL_FLOPS = 589
PHOTO_FLOPS_PR2 = 600
# The DSSIM map's 9-tap sums and algebra, and its adjoint's four more pools,
# per pixel and channel; the smoothness sums per pixel.
DSSIM_FWD_FLOPS, DSSIM_BWD_FLOPS, SMOOTH_FLOPS = 100, 170, 40


def _photo_bound(n_bytes: float, pixels: float, extra: int = 0) -> dict:
    """The photo kernel's bound over ``pixels`` pixel-direction-sources
    (``extra`` operations each besides, a weight's), the time of its own
    work at the same rate, and the bound PR 2-7 used."""
    return {**_bound(n_bytes, (PHOTO_FLOPS + extra) * pixels),
            "kernel_flops_ms": (PHOTO_KERNEL_FLOPS + extra) * pixels
            / FP32_FLOPS_PER_S * 1e3,
            "pr2_bound_ms": max(n_bytes / HBM_BYTES_PER_S, (PHOTO_FLOPS_PR2
                                + extra) * pixels / FP32_FLOPS_PER_S) * 1e3}


def _bound(n_bytes: float, flops: float, mma_flops: float = 0.0) -> dict:
    """The least time (ms) the card could take: each input read once and
    each output written once at the memory rate, against the operations at
    the float32 rate, those of them in matrix products (``mma_flops``) at
    the tensor cores' rate for float32 accuracy."""
    return {"bytes": n_bytes, "flops": flops,
            "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "flops_ms": ((flops - mma_flops) / FP32_FLOPS_PER_S
                         + mma_flops / TF32X3_FLOPS_PER_S) * 1e3}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to return (the enqueue, not
    the card's work), over ``calls`` calls after a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _sampler_rows(imgs, coords, gen, mode: str = "edge_zero",
                  host: bool = False) -> tuple[dict, dict]:
    """Times of K5 (the gather, in ``mode`` as the path runs it, and in
    zero_pad) and K5b (its coordinate gradient) on ``imgs`` at ``coords``,
    beside their plain versions, bounds and the PyTorch calls that compute
    the zero_pad functions: ``F.grid_sample`` for the gather and
    ``grid_sampler_2d_backward`` asked for the grid's gradient alone for
    K5b, and the two in turn against K5 + K5b in zero_pad mode. The
    normalised grid is formed outside the timed calls."""
    import torch
    import torch.nn.functional as F
    from sndepth_tpu_torch.kernels import warp as K5
    b, c, hs, ws = imgs.shape
    npix = coords.shape[2] * coords.shape[3]
    g = torch.randn(b, c, *coords.shape[2:], generator=gen).to(DEV)
    out = torch.empty_like(g)
    d_coords = torch.empty_like(coords)
    norm = torch.stack([coords[:, 0] * (2.0 / (ws - 1)) - 1.0,
                        coords[:, 1] * (2.0 / (hs - 1)) - 1.0], -1)
    bwd = torch.ops.aten.grid_sampler_2d_backward

    def grid_sample():
        return F.grid_sample(imgs, norm, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    def grid_sample_bwd():
        return bwd(g, imgs, norm, 0, 0, True, [False, True])

    def fwd(m="zero_pad"):
        return K5.warp_gather(imgs, coords, m)

    def coord_grad(m="zero_pad"):
        return K5.warp_coord_grad(imgs, coords, g, m)

    x, y = coords[:, 0], coords[:, 1]
    gather = {
        # Samples wholly outside the image: zero_pad reads their clamped
        # taps and multiplies them by 0, as the plain version does;
        # grid_sample skips those loads.
        "outside_share": float(((x < -1) | (x > ws) | (y < -1) | (y > hs))
                               .float().mean()),
        "ms": time_ms(lambda: fwd(mode), 10),
        "plain_ms": time_ms(
            lambda: K5.warp_gather_reference(imgs, coords, mode), 5),
        **_bound(_nbytes(imgs, coords, out), b * npix * (20 + 7 * c)),
        "library_ms": time_ms(grid_sample, 10)}
    coord = {
        "ms": time_ms(lambda: coord_grad(mode), 10),
        "plain_ms": time_ms(lambda: K5.warp_coord_grad_reference(
            imgs, coords, g, mode), 5),
        **_bound(_nbytes(imgs, coords, g, d_coords),
                 b * npix * (20 + 22 * c)),
        "library_ms": time_ms(grid_sample_bwd, 10),
        "fwd_bwd_zero_pad_ms": time_ms(lambda: (fwd(), coord_grad()), 10),
        "library_fwd_bwd_ms": time_ms(
            lambda: (grid_sample(), grid_sample_bwd()), 10)}
    if mode != "zero_pad":
        gather["zero_pad_ms"] = time_ms(fwd, 10)
        coord["zero_pad_ms"] = time_ms(coord_grad, 10)
    if host:
        # What a call costs the host alone: at the smallest grids the
        # kernels take less than this, so the timed window holds it.
        gather["host_us"] = _host_us(fwd)
        gather["library_host_us"] = _host_us(grid_sample)
        coord["host_us"] = _host_us(coord_grad)
        coord["library_host_us"] = _host_us(grid_sample_bwd)
    return gather, coord


def phase_kernel_times() -> dict:
    """Every kernel once at each distinct shape that one stage-2 step at
    B = FLOW_BATCH gives it, beside its plain version, its bound and, where
    one PyTorch call computes the same function, that call."""
    import torch
    from sndepth_tpu_torch.kernels import dssim as K7
    from sndepth_tpu_torch.kernels import photo_loss as K1
    from sndepth_tpu_torch.kernels import smooth_loss as K2
    from sndepth_tpu_torch.kernels import warp as K5
    from sndepth_tpu_torch.ops.warp import pixel_grid
    gen = torch.Generator().manual_seed(6)
    nb = FLOW_BATCH
    batch, pyr = _pyramid_inputs(nb, seed=31)
    pairs = _pair_inputs(nb, 31, gen)
    smooth_pairs = _pair_inputs(nb, 32, gen, smooth=True)
    rows: dict[str, list] = {name: [] for name in FLOW_STEP_LAUNCHES}

    def add(name, label, kernel, plain, bound, library=None, calls=1):
        rows[name].append({
            "shape": label, "calls": calls, "ms": time_ms(kernel, 10),
            "plain_ms": time_ms(plain, 5), **bound,
            "library_ms": None if library is None else time_ms(library, 10)})

    def gather_case(imgs, coords, label, smooth_coords):
        gather, coord = _sampler_rows(imgs, coords, gen, host=True)
        gather_s, coord_s = _sampler_rows(imgs, smooth_coords, gen)
        for name, row, row_s in (("warp_gather", gather, gather_s),
                                 ("warp_coord_grad", coord, coord_s)):
            rows[name].append({"shape": label, **row, **{
                f"smooth_{k}": v for k, v in row_s.items()
                if k.endswith("ms") or k == "outside_share"}})

    def splat_case(imgs, coords, label, smooth_coords):
        b, c, hs, ws = imgs.shape
        g = torch.randn(b, c, *coords.shape[2:], generator=gen).to(DEV)
        out = torch.zeros(b * hs * ws, c, device=DEV)
        row = {}
        for kind, crd in (("", coords), ("smooth_", smooth_coords)):
            idx, (wx0, wx1, wy0, wy1), _ = K5._taps(crd, hs, ws, "edge_zero")
            base = (torch.arange(b, device=DEV) * (hs * ws))[:, None]
            index = torch.cat([(i + base).reshape(-1) for i in idx])
            values = torch.cat([(w * g).permute(0, 2, 3, 1).reshape(-1, c)
                                for w in (wx0 * wy0, wx0 * wy1, wx1 * wy0,
                                          wx1 * wy1)])
            def splat():
                return K5.warp_splat(crd, g, hs, ws, "edge_zero")

            # One index_add_ of the four taps' weighted cotangents, indices
            # and values formed outside the timed call. The tile path's time
            # (with its zeroing) is what a plane too large for shared memory
            # would cost a pixel.
            def library():
                return out.index_add_(0, index, values)

            row[f"{kind}ms"] = time_ms(splat, 10)
            row[f"{kind}tile_path_ms"] = time_ms(
                lambda: _splat_tiles(crd, g, hs, ws, "edge_zero"), 10)
            row.update({
                f"{kind}library_ms": time_ms(library, 10),
                f"{kind}tile_path_shared_share": K5.splat_shared_share(
                    crd, hs, ws, c, "edge_zero")})
            if not kind:
                row["host_us"] = _host_us(splat)
                row["library_host_us"] = _host_us(library)
            del index, values
        rows["warp_splat"].append({
            "shape": label, "path": _splat_path(hs, ws), "ms": row.pop("ms"),
            "plain_ms": time_ms(lambda: K5.warp_splat_reference(
                coords, g, hs, ws, "edge_zero"), 5),
            **_bound(_nbytes(coords, g, imgs),
                     b * g[0, 0].numel() * (20 + 8 * c)),
            "library_ms": row.pop("library_ms"), **row})

    for s, (h, w) in enumerate(SCALES):
        tgt, src, cf, cb = pairs[s]
        n, hw = tgt.shape[0], h * w
        label = f"{n}x{h}x{w}"
        if s == 0:
            # K3, the image warps and the error maps run on scale 0 only.
            add("photo_single", label,
                lambda: K1.photo_sums(src, tgt, cb, ALPHA),
                lambda: K1.photo_sums_reference(src, tgt, cb, ALPHA),
                _photo_bound(_nbytes(tgt, src, cb, cb), n * hw))
            gather_case(src, cf, f"{n}x3x{h}x{w}", smooth_pairs[s][2])
            warped = K5.warp_gather_reference(src, cf, "edge_zero")
            g = torch.randn(tgt.shape, generator=gen).to(DEV)
            add("dssim_fwd", f"{n}x3x{h}x{w}",
                lambda: K7.dssim_forward(tgt, warped),
                lambda: K7.dssim_reference(tgt, warped),
                _bound(_nbytes(tgt, warped, g), DSSIM_FWD_FLOPS * 3 * n * hw),
                calls=2)
            # As the step calls it: the target frame wants no gradient.
            add("dssim_bwd", f"{n}x3x{h}x{w}",
                lambda: K7.dssim_backward(tgt, warped, g, need_dx=False),
                lambda: K7.dssim_backward_reference(tgt, warped, g, False,
                                                    True),
                _bound(_nbytes(tgt, warped, g, g),
                       DSSIM_BWD_FLOPS * 3 * n * hw), calls=2)
        else:
            v = pyr[s].reshape(nb, 3, 3, h, w)
            t1, s1 = v[:, 0].contiguous(), v[:, 1:].contiguous()
            c1f = cf.reshape(nb, 2, 2, h, w)
            c1b = cb.reshape(nb, 2, 2, h, w)
            add("photo_pair", f"{nb}x2x{h}x{w}",
                lambda: K1.photo_pair_sums(t1, s1, c1f, c1b, ALPHA),
                lambda: K1.photo_pair_sums_reference(t1, s1, c1f, c1b, ALPHA),
                _photo_bound(_nbytes(t1, s1, c1f, c1b, c1f, c1b),
                             2 * n * hw))
        wf, wb = (torch.rand(n, 1, h, w, generator=gen).to(DEV)
                  for _ in range(2))
        a4 = (tgt, src[:, None], cf[:, None].contiguous(),
              cb[:, None].contiguous())
        add("photo_pair_weighted", label,
            lambda: K1.photo_pair_weighted_sums(*a4, wf, wb, ALPHA),
            lambda: K1.photo_pair_sums_reference(*a4, ALPHA, wf, wb),
            _photo_bound(_nbytes(tgt, src, cf, cb, cf, cb, wf, wb),
                         2 * n * hw, extra=2))
        flow = (cb - pixel_grid(h, w, device=DEV)).contiguous()
        gather_case(flow, cf, f"{n}x2x{h}x{w}", smooth_pairs[s][2])
        splat_case(flow, cf, f"{n}x2x{h}x{w}", smooth_pairs[s][2])
        # K2 on the depth pyramid (3 views a sample, once) and on a flow
        # (both channels under one image; twice, forward and backward).
        for d, img, calls in ((1, pyr[s].contiguous(), 1), (2, tgt, 2)):
            depth = (torch.rand(img.shape[0], d, h, w, generator=gen) * 10
                     + 0.1).to(DEV)
            add("smooth", f"{img.shape[0]}x{d}x{h}x{w}",
                lambda: K2.smooth_sums(depth, img),
                lambda: K2.smooth_sums_reference(depth, img),
                _bound(_nbytes(depth, img, depth, depth),
                       SMOOTH_FLOPS * depth.numel()), calls=calls)
    totals, steps = {}, {}
    for name, shapes in rows.items():
        t_bytes = sum(r["bytes_ms"] for r in shapes)
        t_flops = sum(r["flops_ms"] for r in shapes)
        lib = [r["library_ms"] for r in shapes]
        totals[name] = {
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": None if None in lib else sum(lib),
            **{k: sum(r[k] for r in shapes)
               for k in ("kernel_flops_ms", "pr2_bound_ms")
               if k in shapes[0]}}
        if all("calls" in r for r in shapes):
            # Every launch of one step: each shape's one timed call (and
            # its bound) times the calls the step makes at that shape.
            steps[name] = {
                **{f"{k}_times_calls": sum(r[k] * r["calls"] for r in shapes)
                   for k in ("ms", "plain_ms", "bytes_ms", "flops_ms")},
                "calls": sum(r["calls"] for r in shapes)}
    emit("kernel_times", batch=nb, torch=torch.__version__, shapes=rows,
         totals=totals, step=steps)
    return totals


def phase_step(train_flow: bool) -> None:
    """One float32 step (stage 1, or stage 2 with ``train_flow``) from the
    same seeded weights on CPU and GPU."""
    import torch
    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.train import geonet
    cfg = GeoNetConfig(batch_size=2, compute_dtype=torch.float32,
                       train_flow=train_flow)
    batch = next(synthetic_batches(2, cfg.img_height, cfg.img_width, seed=5))
    res = {}
    for dev in ("cpu", DEV):
        state = geonet.create_train_state(cfg, dev)
        met = geonet.train_step(state, to_device(batch, torch.device(dev)),
                                cfg)
        res[dev] = {
            "loss": float(met["loss_total"]),
            "parts": {k: float(v) for k, v in met.items()},
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
    parts_rel = {k: abs(v - cpu["parts"][k]) / abs(cpu["parts"][k])
                 for k, v in gpu["parts"].items()}
    emit("step_flow" if train_flow else "step", loss_cpu=cpu["loss"],
         loss_gpu=gpu["loss"], loss_rel_err=loss_rel,
         loss_parts_rel_err=parts_rel, grad_rel_err_worst=worst,
         param_max_abs_err=max_param, param_frac_off=n_off / n_all)
    # Per-tensor gradient error is the norm of the difference over the norm
    # of the CPU gradient. The deepest DispNetS layers (1x4 maps at 128x416)
    # get gradients ~1e-8 that are sums of cancelling terms: float32
    # convolutions with other algorithms put them ~1e-2 apart (measured
    # 8.9e-3 on an H100, with the kernels or the plain versions alike), and
    # two GPU runs of the same step ~4e-4 apart. After Adam, entries whose
    # gradient is within rounding of zero may take the other sign: at most
    # 1% of them, none by more than 2 * lr.
    if not (max(parts_rel.values()) <= 1e-4 and worst[0][1] <= 2e-2
            and max_param <= 2 * lr and n_off <= 0.01 * n_all):
        raise AssertionError("CPU and GPU train steps disagree")


def _named(state):
    for key, net in state.nets().items():
        for n, p in net.named_parameters():
            yield f"{key}.{n}", p


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


def _used(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def phase_train() -> dict:
    steps = 20
    reset_launches()
    records, dt = _train([], steps)
    launches = _used(read_launches())
    losses = [r["loss_total"] for r in records]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"loss did not descend: {losses}")
    if launches != {"photo_pair": 4 * steps, "smooth": 4 * steps}:
        raise AssertionError(f"launches {launches}, want {4 * steps} each")

    big_steps = 6
    reset_launches()
    big, dt_big = _train(["--batch_size", "128"], big_steps)
    big_launches = _used(read_launches())
    if big_launches != {"photo_pair": 4 * big_steps,
                        "smooth": 4 * big_steps}:
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


def _finite(x: float) -> bool:
    return x == x and abs(x) < float("inf")


def phase_train_flow() -> dict:
    """Stage 2 at B = FLOW_BATCH, bf16: a few steps through ``train_geonet``
    with a checkpoint at the end, then the benchmark CLI's flow family.
    Every kernel's launches grow by what the code path predicts per step."""
    from sndepth_tpu_torch.cli import benchmark
    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    from sndepth_tpu_torch.train.loop import train_geonet
    steps = 4
    cfg = GeoNetConfig(batch_size=FLOW_BATCH, train_flow=True)
    reset_launches()
    state, records = train_geonet(
        cfg, synthetic_batches(FLOW_BATCH, *SCALES[0], seed=cfg.seed), steps,
        device=DEV, ckpt_dir=os.path.join(WORK_DIR, "ckpt_flow"),
        log_dir=os.path.join(WORK_DIR, "logs_flow"), log_every=1,
        ckpt_every=steps)
    launches = _used(read_launches())
    want = {k: v * steps for k, v in FLOW_STEP_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"stage-2 launches {launches}, want {want}")
    if state.step != steps or len(records) != steps:
        raise AssertionError(f"{state.step} of {steps} stage-2 steps ran")
    for r in records:
        for k, v in r.items():
            if k.startswith("loss") and not _finite(v):
                raise AssertionError(f"stage-2 step {r['step']}: {k} = {v}")
    del state

    iters = 5
    reset_launches()
    result, = benchmark.main(["--family", "flow", "--iters", str(iters),
                              "--device", DEV])
    bench_launches = _used(read_launches())
    want = {k: v * (iters + 2) for k, v in FLOW_STEP_LAUNCHES.items()}
    if bench_launches != want:
        raise AssertionError(f"benchmark launches {bench_launches}, "
                             f"want {want}")
    if result["family"] != "flow" or not result["ms_per_step"] > 0:
        raise AssertionError(f"benchmark result {result}")
    emit("train_flow", steps=steps, batch=FLOW_BATCH, records=records,
         launches=launches, benchmark=result,
         benchmark_launches=bench_launches)
    return launches


NNET_HW = (128, 416)            # the fused pipeline's frame
# Card against CPU, float32 (TF32 off), from the same seeded weights:
# relative difference by norm of the normals, the depth and the decoder's
# maps, the test's whole-net tolerance (tests/test_torch_nnet.py). D2N's
# closed-form solve follows the last bits of its normal equations (a 33 x 33
# window of points along nearly parallel rays: condition numbers of 1e4 and
# more, singular where few taps agree), so the card takes the CPU's D2N
# output, as the test takes JAX's; D2N is held apart on the CPU's inputs:
# its agreement, point patches and normal equations within NNET_D2N_TOL by
# norm, and the solve of the CPU's equations bit for bit (elementwise
# operations only). End to end, the two float32 normals must agree with a
# float64 solve to 1e-2 on at least NNET_D2N_SHARE of the pixels, and with
# each other within NNET_D2N_DETERMINED_TOL by norm there. These limits are
# looser than the test's (99%, 1e-4 at 64x96): the camera grid spans a
# fixed field of view, so a 9 x 9 window's rays span 4.4 times less angle
# across at 416 wide than at 96 (2 times less down, 128 against 64), and
# the frame's depth is smooth where the test's is noisy; both worsen the
# systems' conditioning (recorded on the H100: 92.0% of pixels, 3.5e-4).
NNET_TOL = 1e-4
NNET_D2N_TOL = 1e-5
NNET_D2N_SHARE = 0.85
NNET_D2N_DETERMINED_TOL = 1e-3


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _nnet_weights(seed: int) -> dict:
    """The full-width NNET's weights from ``seed``, its normal heads biased
    toward the camera (+3 in z), as a trained decoder's normals face it
    (tests/test_torch_nnet.py does the same)."""
    import torch
    from sndepth_tpu_torch.models import nnet as nnet_lib
    model = nnet_lib.NNET()
    nnet_lib.init_weights(model, torch.Generator().manual_seed(seed))
    dec = model.decoder
    with torch.no_grad():
        for head in (dec.out_conv_res8, dec.out_conv_res4[6],
                     dec.out_conv_res2[6], dec.out_conv_res1[6]):
            head.bias[2] += 3.0
    return model.state_dict()


def _nnet_inputs(h: int, w: int, seed: int):
    """A smooth log2-depth (B, H, W) and a random image (B, 3, H, W)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    pre = (1.5 + 0.5 * torch.sin(xx / 37.0) * torch.cos(yy / 23.0))[None]
    return pre, torch.rand(1, 3, h, w, generator=gen)


def _d2n_determined(angle, patches, n_a, n_b) -> "torch.Tensor":
    """Pixels where a float64 solve of the system (agreement ``angle``,
    point ``patches``) lies within 1e-2 of both float32 normals."""
    import torch
    from sndepth_tpu_torch.models import nnet as nnet_lib
    a = torch.where((angle > nnet_lib.THRESH)[:, :, :, None, :], patches,
                    torch.zeros_like(patches)).double().cpu()
    ata = torch.einsum("bhwit,bhwjt->bhwij", a, a)
    atb = a.sum(-1)
    ok = torch.linalg.det(ata) > 1e-5
    eye = torch.eye(3, dtype=torch.float64)
    x = torch.linalg.solve(torch.where(ok[..., None, None], ata, eye),
                           atb[..., None])[..., 0]
    x = torch.where(ok[..., None], x, atb)
    n64 = x / (x.norm(dim=-1, keepdim=True) + 1e-12) * 10
    return (((n_a.double().cpu() - n64).abs().amax(-1) <= 1e-2)
            & ((n_b.double().cpu() - n64).abs().amax(-1) <= 1e-2))


def _unit_normals_off(normals) -> float:
    """The largest distance of a normal's length from 1, over the normals
    that are not exactly zero; a zero normal may only lie on the border
    (the last propagation pulls the zero border in at full weight)."""
    norms = normals.float().norm(dim=-1).cpu()
    zero = norms == 0
    if zero[:, 1:-1, 1:-1].any():
        raise AssertionError("a zero normal inside the image")
    return float((norms[~zero] - 1).abs().max())


def phase_nnet(smi: str) -> dict:
    """The NNET serving stage at full width (EfficientNet-B5, the GN
    decoder, the refiner) at 128x416, B = 1: float32 on the card against
    the CPU from the same seeded weights, the card's D2N against the CPU's
    on the same inputs, then bf16 (the stage's default) on the card: finite,
    unit normals; frame times (CUDA events behind a spin, median of 10),
    peak memory and one frame's kernels by the profiler for both types."""
    import torch
    from sndepth_tpu_torch.models import nnet as nnet_lib
    from sndepth_tpu_torch.pipelines import NNETStage
    from sndepth_tpu_torch.train.loop import profiled_step
    h, w = NNET_HW
    sd = _nnet_weights(7)
    pre, rgb = _nnet_inputs(h, w, seed=8)
    real_d2n = nnet_lib.d2n_least_squares
    seen: dict = {}

    def cpu_d2n(n, p):
        out = real_d2n(n, p)
        seen["cpu"] = (n, p, out)
        return out

    def card_d2n(n, p):
        seen["card_in"] = (n, p)
        return tuple(t.to(n.device) for t in seen["cpu"][2])

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = NNETStage(sd, dtype=torch.float32, device="cpu")
        card = NNETStage(sd, dtype=torch.float32, device=DEV)
        nnet_lib.d2n_least_squares = cpu_d2n
        want = cpu(pre, rgb)
        nnet_lib.d2n_least_squares = card_d2n
        got = card(pre, rgb)
        torch.cuda.synchronize()
    finally:
        nnet_lib.d2n_least_squares = real_d2n
        torch.backends.cudnn.allow_tf32 = tf32
    n_cpu, p_cpu, d2n_cpu = seen["cpu"]
    f32 = {"normals_rel": _rel(got["normals"], want["normals"]),
           "depth_rel": _rel(got["depth"], want["depth"]),
           "d2n_normals_in_rel": _rel(seen["card_in"][0], n_cpu),
           "d2n_points_in_rel": _rel(seen["card_in"][1], p_cpu)}
    with torch.no_grad():
        d2n_card = real_d2n(n_cpu.to(DEV), p_cpu.to(DEV))
        sys_cpu = nnet_lib.normal_equations(n_cpu, p_cpu)
        sys_card = nnet_lib.normal_equations(n_cpu.to(DEV), p_cpu.to(DEV))
        solved = nnet_lib._solve3x3(sys_cpu[0].to(DEV), sys_cpu[1].to(DEV))
        torch.cuda.synchronize()
    determined = _d2n_determined(d2n_cpu[1], d2n_cpu[2], d2n_cpu[0],
                                 d2n_card[0])
    d2n = {"angle_rel": _rel(d2n_card[1], d2n_cpu[1]),
           "patches_rel": _rel(d2n_card[2], d2n_cpu[2]),
           "ata_rel": _rel(sys_card[0], sys_cpu[0]),
           "atb_rel": _rel(sys_card[1], sys_cpu[1]),
           "solve_bit_equal": bool(torch.equal(
               solved.cpu(), nnet_lib._solve3x3(sys_cpu[0], sys_cpu[1]))),
           "normals_rel": _rel(d2n_card[0], d2n_cpu[0]),
           "determined_share": float(determined.float().mean()),
           "normals_rel_determined": _rel(d2n_card[0].cpu()[determined],
                                          d2n_cpu[0][determined])}
    _assert_finite("nnet f32", got["normals"], got["depth"], *d2n_card)
    f32["unit_off"] = max(_unit_normals_off(got["normals"]),
                          _unit_normals_off(want["normals"]))
    for key in ("normals_rel", "depth_rel", "d2n_normals_in_rel",
                "d2n_points_in_rel", "unit_off"):
        if not f32[key] <= NNET_TOL:
            raise AssertionError(f"nnet f32, card against CPU: {key} "
                                 f"{f32[key]} > {NNET_TOL}")
    for key in ("angle_rel", "patches_rel", "ata_rel", "atb_rel"):
        if not d2n[key] <= NNET_D2N_TOL:
            raise AssertionError(f"nnet D2N: {key} {d2n[key]}")
    if not d2n["solve_bit_equal"]:
        raise AssertionError("nnet D2N: the solve of the same system differs")
    if not (d2n["determined_share"] >= NNET_D2N_SHARE
            and d2n["normals_rel_determined"] <= NNET_D2N_DETERMINED_TOL):
        raise AssertionError(
            f"nnet D2N end to end: {d2n['determined_share']} of pixels "
            f"determined (want >= {NNET_D2N_SHARE}), normals "
            f"{d2n['normals_rel_determined']} apart there (want <= "
            f"{NNET_D2N_DETERMINED_TOL})")

    times = {}
    pre_g, rgb_g = pre.to(DEV), rgb.to(DEV)
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        stage = card if dtype == torch.float32 else NNETStage(
            sd, dtype=dtype, device=DEV)
        out = stage(pre_g, rgb_g)
        torch.cuda.synchronize()
        _assert_finite(f"nnet {name}", out["normals"], out["depth"])
        torch.cuda.reset_peak_memory_stats()
        frame_ms = time_ms(lambda: stage(pre_g, rgb_g), 10)
        times[name] = {"frame_ms": frame_ms,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "unit_off": _unit_normals_off(out["normals"])}
        if not times[name]["unit_off"] <= 1e-3:
            raise AssertionError(f"nnet {name}: normals not unit: "
                                 f"{times[name]['unit_off']}")
        # One warm frame's kernels by the profiler.
        _, prof = profiled_step(lambda: stage(pre_g, rgb_g),
                                os.path.join(WORK_DIR, "trace"),
                                f"nnet_{name}", DEV)
        times[name]["profile"] = {
            "kernel_ms": prof["kernel_ms"], "launches": prof["launches"],
            "wall_ms": prof["wall_ms"],
            "idle_share": 1.0 - prof["kernel_ms"] / prof["wall_ms"],
            "ms_by_group": prof["ms_by_group"]}
        del stage
    emit("nnet", hw=[h, w], batch=1, nvidia_smi=smi, torch=torch.__version__,
         f32_card_vs_cpu=f32, d2n_card_vs_cpu=d2n, tolerance=NNET_TOL,
         frames=times)
    return times


def phase_predict_raft3d(smi: str) -> dict:
    """The fused prediction CLI on the card: GeoNet -> NNET -> RAFT3D over
    two synthetic batches at 128x416; the files it writes read back; 16
    launches of K8 and of K5 a frame and none of any other kernel."""
    import numpy as np
    from PIL import Image
    from sndepth_tpu_torch.cli import predict_raft3d
    frames = 2
    out_dir = os.path.join(WORK_DIR, "predict_raft3d")
    reset_launches()
    recs = predict_raft3d.main(["--synthetic", "--max_batches", str(frames),
                                "--out_dir", out_dir, "--device", DEV])
    launches = _used(read_launches())
    want = {k: v * frames for k, v in RAFT_FRAME_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"predict_raft3d: launches {launches}, want "
                             f"{want}")
    h, w = NNET_HW
    files = {}
    for i, rec in enumerate(recs):
        for name, path in rec["paths"].items():
            img = np.asarray(Image.open(path))
            if img.shape[:2] != (h, w) or img.dtype != np.uint8:
                raise AssertionError(f"{path}: {img.shape} {img.dtype}")
            files[os.path.basename(path)] = {"shape": list(img.shape),
                                             "std": float(img.std())}
    emit("predict_raft3d", hw=[h, w], frames=frames, nvidia_smi=smi,
         ms_per_frame=[rec["ms"] for rec in recs], launches=launches,
         files=files)
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
    errs = {"photo_pair": photo["max_abs_err"],
            "smooth": smooth["max_abs_err"], **phase_warp(), **phase_dssim(),
            **phase_photo_modes()}
    errs.update(phase_gn_build())
    errs.update(phase_gn_build_bwd())
    times = phase_kernel_times()
    raft_times, sampler_times = phase_kernel_times_raft3d()
    times.update(raft_times)
    phase_step(train_flow=False)
    phase_step(train_flow=True)
    phase_raft3d_step()
    phase_raft3d_train_step()
    stage1_launches = phase_train()
    launches = phase_train_flow()
    raft_launches = phase_raft3d()
    launches["gn_build"] = raft_launches["gn_build"]
    raft_train_launches = phase_raft3d_train()
    launches["gn_build_bwd"] = raft_train_launches["gn_build_bwd"]
    phase_nnet(smi)
    predict_launches = phase_predict_raft3d(smi)

    csrc = "sndepth_tpu_torch/kernels/csrc/"
    where = {
        "photo_pair": ("cuda", csrc + "photo_pair.cu",
                       "sndepth_tpu/kernels/photo_loss.py:586"),
        "smooth": ("cuda", csrc + "smooth_loss.cu",
                   "sndepth_tpu/kernels/smooth_loss.py:118"),
        "photo_single": ("cuda", csrc + "photo_pair.cu",
                         "sndepth_tpu/kernels/photo_loss.py:294"),
        "photo_pair_weighted": ("cuda", csrc + "photo_pair.cu",
                                "sndepth_tpu/kernels/photo_loss.py:586"),
        "warp_gather": ("cuda", csrc + "warp.cu",
                        "sndepth_tpu/kernels/warp.py:895"),
        "warp_coord_grad": ("cuda", csrc + "warp.cu",
                            "sndepth_tpu/kernels/warp.py:895"),
        "warp_splat": ("cuda", csrc + "warp.cu",
                       "sndepth_tpu/kernels/warp.py:1294"),
        "dssim_fwd": ("cuda", csrc + "dssim.cu",
                      "sndepth_tpu/kernels/dssim.py:156"),
        "dssim_bwd": ("cuda", csrc + "dssim.cu",
                      "sndepth_tpu/kernels/dssim.py:134"),
        "gn_build": ("cuda", csrc + "gn_build.cu",
                     "sndepth_tpu/kernels/gn_build.py:244"),
        "gn_build_bwd": ("cuda", csrc + "gn_build_bwd.cu",
                         "sndepth_tpu/kernels/gn_build.py:267 and :292"),
    }
    kernels = []
    for name, (route, source, replaces) in where.items():
        if not launches[name] > 0:
            raise AssertionError(f"{name} was never launched on the main path")
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "stage1_launches": stage1_launches.get(name, 0),
                        "max_abs_err": errs[name], **times[name]})
    # K5 runs on both paths: `launches` is the stage-2 train run's count,
    # `raft3d_launches` that of the RAFT3D frames (zero_pad mode, C = 1),
    # and `raft3d_zero_pad_c1` its times at those shapes, and K5b's.
    for k in kernels:
        if k["name"] in sampler_times:
            k["raft3d_launches"] = raft_launches.get(k["name"], 0)
            k["raft3d_zero_pad_c1"] = sampler_times[k["name"]]
    # K8 and K5 also run on the training path and in the fused prediction
    # CLI: their launches there.
    for k in kernels:
        if k["name"] in ("gn_build", "warp_gather"):
            k["raft3d_train_launches"] = raft_train_launches[k["name"]]
            k["predict_raft3d_launches"] = predict_launches[k["name"]]
        if k["name"] == "gn_build":
            k["err_over_tolerance"] = errs["gn_build_err_over_tol"]
        if k["name"] == "gn_build_bwd":
            k["err_over_tolerance"] = errs["gn_build_bwd_err_over_tol"]
    # K6's max_abs_err is over the cases whose tap weights stay near [0, 1];
    # the far-out edge_zero cases are held to their own tolerance.
    next(k for k in kernels if k["name"] == "warp_splat")[
        "far_out_max_abs_err"] = REPORT["warp"]["splat_far_out_max_abs_err"]
    REPORT["kernels"] = kernels
    REPORT["seconds"] = time.perf_counter() - t0
    write_report()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
