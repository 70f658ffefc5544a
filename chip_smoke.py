#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives GeoNet training of ``sndepth_tpu_torch`` at full width (DispNetS,
PoseNet and, in stage 2, FlowNet at the reference channel counts, 128x416,
3-frame snippets, 4 scales), RAFT3D scene-flow inference at full width
(hidden 128, 4 correlation levels, ResNet-50 FPN context net, 16 iterations,
at 128x416 and 376x1248) and RAFT3D training at full width (256x832, B = 2,
12 iterations, bf16 encoders), the NNET normal stack at full width and the
fused GeoNet -> NNET -> RAFT3D prediction through the kernels written for
Hopper, then MotionFusionNet serving and training, NNET training and the
fused GeoNet -> NNET -> rigid flow -> motion prediction (which launch no
hand-written kernel), RAFT2D and RAFT2D-Large flow (whose lookup launches
the gather kernel) in that prediction, the RAFT3D demo, the VAE /
diffusion stack (no hand-written kernel), and UniAD / BEVFormer tracking
at the reference config and its clip trainer (whose deformable attention,
DCNv2 and BEV shift sample through the gather kernel), and fails unless
every phase passes:

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
  motion     MotionStage at full width at 128x416: float32 card against
             CPU (logits by norm, the class map where decided); float32 and
             bf16 frames timed, one profiled
  motion_train  one float32 MotionFusionNet step at 64x128, B = 2, card
             against CPU, each against a float64 step on the card; the bf16
             step at B = 16, 384x768 through the benchmark CLI and profiled;
             ``train_motion`` for 5 steps
  nnet_train  one float32 NNET train step (B5 + decoder) at 64x96, B = 2,
             card against CPU with the CPU's sampled points handed across,
             each against a float64 step; the bf16 step at B = 4, 480x640
             through the benchmark CLI and profiled
  predict    the fused GeoNet -> NNET -> rigid flow -> motion CLI on two
             synthetic batches at 128x416: PNGs and poses.csv read back,
             classes in {0, 1, 2}, frame times; none of the eleven kernels
             launched on these four phases' paths
  raft2d     K5 and K5b against their plain versions on what RAFT2D-Large's
             lookup hands K5 in a real frame at 128x416 and 376x1248 (and
             with wild coordinates), and at a folded batch of 70,000
             planes; float32 RAFT2D-Large and RAFT2D frames at full width,
             128x416, 12 iterations, card against CPU; 48 K5 launches a
             RAFT2D-Large frame (none of any other kernel, none in a RAFT2D
             frame); frames timed and profiled; K5 at the lookup's level
             shapes beside its plain version, ``F.grid_sample`` and its
             bound
  predict_raft2d  the fused prediction CLI with ``--flow_source
             raft2d_large`` and ``raft2d`` on two synthetic batches: PNGs
             read back, 48 K5 launches a frame with RAFT2D-Large
  demo       the RAFT3D demo on its synthetic pair and on png / pfm files
             the phase writes: the panel read back, 16 launches of K8 and
             of K5 a frame
  vae        the AutoencoderKL at full width (B = 1, 128x416), the
             full-depth ViT and its multi-scale extractor and the pose
             denoiser, float32 card against CPU; ``testvae``,
             ``predict_vae`` and ``benchmark --family vae`` (B = 8,
             profiled); none of the eleven kernels launched
  uniad      the reference UniAD config (901 queries, 256 dims, 200x200
             BEV, 6 + 6 layers, caffe R101 with DCN and frozen BN) on a
             six-camera surround rig: float32 card and CPU against a
             float64 CPU run for two chained frames at 224x416 with a 50x50
             BEV (BEV, logits, boxes; the card within 10 times the CPU's
             distance; the carried dtypes kept), >= 50% of the BEV queries
             seen, 63
             K5 launches a chained 928x1600 frame, its time, peak memory and
             profile
  uniad_kernels  K5 and K5b against their plain versions on what a
             reference frame hands the sampler (MSDA levels at C = 32, DCN
             at C = 256 and 512, the BEV shift), K5b also against itself
             (two calls bit-equal), timed beside ``grid_sample`` and the
             bound with the launch each took; K6 at the train step's shapes
  predict_vae_uniad  the GeoNet -> NNET -> VAE -> UniAD CLI on two frames
  uniad_train  the small config's float32 train step card against CPU
             on a clip whose GTs sit on the model's detections (matcher and
             QIM decisions, slots kept, loss, gradients, AdamW); the
             reference config's step with remat at T = 2, 6 x 224x416: ms,
             peak memory, K5 / K5b / K6 launches, profile; ``train_uniad``
  ddp        a world-size-1 NCCL group: the float32 stage-1 and stage-2
             steps at 128x416, B = 2, through DDP against the plain step
             (bit-equal expected, else phase_step's gate, said which), each
             kernel's launches a step; FSDP2 against DDP, its bytes a rank;
             the three step times
  ddp_gloo2  two processes on the card over gloo, each on half a global
             batch of 4 at 128x416 (stage 2: shards whose masks differ),
             loss parts and parameters after Adam against the one-process
             step on the whole batch
  train_ddp  ``torchrun --nproc_per_node 1 -m ...cli.train_geonet``: 7
             bf16 stage-1 steps, a checkpoint each (5 kept), a resume to 9,
             descending loss, frames/sec
  export     ``cli/export_model`` on the card (dispnet, nnet, raft3d at
             128x416, 16 iterations), each artifact loaded in a fresh
             process against eager; the RAFT3D program's 16 K8 and K5
             launches a frame (custom operators)
  kitti_dp   ``kitti_submission --data_parallel`` under torchrun (one
             process) and in two processes over gloo: the files the writer
             writes without the flag

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


# chip_smoke's name of each kernel's launch counter in
# ``sndepth_tpu_torch.utils.tracing``.
COUNTER_NAMES = {"photo_pair": "K1", "smooth": "K2", "photo_single": "K3",
                 "photo_pair_weighted": "K4", "warp_gather": "K5",
                 "warp_coord_grad": "K5b", "warp_splat": "K6",
                 "dssim_fwd": "K7", "dssim_bwd": "K7b", "gn_build": "K8",
                 "gn_build_bwd": "K8b"}
_launch_base: dict = {}


def reset_launches() -> None:
    from sndepth_tpu_torch.utils import tracing
    _launch_base.update(tracing.counts())


def read_launches() -> dict:
    """Each kernel's launches since the last :func:`reset_launches`."""
    from sndepth_tpu_torch.utils import tracing
    now = tracing.counts()
    return {name: now[k] - _launch_base.get(k, 0)
            for name, k in COUNTER_NAMES.items()}


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
    from sndepth_tpu_torch.utils import tracing
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
    before = tracing.counts()["K8b"]
    H, g = K8.gn_build_hg(*args, GN_RADIUS)
    ct_H, ct_g = cotangents(1, 832)
    grads = torch.autograd.grad([H, g], [args[k] for k in (2, 3, 7, 8)],
                                [ct_H, ct_g])
    ref = K8.gn_build_hg_bwd_reference(*args, GN_RADIUS, ct_H, ct_g)
    _gn_bwd_compare("autograd", [None, None, grads[0], grads[1], None,
                                 grads[2], grads[3], None], ref)
    after = tracing.counts()["K8b"]
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
         gn_build_bwd_totals=bwd_totals,
         custom_op_host_us=_custom_op_host_costs(gen))
    return {"gn_build": total, **bwd_totals}, sampler


def _custom_op_host_costs(gen) -> dict:
    """The host's microseconds a call of K5 and of K8 as a RAFT3D frame
    makes them (no gradient wanted), at both frame sizes: through the
    operators ``torch.ops.sndepth.warp_gather`` / ``gn_build`` (the
    entry points now), and as the parent commit called them, an autograd
    Function around the check and the ctypes launch (``_BilinearSample``,
    ``_GNBuild``) with no operator between."""
    import torch
    from sndepth_tpu_torch.kernels import gn_build as K8
    from sndepth_tpu_torch.kernels import warp as K5

    class ParentSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, imgs, coords, mode):
            ctx.save_for_backward(imgs, coords)
            K5._check(imgs, coords, mode)
            return K5._launch_gather(imgs, coords, mode)

    class ParentBuild(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args[:-1])
            return K8._launch(*args)

    rows = {"warp_gather": [], "gn_build": []}
    with torch.no_grad():
        for h, w in RAFT_SIZES:
            h8, w8 = h // 8, w // 8
            depth, coords = _sampler_inputs(h8, w8, gen)
            args = _gn_inputs(1, h8, w8, 60)
            label = f"1x{h8}x{w8}"
            rows["warp_gather"].append({
                "shape": label,
                "host_us": _host_us(lambda: K5.bilinear_sample(
                    depth, coords, "zero_pad")),
                "parent_host_us": _host_us(lambda: ParentSample.apply(
                    depth, coords, "zero_pad"))})
            rows["gn_build"].append({
                "shape": label,
                "host_us": _host_us(lambda: K8.gn_build_hg(*args,
                                                           GN_RADIUS)),
                "parent_host_us": _host_us(lambda: (
                    K8._check(*args), ParentBuild.apply(*args, GN_RADIUS)))})
    return rows


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
    from sndepth_tpu_torch.utils import tracing
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
            before = tracing.counts()
            want = cpu(*frame, iters=2)
            got = gpu(*map(to_dev, frame), iters=2)
            torch.cuda.synchronize()
            after = tracing.counts()
            built, sampled = (after[k] - before[k] for k in ("K8", "K5"))
            if built != 0 or sampled != 2:
                raise AssertionError(
                    f"bilaplacian forward: K8 launched {built} times (want "
                    f"0), K5 {sampled} (want 2)")
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
        # Samples wholly outside the image: where C > 3 and a whole
        # warp's lie outside, zero_pad reads none of their taps;
        # grid_sample reads no tap outside.
        "outside_share": float(((x < -1) | (x > ws) | (y < -1) | (y > hs))
                               .float().mean()),
        "launch": K5.sampler_launch_config(imgs, coords),
        "ms": time_ms(lambda: fwd(mode), 10),
        "plain_ms": time_ms(
            lambda: K5.warp_gather_reference(imgs, coords, mode), 5),
        **_bound(_nbytes(imgs, coords, out), b * npix * (20 + 7 * c)),
        "library_ms": time_ms(grid_sample, 10)}
    coord = {
        "launch": K5.sampler_launch_config(imgs, coords, g),
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
    # On the steps that replay CUDA graphs these counts are copied from the
    # capture; tests/test_torch_step_graphs.py holds them against the
    # device kernels in a profile of a replay.
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


MOTION_HW = (128, 416)          # the fused prediction's frame
# MotionStage, card against CPU in float32 (TF32 off), from the same seeded
# weights: the logits within MOTION_TOL by norm, the class map equal
# wherever the top two logits are more than MOTION_MARGIN apart.
MOTION_TOL = 1e-4
MOTION_MARGIN = 1e-3
# A float32 train step on the card against the same step on the CPU, from
# the same seeded weights and batch. Through the full depth of either net a
# train step is ill-conditioned in float32 (BatchNorm on batch statistics
# layer after layer: two float32 evaluations of MotionFusionNet's step part
# by ~7% on their gradients, tests/test_torch_motion.py), so each float32
# step is measured against a float64 step on the card: the loss within
# STEP_LOSS_TOL of the CPU's, and the card's distance from the float64 step
# (the gradients and the running statistics by norm over all tensors, the
# share of weights more than a hundredth of a learning rate off after the
# update, the median over the tensors of each one's gradient by its norm)
# at most STEP_YARDSTICK times the CPU's plus STEP_FLOOR; the weights no
# entry more than 2 learning rates from the CPU's.
STEP_LOSS_TOL = 1e-4
STEP_YARDSTICK = 2.0
STEP_FLOOR = {"grads_rel": 1e-6, "grads_rel_tensor_median": 1e-6,
              "stats_rel": 1e-6, "params_frac_off": 1e-3}


def _no_hand_written_launches(name: str) -> dict:
    """The hand-written kernels' launch counts since the last reset: the
    motion and NNET paths launch none of them."""
    launches = _used(read_launches())
    if launches:
        raise AssertionError(f"{name}: hand-written kernels launched: "
                             f"{launches}")
    return {k: 0 for k in read_launches()}


def _motion_weights(seed: int) -> dict:
    import torch
    from sndepth_tpu_torch.models import motionseg
    model = motionseg.MotionFusionNet()
    motionseg.init_weights(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def _motion_inputs(b: int, h: int, w: int, seed: int):
    """A random image and the colouring of a smooth flow, (B, 3, H, W) in
    [0, 1]."""
    import numpy as np
    import torch
    from sndepth_tpu_torch.utils.visualize import flow_to_rgb
    gen = torch.Generator().manual_seed(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    flows = [np.stack([np.sin(xx / 31.0 + i) * 6, np.cos(yy / 17.0) * 3], -1)
             for i in range(b)]
    flow_rgb = torch.from_numpy(np.stack([flow_to_rgb(f) for f in flows]))
    return (torch.rand(b, 3, h, w, generator=gen),
            flow_rgb.permute(0, 3, 1, 2).contiguous())


def phase_motion(smi: str) -> dict:
    """MotionStage at full width at 128x416, B = 1: float32 on the card
    against the CPU from the same seeded weights (TF32 off), then a float32
    (TF32 convolutions, as served) and a bf16 frame timed (CUDA events
    behind a spin, median of 10) with their peak memory, and one float32
    frame's kernels by the profiler."""
    import torch
    from sndepth_tpu_torch.models import motionseg
    from sndepth_tpu_torch.pipelines import MotionStage
    from sndepth_tpu_torch.train.loop import profiled_step
    h, w = MOTION_HW
    sd = _motion_weights(11)
    img, flow = _motion_inputs(1, h, w, seed=12)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = MotionStage(sd, device="cpu")
        card = MotionStage(sd, device=DEV)
        with torch.no_grad():
            want = cpu.model(img, flow)
            reset_launches()
            got = card.model(img.to(DEV), flow.to(DEV))
            pred = card(img, flow)
            torch.cuda.synchronize()
        launches = _no_hand_written_launches("motion")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    _assert_finite("motion logits", got, want)
    top2 = want.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > MOTION_MARGIN
    want_pred = want.argmax(1)
    check = {"logits_rel": _rel(got, want),
             "decided_share": float(decided.float().mean()),
             "pred_differs_where_decided": int(
                 ((pred.cpu() != want_pred) & decided).sum()),
             "classes": sorted(int(c) for c in pred.unique())}
    if not check["logits_rel"] <= MOTION_TOL:
        raise AssertionError(f"motion logits, card against CPU: "
                             f"{check['logits_rel']} > {MOTION_TOL}")
    if check["pred_differs_where_decided"]:
        raise AssertionError(f"motion class map, card against CPU: "
                             f"{check['pred_differs_where_decided']} pixels")
    if not set(check["classes"]) <= {0, 1, 2}:
        raise AssertionError(f"motion classes {check['classes']}")

    frames = {}
    img_g, flow_g = img.to(DEV), flow.to(DEV)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = motionseg.MotionFusionNet(dtype=dtype)
        model.load_state_dict(sd)
        model.to(DEV).eval()

        def frame():
            with torch.no_grad():
                return model(img_g, flow_g).argmax(1)

        out = frame()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        frames[name] = {"frame_ms": time_ms(frame, 10),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "classes": sorted(int(c) for c in out.unique())}
        if name == "f32":
            _, prof = profiled_step(frame, os.path.join(WORK_DIR, "trace"),
                                    "motion_f32", DEV)
            frames[name]["profile"] = {
                "kernel_ms": prof["kernel_ms"], "launches": prof["launches"],
                "wall_ms": prof["wall_ms"],
                "idle_share": 1.0 - prof["kernel_ms"] / prof["wall_ms"],
                "ms_by_group": prof["ms_by_group"]}
        del model
    emit("motion", hw=[h, w], batch=1, nvidia_smi=smi,
         f32_card_vs_cpu=check, tolerance=MOTION_TOL, margin=MOTION_MARGIN,
         frames=frames, hand_written_launches=launches)
    return frames


def _step_distances(run: dict, ref: dict) -> dict:
    """Distances of one train step's results from another's: gradients and
    running statistics by norm over all tensors, each tensor's gradient by
    its norm (floored at 1e-5 of the global norm; the median and the worst
    three), the largest weight difference and the share of weights more
    than 0.01 ``lr`` apart."""
    import torch

    def global_rel(a: dict, b: dict) -> float:
        num = sum(float(((a[k].double() - b[k].double()) ** 2).sum())
                  for k in b)
        den = sum(float((b[k].double() ** 2).sum()) for k in b)
        return (num / max(den, 1e-300)) ** 0.5

    floor = 1e-5 * sum(float((g.double() ** 2).sum())
                       for g in ref["grads"].values()) ** 0.5
    per_tensor = sorted(
        ((float((run["grads"][k].double() - g.double()).norm()
                / max(float(g.double().norm()), floor)), k)
         for k, g in ref["grads"].items()), reverse=True)

    n_off = n_all = 0
    max_d = 0.0
    for k, p in ref["params"].items():
        d = (run["params"][k].double() - p.double()).abs()
        max_d = max(max_d, float(d.max()))
        n_off += int((d > 0.01 * ref["lr"]).sum())
        n_all += d.numel()
    return {"grads_rel": global_rel(run["grads"], ref["grads"]),
            "grads_rel_tensor_median": per_tensor[len(per_tensor) // 2][0],
            "grads_rel_tensor_worst": per_tensor[:3],
            "stats_rel": global_rel(run["stats"], ref["stats"]),
            "params_over_lr": max_d / ref["lr"],
            "params_frac_off": n_off / n_all,
            "loss_rel": abs(run["loss"] - ref["loss"]) / abs(ref["loss"])}


def _step_record(state, metrics: dict, lr: float) -> dict:
    named = list(state.model.named_parameters())
    for n, p in named:
        _assert_finite(f"gradient {n}", p.grad)
    return {"loss": float(metrics["loss"]), "lr": lr,
            "grads": {n: p.grad.detach().cpu() for n, p in named},
            "params": {n: p.detach().cpu() for n, p in named},
            "stats": {n: b.detach().cpu().clone()
                      for n, b in state.model.named_buffers()
                      if "running" in n}}


def _compare_steps(name: str, runs: dict) -> dict:
    """The card's float32 step against the CPU's, each measured against the
    card's float64 step (STEP_YARDSTICK)."""
    card, cpu, f64 = runs["card"], runs["cpu"], runs["card_f64"]
    d_card, d_cpu = _step_distances(card, f64), _step_distances(cpu, f64)
    direct = _step_distances(card, cpu)
    got = {"card_vs_f64": d_card, "cpu_vs_f64": d_cpu, "card_vs_cpu": direct}
    if not direct["loss_rel"] <= STEP_LOSS_TOL:
        raise AssertionError(f"{name}: loss, card against CPU, "
                             f"{direct['loss_rel']} > {STEP_LOSS_TOL}")
    if not direct["params_over_lr"] <= 2.01:
        raise AssertionError(f"{name}: a weight {direct['params_over_lr']} "
                             "learning rates from the CPU's")
    for key, floor in STEP_FLOOR.items():
        if not d_card[key] <= STEP_YARDSTICK * d_cpu[key] + floor:
            raise AssertionError(
                f"{name}: {key} from the float64 step, card {d_card[key]} "
                f"against CPU {d_cpu[key]}")
    return got


def _train_family_run(family: str, smi: str) -> dict:
    """The family's bf16 train step through ``cli/benchmark.py`` at its JAX
    defaults (ms/step, img/s, peak memory, hand-written launches) and one
    warm step's kernels through ``cli/profile_step.py``."""
    import torch
    from sndepth_tpu_torch.cli import benchmark, profile_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = benchmark.main(["--family", family, "--device", DEV])[0]
    launches = _no_hand_written_launches(f"{family} benchmark")
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not (result["family"] == family and result["ms_per_step"] > 0):
        raise AssertionError(f"benchmark result {result}")
    profile = profile_step.main(["--family", family, "--steps", "1"])
    result["step_profile"] = {k: profile[k] for k in (
        "batch", "hw", "launches_per_step", "kernel_ms_per_step",
        "wall_ms_per_step", "idle_share", "ms_by_group")}
    result["hand_written_launches"] = launches
    result["nvidia_smi"] = smi
    return result


def phase_motion_train(smi: str) -> dict:
    """MotionFusionNet training at full width: one float32 step at 64x128,
    B = 2, card against CPU from the same seeded weights and batch (TF32
    off; each against a float64 step on the card); the bf16 step at B = 16,
    384x768 through the benchmark CLI's ``motion`` family; ``train_motion``
    for a few steps on the synthetic stream, its checkpoint written."""
    import torch
    from sndepth_tpu_torch.cli import train_motion
    from sndepth_tpu_torch.data.kitti_motion import synthetic_motion_batches
    from sndepth_tpu_torch.models import motionseg
    from sndepth_tpu_torch.train import loop
    from sndepth_tpu_torch.train import motion as tmt
    h, w = 64, 128
    sd = _motion_weights(13)
    batch = {k: torch.from_numpy(v) for k, v in
             next(synthetic_motion_batches(2, h, w, seed=14)).items()}
    batch["image"] = torch.rand(2, h, w, 3,
                                generator=torch.Generator().manual_seed(15))
    runs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, dev, dtype in (("cpu", "cpu", torch.float32),
                                 ("card", DEV, torch.float32),
                                 ("card_f64", DEV, torch.float64)):
            model = motionseg.MotionFusionNet(dtype=dtype)
            model.load_state_dict(sd)
            state = tmt.create_train_state(model.to(dtype), dev)
            reset_launches()
            met = tmt.train_step(state, {
                k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                for k, v in batch.items()})
            if dev == DEV:
                torch.cuda.synchronize()
                _no_hand_written_launches(f"motion step {name}")
            runs[name] = _step_record(state, met, tmt.lr_at(0))
            del state, model
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    step = _compare_steps("motion train step", runs)

    bench = _train_family_run("motion", smi)

    steps = 5
    ckpt_dir = os.path.join(WORK_DIR, "ckpt_motion")
    reset_launches()
    state, records = train_motion.main(
        ["--max_steps", str(steps), "--log_every", "1", "--device", DEV,
         "--data_dir", os.path.join(WORK_DIR, "no_data"),
         "--ckpt_dir", ckpt_dir])
    cli_launches = _no_hand_written_launches("train_motion")
    if len(records) != steps or not all(
            _finite(r["loss"]) and 0 <= r["pixel_acc"] <= 1
            for r in records):
        raise AssertionError(f"train_motion records {records}")
    if not os.path.exists(os.path.join(ckpt_dir, loop.MOTION_MODEL_FILE)):
        raise AssertionError("train_motion wrote no checkpoint")
    del state
    emit("motion_train", nvidia_smi=smi, step_hw=[h, w], step_batch=2,
         step=step, loss_cpu=runs["cpu"]["loss"],
         loss_card=runs["card"]["loss"], yardstick=STEP_YARDSTICK,
         benchmark=bench, cli_steps=steps, cli_records=records,
         hand_written_launches=cli_launches)
    return bench


def phase_nnet_train(smi: str) -> dict:
    """NNET training at full width (EfficientNet-B5, the GN decoder): one
    float32 step at 64x96, B = 2, card against CPU from the same seeded
    weights and batch, the CPU's sampled rows and columns handed to the
    card (TF32 off; each against a float64 step on the card); the bf16 step
    at B = 4, 480x640 through the benchmark CLI's ``nnet`` family."""
    import numpy as np
    import torch
    from sndepth_tpu_torch.cli.train_nnet import synthetic_batches
    from sndepth_tpu_torch.models import nnet as nnet_lib
    from sndepth_tpu_torch.models import normal_decoder
    from sndepth_tpu_torch.train import nnet as tn
    h, w = 64, 96
    start = tn.NormalNet()
    nnet_lib.init_weights(start, torch.Generator().manual_seed(16))
    sd = start.state_dict()
    del start
    raw = next(synthetic_batches(2, h, w, seed=17))
    raw["mask"] = np.random.RandomState(18).rand(2, h, w) > 0.2
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    real_sample = normal_decoder.sample_points
    drawn: list = []

    def recording(*args):
        out = real_sample(*args)
        drawn.append(tuple(t.cpu() for t in out))
        return out

    runs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, dev, dtype in (("cpu", "cpu", torch.float32),
                                 ("card", DEV, torch.float32),
                                 ("card_f64", DEV, torch.float64)):
            model = tn.NormalNet(dtype)
            model.load_state_dict(sd)
            state = tn.create_train_state(model.to(dtype), dev)
            if name == "cpu":
                normal_decoder.sample_points = recording
            else:
                handed = iter(drawn)
                normal_decoder.sample_points = lambda *a: tuple(
                    t.to(DEV) for t in next(handed))
            reset_launches()
            met = tn.train_step(state, {
                k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
                for k, v in batch.items()})
            if dev == DEV:
                torch.cuda.synchronize()
                _no_hand_written_launches(f"nnet step {name}")
            runs[name] = _step_record(state, met, tn.LR)
            del state, model
    finally:
        normal_decoder.sample_points = real_sample
        torch.backends.cudnn.allow_tf32 = tf32
    if len(drawn) != 3:
        raise AssertionError(f"the sampler drew {len(drawn)} levels")
    step = _compare_steps("nnet train step", runs)
    bench = _train_family_run("nnet", smi)
    emit("nnet_train", nvidia_smi=smi, step_hw=[h, w], step_batch=2,
         step=step, loss_cpu=runs["cpu"]["loss"],
         loss_card=runs["card"]["loss"], yardstick=STEP_YARDSTICK,
         samples_per_level=[int(r.shape[1]) for r, _ in drawn],
         benchmark=bench)
    return bench


def phase_predict(smi: str) -> dict:
    """The fused prediction CLI (GeoNet -> NNET -> rigid flow ->
    MotionFusionNet) on two synthetic batches at 128x416: its PNGs and
    ``poses.csv`` read back, classes in {0, 1, 2}, each frame's time, no
    hand-written kernel launched."""
    import csv

    import numpy as np
    from PIL import Image
    from sndepth_tpu_torch.cli import predict
    frames = 2
    out_dir = os.path.join(WORK_DIR, "predict")
    reset_launches()
    recs = predict.main(["--synthetic", "--max_batches", str(frames),
                         "--out_dir", out_dir, "--device", DEV])
    launches = _no_hand_written_launches("predict")
    h, w = MOTION_HW
    files = {}
    for i, rec in enumerate(recs):
        if not set(np.unique(rec["seg"])) <= {0, 1, 2}:
            raise AssertionError(f"predict: classes {np.unique(rec['seg'])}")
        for name, path in rec["paths"][0].items():
            img = np.asarray(Image.open(path))
            if img.shape[:2] != (h, w) or img.dtype != np.uint8:
                raise AssertionError(f"{path}: {img.shape} {img.dtype}")
            files[os.path.basename(path)] = {"shape": list(img.shape),
                                             "std": float(img.std())}
    with open(os.path.join(out_dir, "poses.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0][0] != "source_index" or len(rows) != 3 or not all(
            _finite(float(x)) for r in rows[1:] for x in r):
        raise AssertionError(f"predict: poses.csv {rows}")
    emit("predict", hw=[h, w], frames=frames, nvidia_smi=smi,
         ms_per_frame=[rec["ms"] for rec in recs],
         seg_class_shares=[np.bincount(rec["seg"].ravel(),
                                       minlength=3).tolist() for rec in recs],
         files=files, poses_rows=len(rows) - 1,
         hand_written_launches=launches)
    return launches


RAFT2D_HW = ((128, 416), (376, 1248))   # the fused prediction; a KITTI frame
RAFT2D_ITERS = 12               # the prediction CLI's default
RAFT2D_LEVELS = 4
# RAFT2DLarge's lookup: one K5 call a pyramid level an iteration.
RAFT2D_FRAME_LAUNCHES = {"warp_gather": RAFT2D_LEVELS * RAFT2D_ITERS}
# A folded batch past the 65535 images a grid's y dimension holds.
K5_BIG_BATCH = 70_000
# Float32 RAFT2D frames, card against CPU (TF32 off), from the same seeded
# weights with the flow head's last layer scaled by RAFT2D_HEAD_SCALE, so
# that an iteration moves the flow by a pixel or less, as a trained net
# does: the upsampled flow within RAFT2D_TOL by norm. (With an O(10) pixel
# random step a coordinate's last bits decide which bilinear piece of the
# lookup it lands on, and float32 noise grows from iteration to
# iteration.)
RAFT2D_HEAD_SCALE = 0.01
RAFT2D_TOL = 1e-4


def _lookup_inputs(model, h: int, w: int, seed: int) -> list:
    """What RAFT2DLarge's lookup hands K5 in the last of 12 iterations of a
    frame at h x w: per level, the (B h/8 w/8, 1, h_l, w_l) planes and the
    (B h/8 w/8, 2, 9, 9) coordinates (recorded through a wrapper around the
    sampler the model calls)."""
    import torch
    from sndepth_tpu_torch.models import raft2d
    gen = torch.Generator().manual_seed(seed)
    img1, img2 = (torch.rand(1, 3, h, w, generator=gen).to(DEV)
                  for _ in range(2))
    calls = []
    real = raft2d.bilinear_sampler_zero_pad

    def record(imgs, coords):
        calls.append((imgs, coords))
        return real(imgs, coords)

    raft2d.bilinear_sampler_zero_pad = record
    try:
        with torch.no_grad():
            model(img1, img2, iters=RAFT2D_ITERS)
    finally:
        raft2d.bilinear_sampler_zero_pad = real
    return calls[-RAFT2D_LEVELS:]


def _lookup_bytes(imgs, coords) -> dict:
    """Bytes the lookup's gather must move: the coordinates and samples,
    and of the planes either all of them (``plane``) or only the cells its
    taps touch (``tap_cells``: each query's window, one cell wider than
    its 9x9 taps for the bilinear blend, cut to its plane; each cell
    counted once a query)."""
    import torch
    b, c, hs, ws = imgs.shape

    def span(v, size):
        lo = torch.floor(v.flatten(1).amin(1)).clamp(min=0)
        hi = (torch.floor(v.flatten(1).amax(1)) + 1).clamp(max=size - 1)
        return (hi - lo + 1).clamp(min=0)

    cells = (span(coords[:, 0], ws) * span(coords[:, 1], hs)).sum()
    io = _nbytes(coords) + coords[:, :1].numel() * c * 4
    return {"plane": io + _nbytes(imgs),
            "tap_cells": io + float(cells) * c * 4}


def _lookup_rows(calls, gen) -> list:
    """K5 at each level's call: kernel, plain version and ``F.grid_sample``
    (zeros padding, align_corners=True) timed, with the bound counted on
    the cells the taps touch and on the whole plane."""
    import torch
    import torch.nn.functional as F
    from sndepth_tpu_torch.kernels import warp as K5
    rows = []
    for level, (imgs, coords) in enumerate(calls):
        b, c, hs, ws = imgs.shape
        npix = coords.shape[2] * coords.shape[3]
        grid = torch.stack([coords[:, 0] * (2.0 / (ws - 1)) - 1.0,
                            coords[:, 1] * (2.0 / (hs - 1)) - 1.0], -1)
        flops = b * npix * (20 + 7 * c)
        nbytes = _lookup_bytes(imgs, coords)
        by_rows = _bound(nbytes["tap_cells"], flops)
        by_plane = _bound(nbytes["plane"], flops)
        rows.append({
            "level": level, "imgs": list(imgs.shape),
            "coords": list(coords.shape),
            "launch": K5.sampler_launch_config(imgs, coords),
            "ms": time_ms(lambda: K5.warp_gather(imgs, coords, "zero_pad"),
                          10),
            "plain_ms": time_ms(lambda: K5.warp_gather_reference(
                imgs, coords, "zero_pad"), 5),
            "library_ms": time_ms(lambda: F.grid_sample(
                imgs, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), 10),
            "bound_counts": "tap_cells", **by_rows,
            "bound_ms": max(by_rows["bytes_ms"], by_rows["flops_ms"]),
            "bound_by": ("bytes" if by_rows["bytes_ms"] >= by_rows["flops_ms"]
                         else "operations"),
            "plane_bytes": nbytes["plane"],
            "plane_bound_ms": max(by_plane["bytes_ms"], by_plane["flops_ms"])})
    return rows


def _k5_case(name: str, imgs, coords, gen) -> dict:
    """K5 and K5b against their plain versions on one call (the tolerances
    of ``phase_warp``)."""
    import torch
    from sndepth_tpu_torch.kernels import warp as K5
    g = torch.randn(imgs.shape[0], imgs.shape[1], *coords.shape[2:],
                    generator=gen).to(DEV)
    got = K5.warp_gather(imgs, coords, "zero_pad")
    want = K5.warp_gather_reference(imgs, coords, "zero_pad")
    dc_k = K5.warp_coord_grad(imgs, coords, g, "zero_pad")
    dc_p = K5.warp_coord_grad_reference(imgs, coords, g, "zero_pad")
    torch.cuda.synchronize()
    _assert_finite(f"K5 {name}", got, dc_k)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dc_k, dc_p, atol=1e-5, rtol=1e-5)
    return {"case": name, "imgs": list(imgs.shape),
            "coords": list(coords.shape), "gather_err": _max_err(got, want),
            "coord_grad_err": _max_err(dc_k, dc_p),
            "bit_equal": bool(torch.equal(got, want))}


def _raft2d_pair(arch: str, seed: int):
    """One seeded RAFT2D (``native``) or RAFT2DLarge (``large``) in float32
    twice, on the CPU and on the card, the flow head scaled as
    RAFT2D_HEAD_SCALE says."""
    import torch
    from sndepth_tpu_torch.models import raft2d
    from sndepth_tpu_torch.models.raft3d import init_weights
    cpu = (raft2d.RAFT2DLarge() if arch == "large" else raft2d.RAFT2D()).eval()
    init_weights(cpu, torch.Generator().manual_seed(seed))
    head = (cpu.update_block.flow_head.conv2 if arch == "large"
            else cpu.update.delta[2])
    with torch.no_grad():
        head.weight.mul_(RAFT2D_HEAD_SCALE)
    card = (raft2d.RAFT2DLarge() if arch == "large" else raft2d.RAFT2D())
    card.load_state_dict(cpu.state_dict())
    return cpu, card.to(DEV).eval()


def phase_raft2d(smi: str) -> tuple[dict, dict]:
    """RAFT2D and RAFT2DLarge at full width on the card. K5 (and K5b) against
    their plain versions on what RAFT2DLarge's lookup hands K5 in a real
    frame at 128x416 and 376x1248, on the same planes with wild
    coordinates, and at a folded batch of 70,000 planes of 4x6; a float32
    frame of each net at 128x416, 12 iterations, card against CPU (TF32
    off); 48 K5 launches and no other kernel's in a RAFT2DLarge frame
    through ``Raft2DFlowStage``, none in a RAFT2D frame; each frame timed
    and one profiled; K5 at the lookup's level shapes timed beside its plain
    version and ``F.grid_sample``."""
    import torch
    from sndepth_tpu_torch.kernels import warp as K5
    from sndepth_tpu_torch.pipelines import Raft2DFlowStage
    from sndepth_tpu_torch.train.loop import profiled_step
    gen = torch.Generator().manual_seed(31)
    checks, lookup = [], {}
    stages = {}
    for h, w in RAFT2D_HW:
        stage = Raft2DFlowStage(iters=RAFT2D_ITERS, arch="large", device=DEV)
        calls = _lookup_inputs(stage.model, h, w, seed=h)
        for level, (imgs, coords) in enumerate(calls):
            checks.append(_k5_case(f"{h}x{w} level {level}", imgs, coords,
                                   gen))
            h8 = imgs.shape[3]
            wild = coords + ((torch.rand(coords.shape, generator=gen) - 0.5)
                             * 4 * (h8 + 8)).to(DEV)
            checks.append(_k5_case(f"{h}x{w} level {level} wild", imgs, wild,
                                   gen))
        lookup[f"{h}x{w}"] = _lookup_rows(calls, gen)
        stages[(h, w)] = stage
        del calls
    big = torch.rand(K5_BIG_BATCH, 1, 4, 6, generator=gen).to(DEV)
    big_coords = (torch.rand(K5_BIG_BATCH, 2, 9, 9, generator=gen) * 12
                  - 3).to(DEV)
    checks.append(_k5_case(f"folded batch {K5_BIG_BATCH}", big, big_coords,
                           gen))
    del big, big_coords

    # Float32 frames, card against CPU.
    h, w = RAFT2D_HW[0]
    img1, img2 = (torch.rand(1, 3, h, w, generator=gen) for _ in range(2))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    f32 = {}
    try:
        for arch in ("large", "native"):
            cpu, card = _raft2d_pair(arch, seed=32)
            with torch.no_grad():
                lo_c, up_c = cpu(img1, img2, iters=RAFT2D_ITERS,
                                 train_mode=True)
                lo_g, up_g = card(img1.to(DEV), img2.to(DEV),
                                  iters=RAFT2D_ITERS, train_mode=True)
            torch.cuda.synchronize()
            _assert_finite(f"RAFT2D {arch}", up_g, up_c)
            f32[arch] = {"flow_up_rel": _rel(up_g, up_c),
                         "flow_rel": _rel(lo_g, lo_c),
                         "flow_up_max_abs": _max_err(up_g.cpu(), up_c),
                         "flow_up_mean_abs_px": float(up_c.abs().mean())}
            del cpu, card
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    # Frames through the stage, as the prediction CLI runs them.
    frames = {}
    native = Raft2DFlowStage(iters=RAFT2D_ITERS, arch="native", device=DEV)
    for (h, w), stage in stages.items():
        for arch, st in (("large", stage), ("native", native)):
            a, b = (torch.rand(1, 3, h, w, generator=gen).to(DEV)
                    for _ in range(2))
            reset_launches()
            flow = st(a, b)
            torch.cuda.synchronize()
            launches = _used(read_launches())
            want = RAFT2D_FRAME_LAUNCHES if arch == "large" else {}
            if launches != want:
                raise AssertionError(f"RAFT2D {arch} {h}x{w} frame: launches "
                                     f"{launches}, want {want}")
            _assert_finite(f"RAFT2D {arch} {h}x{w} frame", flow)
            torch.cuda.reset_peak_memory_stats()
            rec = {"launches": launches,
                   "frame_ms": time_ms(lambda: st(a, b), 5),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            if (h, w) == RAFT2D_HW[0]:
                _, prof = profiled_step(lambda: st(a, b),
                                        os.path.join(WORK_DIR, "trace"),
                                        f"raft2d_{arch}", DEV)
                rec["profile"] = {
                    "kernel_ms": prof["kernel_ms"],
                    "launches": prof["launches"], "wall_ms": prof["wall_ms"],
                    "idle_share": 1.0 - prof["kernel_ms"] / prof["wall_ms"],
                    "ms_by_group": prof["ms_by_group"]}
            frames[f"{arch} {h}x{w}"] = rec
    del stages, native
    emit("raft2d", nvidia_smi=smi, k5_checks=checks, f32_card_vs_cpu=f32,
         tolerance=RAFT2D_TOL, head_scale=RAFT2D_HEAD_SCALE, frames=frames,
         lookup_times=lookup, torch=torch.__version__)
    for arch, rec in f32.items():
        if not rec["flow_up_rel"] <= RAFT2D_TOL:
            raise AssertionError(f"RAFT2D {arch}, card against CPU: "
                                 f"{rec['flow_up_rel']} > {RAFT2D_TOL}")
    err = max(max(c["gather_err"] for c in checks),
              max(c["coord_grad_err"] for c in checks))
    return {"warp_gather": err}, lookup


def phase_predict_raft2d(smi: str) -> dict:
    """The fused prediction CLI with RAFT2D flow, each ``--flow_source``,
    on two synthetic batches at 128x416: its PNGs read back, 48 K5 launches
    a frame with RAFT2DLarge and no hand-written launch with the native
    RAFT2D, frame times."""
    import numpy as np
    from PIL import Image
    from sndepth_tpu_torch.cli import predict
    frames = 2
    h, w = MOTION_HW
    out, counts = {}, {}
    for source in ("raft2d_large", "raft2d"):
        out_dir = os.path.join(WORK_DIR, f"predict_{source}")
        reset_launches()
        recs = predict.main(["--synthetic", "--max_batches", str(frames),
                             "--flow_source", source, "--out_dir", out_dir,
                             "--device", DEV])
        launches = _used(read_launches())
        want = ({k: v * frames for k, v in RAFT2D_FRAME_LAUNCHES.items()}
                if source == "raft2d_large" else {})
        if launches != want:
            raise AssertionError(f"predict {source}: launches {launches}, "
                                 f"want {want}")
        files = {}
        for rec in recs:
            if not set(np.unique(rec["seg"])) <= {0, 1, 2}:
                raise AssertionError(f"predict {source}: classes "
                                     f"{np.unique(rec['seg'])}")
            for path in rec["paths"][0].values():
                img = np.asarray(Image.open(path))
                if img.shape[:2] != (h, w) or img.dtype != np.uint8:
                    raise AssertionError(f"{path}: {img.shape} {img.dtype}")
                files[os.path.basename(path)] = float(img.std())
        out[source] = {"ms_per_frame": [rec["ms"] for rec in recs],
                       "launches": launches, "png_std": files}
        counts[source] = launches
    emit("predict_raft2d", hw=[h, w], frames=frames, nvidia_smi=smi, **out)
    return counts


def phase_demo(smi: str) -> dict:
    """The RAFT3D demo on the card: its synthetic pair, then a png pair
    with pfm depths that the phase writes (117x203, edge padded to
    120x208): the panel read back, finite tau / phi, 16 launches of K8 and
    of K5 a frame and none of any other kernel."""
    import numpy as np
    from PIL import Image
    from sndepth_tpu_torch.cli import demo
    from sndepth_tpu_torch.data.frame_codecs import write_pfm
    rng = np.random.RandomState(33)
    work = os.path.join(WORK_DIR, "demo")
    os.makedirs(work, exist_ok=True)
    args = []
    for i in (1, 2):
        Image.fromarray(rng.randint(0, 256, (117, 203, 3), np.uint8)).save(
            os.path.join(work, f"im{i}.png"))
        write_pfm(os.path.join(work, f"d{i}.pfm"),
                  (2 + 8 * rng.rand(117, 203)).astype(np.float32))
        args += [f"--image{i}", os.path.join(work, f"im{i}.png"),
                 f"--depth{i}", os.path.join(work, f"d{i}.pfm")]
    runs = {}
    for name, extra, hw in (("synthetic", [], (64, 96)),
                            ("files", args, (120, 208))):
        out = os.path.join(work, f"{name}.png")
        reset_launches()
        rec = demo.main(extra + ["--out", out, "--device", DEV])
        launches = _used(read_launches())
        if launches != RAFT_FRAME_LAUNCHES:
            raise AssertionError(f"demo {name}: launches {launches}, want "
                                 f"{RAFT_FRAME_LAUNCHES}")
        if not np.isfinite(rec["tau_phi"]).all():
            raise AssertionError(f"demo {name}: non-finite tau / phi")
        panel = np.asarray(Image.open(out))
        if panel.shape != (hw[0], 2 * hw[1], 3):
            raise AssertionError(f"demo {name}: panel {panel.shape}")
        runs[name] = {"hw": list(hw), "ms": rec["ms"], "launches": launches,
                      "panel_std": float(panel.std())}
    emit("demo", nvidia_smi=smi, **runs)
    return runs


# The VAE stack in float32, card against CPU (TF32 off), from the same
# seeded weights: each output within VAE_TOL by norm.
VAE_TOL = 1e-4
VAE_HW = (128, 416)


def phase_vae(smi: str) -> dict:
    """The VAE / diffusion stack at full width: the AutoencoderKL at B = 1,
    128x416 (posterior and the reconstruction of a draw with the same
    noise), the full-depth ViT at 128x416 and its multi-scale extractor, and
    ``get_opt_model()`` on 32 tracks, each float32 card against CPU (TF32
    off); then ``testvae``, ``predict_vae`` (two frames) and ``benchmark
    --family vae`` (B = 8, profiled) on the card. None of the eleven kernels
    is launched."""
    import torch
    from sndepth_tpu_torch.cli import predict_vae, testvae
    from sndepth_tpu_torch.models import denoiser, vae, vit
    h, w = VAE_HW
    gen = torch.Generator().manual_seed(41)
    reset_launches()

    def pair(make, seed):
        cpu = make().eval()
        # The shared seeded init, and a ViT's embeddings where there is one.
        vit.init_weights(cpu, torch.Generator().manual_seed(seed))
        card = make()
        card.load_state_dict(cpu.state_dict())
        return cpu, card.to(DEV).eval()

    x = torch.rand(1, 4, h, w, generator=gen)
    noise = torch.randn(1, 4, h // 8, w // 8, generator=gen)
    img = torch.rand(1, 3, h, w, generator=gen)
    poses = torch.randn(1, 32, 9, generator=gen)
    t = torch.tensor([500.0])
    z = torch.randn(1, 32, 384, generator=gen)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    check = {}
    try:
        with torch.no_grad():
            cpu, card = pair(vae.AutoencoderKL, 42)
            for side, model, dev in (("cpu", cpu, "cpu"), ("card", card, DEV)):
                post = model.encode(x.to(dev))
                rec = model.decode(post.sample(noise.to(dev)))
                check[side] = (post.mean, post.logvar, rec)
            check = {"vae_" + k: _rel(g, c) for k, g, c in zip(
                ("mean", "logvar", "reconstruction"), check["card"],
                check["cpu"])}
            cpu, card = pair(vit.MultiScaleImageFeatureExtractor, 43)
            check["vit_cls"] = _rel(card.net(img.to(DEV)), cpu.net(img))
            check["vit_multiscale"] = _rel(card(img.to(DEV)), cpu(img))
            cpu, card = pair(denoiser.get_opt_model, 44)
            check["denoiser"] = _rel(card(poses.to(DEV), t.to(DEV), z.to(DEV)),
                                     cpu(poses, t, z))
            del cpu, card
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    smoke = testvae.main(["--device", DEV])
    _assert_finite("testvae", smoke["mean"], smoke["var"])
    recs = predict_vae.main(["--max_batches", "2", "--device", DEV,
                             "--out_dir", os.path.join(WORK_DIR,
                                                       "predict_vae")])
    for rec in recs:
        if rec["mean"].shape != (1, h // 8, w // 8, 4):
            raise AssertionError(f"predict_vae latent {rec['mean'].shape}")
    launches = _no_hand_written_launches("vae")
    bench = _train_family_run("vae", smi)
    emit("vae", hw=[h, w], nvidia_smi=smi, f32_card_vs_cpu=check,
         tolerance=VAE_TOL,
         testvae_mean_shape=list(smoke["mean"].shape),
         predict_vae_ms=[rec["ms"] for rec in recs], benchmark=bench,
         hand_written_launches=launches)
    for key, value in check.items():
        if not value <= VAE_TOL:
            raise AssertionError(f"VAE stack, card against CPU: {key} "
                                 f"{value} > {VAE_TOL}")
    return bench


# --- UniAD / BEVFormer tracking ---------------------------------------------

UNIAD_HW = (928, 1600)          # the reference's nuScenes camera frames
UNIAD_SMALL_HW = (224, 416)     # card against CPU, and the train step
UNIAD_SMALL_BEV = 50
# Card against CPU (TF32 off), from the same seeded weights: the BEV, the
# logits and the boxes of two chained frames, each float32 run against a
# float64 run on the CPU by norm; the card's distance within
# UNIAD_F64_FACTOR times the float32 CPU run's plus UNIAD_F64_FLOOR. The
# seeded decoder's box refinement moves a reference point by several cells
# a layer, the next layer samples there, and float32 rounding grows through
# that loop some 300-700 times from the BEV to frame 2's logits, by an
# amount that varies from one float32 evaluation to another: on the same
# inputs the CPU run read 4.0e-4 and 7.0e-4 there in two runs, the card
# 1.5e-3 and 1.8e-3 (1.6x-3.8x the CPU's; on the BEV 1.7x).
UNIAD_F64_FACTOR = 10.0
UNIAD_F64_FLOOR = 1e-5
UNIAD_SEEN_SHARE = 0.5          # BEV queries a camera of the rig must see
# K5 launches in a reference frame with an ego shift: spatial
# cross-attention 4 levels x 6 layers, temporal self-attention 6, the
# decoder 6, the DCN 3x3 of the 23 + 3 blocks of stages 3 and 4, and the
# shift of the previous BEV.
UNIAD_FRAME_LAUNCHES = {"warp_gather": 4 * 6 + 6 + 6 + 23 + 3 + 1}
UNIAD_TRAIN_T = 2
# A reference train step (remat, T frames, no shift): each frame samples
# 62 times forward and again in the recomputed attention sublayers of the
# backward (4 x 6 + 6 + 6); every call's coordinates and values want a
# gradient, so each has one K5b and one K6.
UNIAD_TRAIN_LAUNCHES = {"warp_gather": UNIAD_TRAIN_T * (62 + 36),
                        "warp_coord_grad": UNIAD_TRAIN_T * 62,
                        "warp_splat": UNIAD_TRAIN_T * 62}
# The small config's float32 train step, card against CPU with the same
# QIM draws: the matcher and QIM decisions equal, the loss within
# UNIAD_STEP_LOSS_TOL, each gradient tensor within UNIAD_STEP_GRAD_TOL by
# norm (floored at 1e-5 of the global norm), the weights after AdamW within
# 2 learning rates and at most UNIAD_STEP_FRAC_OFF of them 0.01 of a rate
# off (the first Adam update is the rate times a gradient's sign, which
# noise decides where a gradient is zero).
UNIAD_STEP_LOSS_TOL = 1e-5
UNIAD_STEP_GRAD_TOL = 1e-4
UNIAD_STEP_FRAC_OFF = 1e-3


def _uniad_pair(bev: int, seed: int):
    """The reference config with a ``bev`` x ``bev`` BEV three times from
    the same seeded weights, its offsets spread on the card over the small
    frames: float32 on the CPU and on the card, float64 on the CPU."""
    import torch
    from sndepth_tpu_torch.models import uniad_track as ut
    from sndepth_tpu_torch.utils.uniad import surround_lidar2img
    h, w = UNIAD_SMALL_HW
    gen = torch.Generator().manual_seed(seed)
    card = ut.uniad_reference_config(bev_h=bev, bev_w=bev)
    ut.init_weights(card, gen)
    card = card.to(DEV).eval()
    imgs = torch.rand(6, 1, 3, h, w, generator=gen)
    l2i = surround_lidar2img(h, w)
    ut.spread_offsets(card, lambda: card(imgs.to(DEV), l2i.to(DEV),
                                         card.init_state()), gen)
    cpu = ut.uniad_reference_config(bev_h=bev, bev_w=bev).eval()
    cpu.load_state_dict(card.state_dict())
    wide = ut.uniad_reference_config(bev_h=bev, bev_w=bev,
                                     dtype=torch.float64).double().eval()
    wide.load_state_dict(card.state_dict())
    return cpu, card, wide, imgs, l2i


def _wide_state(state):
    """``state`` with its floating tensors in float64."""
    from sndepth_tpu_torch.models import uniad_track as ut
    f = lambda v: v.double() if v.is_floating_point() else v
    return ut.TrackState(
        prev_bev=f(state.prev_bev),
        tracks=ut.TrackInstances(**{k: f(v) for k, v in
                                    state.tracks.tensors().items()}),
        next_obj_id=state.next_obj_id, timestamp=f(state.timestamp),
        has_prev=state.has_prev)


def _rel64(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-300))


def _uniad_card_vs_cpu() -> dict:
    """Two chained frames (the second with an ego shift and rotation) at
    224x416 with a 50x50 BEV and the reference widths and depth, in float32
    on the card and on the CPU (TF32 off) and in float64 on the CPU: the
    BEV, the logits and the boxes of each float32 run against the other and
    against the float64 run, by norm; the carried state's dtypes unchanged
    in the float32 runs."""
    import torch
    cpu, card, wide, imgs, l2i = _uniad_pair(UNIAD_SMALL_BEV, 52)
    shift = torch.tensor([[0.04, -0.02]])
    rot = torch.tensor([5.0])
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out, seconds = {}, {}
    runs = (("cpu", cpu, "cpu", torch.float32),
            ("card", card, DEV, torch.float32),
            ("float64", wide, "cpu", torch.float64))
    try:
        with torch.no_grad():
            for side, model, dev, dt in runs:
                t0 = time.perf_counter()
                cast = lambda x: x.to(dev, dt)
                state0 = model.init_state()
                if dt == torch.float64:
                    state0 = _wide_state(state0)
                s1, _ = model(cast(imgs), cast(l2i), state0, timestamp=0.5)
                s2, r2 = model(cast(imgs), cast(l2i), s1, timestamp=1.0,
                               ego_shift=cast(shift),
                               ego_rotation_deg=cast(rot))
                dtypes = {k: (v.dtype, s2.tracks.tensors()[k].dtype)
                          for k, v in state0.tracks.tensors().items()}
                dtypes["prev_bev"] = (state0.prev_bev.dtype,
                                      s2.prev_bev.dtype)
                changed = {k: v for k, v in dtypes.items() if v[0] != v[1]}
                if changed:
                    raise AssertionError(f"UniAD {side}: carried dtypes "
                                         f"changed {changed}")
                out[side] = (s1, s2, r2)
                if dev == DEV:
                    torch.cuda.synchronize()
                seconds[side] = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32

    def distances(got, want):
        d = {}
        for i in (0, 1):
            g, c = got[i], want[i]
            d[f"bev_{i + 1}"] = _rel64(g.prev_bev, c.prev_bev)
            d[f"logits_{i + 1}"] = _rel64(g.tracks.pred_logits,
                                          c.tracks.pred_logits)
            d[f"boxes_{i + 1}"] = _rel64(g.tracks.pred_boxes,
                                         c.tracks.pred_boxes)
        return d

    (c1, c2, cr), (g1, g2, gr) = out["cpu"], out["card"]
    for i, g in enumerate((g1, g2), 1):
        _assert_finite(f"UniAD frame {i}", g.prev_bev, g.tracks.pred_logits)
    scores = torch.cat([c1.tracks.track_scores, c2.tracks.track_scores])
    margin = float(torch.minimum((scores - 0.4).abs(),
                                 (scores - 0.35).abs()).min())
    same_ids = bool(torch.equal(g2.tracks.obj_idxes.cpu(),
                                c2.tracks.obj_idxes))
    if margin > 1e-3 and not same_ids:
        raise AssertionError("UniAD card against CPU: track ids differ "
                             f"with scores {margin} from a threshold")
    cpu64 = distances(out["cpu"], out["float64"])
    card64 = distances(out["card"], out["float64"])
    return {"rel": distances(out["card"], out["cpu"]),
            "cpu_vs_float64": cpu64, "card_vs_float64": card64,
            "tolerance": {k: UNIAD_F64_FACTOR * v + UNIAD_F64_FLOOR
                          for k, v in cpu64.items()},
            "seconds": seconds, "score_margin": margin,
            "same_track_ids": same_ids,
            "tracks_born": int((c2.tracks.obj_idxes >= 0).sum()),
            "detections_valid": int(cr["valid"].sum())}


def phase_uniad(smi: str) -> dict:
    """UniAD tracking at the reference config (901 queries, 256 dims, a
    200x200 BEV, 6 + 6 layers, the caffe R101 with DCN in stages 3-4 and
    frozen BatchNorm) on six surround cameras at 928x1600, float32: the
    card and the CPU against a float64 CPU run at reduced spatial size
    (224x416, a 50x50 BEV),
    the share of BEV queries the rig's cameras see, one chained frame's
    launches of K5 against the count derived from the code, the frame time
    (CUDA events behind a spin, median of 5 warm chained frames), peak
    memory and one profiled frame."""
    import torch
    from sndepth_tpu_torch.cli.profile_step import uniad_frame
    from sndepth_tpu_torch.models import bevformer
    from sndepth_tpu_torch.train.loop import profiled_step
    check = _uniad_card_vs_cpu()
    h, w = UNIAD_HW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, imgs, l2i, frame = uniad_frame(h, w, DEV, seed=53)
    pillar = bevformer.bev_pillar_points(model.bev_h, model.bev_w, 4,
                                         model.pc_range, DEV)
    _, mask = bevformer.project_points_to_cams(pillar, l2i, h, w)
    seen = float(mask.any(-1).any(0).float().mean())
    if not seen >= UNIAD_SEEN_SHARE:
        raise AssertionError(f"UniAD rig: {seen} of the BEV queries seen")
    frame()                                  # the first frame: no shift
    reset_launches()
    state, results = frame()
    torch.cuda.synchronize()
    launches = _used(read_launches())
    if launches != UNIAD_FRAME_LAUNCHES:
        raise AssertionError(f"UniAD frame: launches {launches}, want "
                             f"{UNIAD_FRAME_LAUNCHES}")
    _assert_finite("UniAD reference frame", state.prev_bev,
                   state.tracks.pred_logits, results["bboxes"])
    frame_ms = time_ms(frame, 5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, prof = profiled_step(frame, os.path.join(WORK_DIR, "trace"),
                            "uniad_frame", DEV)
    profile = {"kernel_ms": prof["kernel_ms"], "launches": prof["launches"],
               "wall_ms": prof["wall_ms"],
               "idle_share": 1.0 - prof["kernel_ms"] / prof["wall_ms"],
               "ms_by_group": prof["ms_by_group"],
               "host_top": _host_top(frame)}
    del model, imgs, frame, state, results
    emit("uniad", hw=[h, w], bev=[200, 200], nvidia_smi=smi,
         f32_card_vs_cpu=check, bev_seen_share=seen,
         launches_per_frame=launches, frame_ms=frame_ms, peak_gb=peak,
         profile=profile)
    for key, value in check["card_vs_float64"].items():
        if not value <= check["tolerance"][key]:
            raise AssertionError(f"UniAD card against float64: {key} "
                                 f"{value} > {check['tolerance'][key]}")
    return launches


def _host_top(step, n: int = 12) -> list:
    """The host's busiest operators in one ``step()``: torch.profiler's CPU
    self time by operator, ms, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [{"op": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3,
             "calls": e.count} for e in rows[:n]]


def _record_sampler_calls(run) -> dict:
    """The first call of each distinct shape that the UniAD modules hand
    the sampler during ``run()``: {label: (imgs, coords)}."""
    from sndepth_tpu_torch.models import bevformer, deformable
    calls = {}
    real = deformable.bilinear_sampler_zero_pad

    def recorder(site):
        def record(imgs, coords):
            b, c, hs, ws = imgs.shape
            if site == "shift":
                label = "BEV shift"
            elif coords.shape[3] == 9:
                label = f"DCN C={c}"
            else:
                label = f"MSDA {b}x{c}x{hs}x{ws}"
            label += f" <- {tuple(coords.shape)}"
            calls.setdefault(label, (imgs.detach().contiguous(),
                                     coords.detach().contiguous()))
            return real(imgs, coords)
        return record

    deformable.bilinear_sampler_zero_pad = recorder("deformable")
    bevformer.bilinear_sampler_zero_pad = recorder("shift")
    try:
        run()
    finally:
        deformable.bilinear_sampler_zero_pad = real
        bevformer.bilinear_sampler_zero_pad = real
    return calls


def _splat_case(label: str, imgs, coords, gen) -> dict:
    """K6 against its plain version on one call (PR 6's calibrated
    tolerance: 1e-5 plus 4 times the float32 plain version's distance from
    a float64 evaluation), and K6 timed beside the plain version, one
    ``index_add_`` of the four taps' weighted cotangents and the bound."""
    import torch
    from sndepth_tpu_torch.kernels import warp as K5
    b, c, hs, ws = imgs.shape
    g = torch.randn(b, c, *coords.shape[2:], generator=gen).to(DEV)
    d_k = K5.warp_splat(coords, g, hs, ws, "zero_pad")
    d_p = K5.warp_splat_reference(coords, g, hs, ws, "zero_pad")
    d_64 = K5.warp_splat_reference(coords.double(), g.double(), hs, ws,
                                   "zero_pad")
    torch.cuda.synchronize()
    _assert_finite(f"K6 {label}", d_k)
    err = _max_err(d_k, d_p)
    tol = 1e-5 + 4.0 * _max_err(d_p.double(), d_64)
    del d_64
    if not err <= tol:
        raise AssertionError(f"K6 {label}: {err} > {tol}")
    idx, (wx0, wx1, wy0, wy1), _ = K5._taps(coords, hs, ws, "zero_pad")
    base = (torch.arange(b, device=DEV) * (hs * ws))[:, None]
    index = torch.cat([(i + base).reshape(-1) for i in idx])
    values = torch.cat([(wt * g).permute(0, 2, 3, 1).reshape(-1, c)
                        for wt in (wx0 * wy0, wx0 * wy1, wx1 * wy0,
                                   wx1 * wy1)])
    out = torch.zeros(b * hs * ws, c, device=DEV)
    row = {"case": label, "imgs": list(imgs.shape),
           "coords": list(coords.shape), "max_abs_err": err, "tol": tol,
           "path": _splat_path(hs, ws),
           "ms": time_ms(lambda: K5.warp_splat(coords, g, hs, ws,
                                               "zero_pad"), 10),
           "plain_ms": time_ms(lambda: K5.warp_splat_reference(
               coords, g, hs, ws, "zero_pad"), 3),
           "library_ms": time_ms(lambda: out.index_add_(0, index, values),
                                 10),
           **_bound(_nbytes(coords, g, imgs),
                    b * g[0, 0].numel() * (20 + 8 * c))}
    return row


def _with_bound(row: dict) -> dict:
    row["bound_ms"] = max(row["bytes_ms"], row["flops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["flops_ms"]
                       else "operations")
    return row


def phase_uniad_kernels(smi: str) -> dict:
    """K5 and K5b against their plain versions on what the UniAD modules
    hand the sampler in a reference frame (the MSDA levels at C = 32, the
    DCN 3x3 at C = 256 and 512, the BEV shift at C = 256), each timed
    beside its plain version, ``F.grid_sample`` (and its backward for K5b)
    and its bound; K6 against its plain version, and timed, on what a
    frame of the train step's shapes (6 cameras at 224x416, a 200x200 BEV)
    hands the sampler."""
    import torch
    from sndepth_tpu_torch.cli.profile_step import uniad_frame
    from sndepth_tpu_torch.kernels import warp as K5
    gen = torch.Generator().manual_seed(54)
    sizes = {"reference": UNIAD_HW, "train": UNIAD_SMALL_HW}
    calls = {}
    for name, (h, w) in sizes.items():
        model, _, _, frame = uniad_frame(h, w, DEV, seed=55)
        frame()
        calls[name] = _record_sampler_calls(frame)
        del model, frame
    checks, gather_rows, coord_rows, splat_rows = [], [], [], []
    for label, (imgs, coords) in calls["reference"].items():
        check = _k5_case(label, imgs, coords, gen)
        g = torch.randn(imgs.shape[0], imgs.shape[1], *coords.shape[2:],
                        generator=gen).to(DEV)
        d1, d2 = (K5.warp_coord_grad(imgs, coords, g, "zero_pad")
                  for _ in range(2))
        check["coord_grad_bit_equal"] = bool(torch.equal(
            d1, K5.warp_coord_grad_reference(imgs, coords, g, "zero_pad")))
        # K5b sums its channel groups in a fixed order: the same bits from
        # call to call.
        check["coord_grad_rerun_bit_equal"] = bool(torch.equal(
            d1.view(torch.int32), d2.view(torch.int32)))
        del g, d1, d2
        checks.append(check)
        gather, coord = _sampler_rows(imgs, coords, gen, mode="zero_pad")
        gather_rows.append(_with_bound({"case": label, **gather}))
        coord_rows.append(_with_bound({"case": label, **coord}))
        torch.cuda.empty_cache()
    for label, (imgs, coords) in calls["train"].items():
        if "shift" not in label:
            splat_rows.append(_with_bound(_splat_case(label, imgs, coords,
                                                      gen)))
        torch.cuda.empty_cache()
    not_bit_equal = [c["case"] for c in checks if not c["bit_equal"]]
    not_rerun_equal = [c["case"] for c in checks
                       if not c["coord_grad_rerun_bit_equal"]]
    emit("uniad_kernels", nvidia_smi=smi, k5_checks=checks,
         gather=gather_rows, coord_grad=coord_rows, splat=splat_rows,
         k5_not_bit_equal=not_bit_equal,
         k5b_not_rerun_bit_equal=not_rerun_equal)
    if not_bit_equal:
        raise AssertionError(f"K5 not bit-equal to its plain version at "
                             f"{not_bit_equal}")
    if not_rerun_equal:
        raise AssertionError(f"K5b differs between two calls at "
                             f"{not_rerun_equal}")
    return {"errs": {"warp_gather": max(c["gather_err"] for c in checks),
                     "warp_coord_grad": max(c["coord_grad_err"]
                                            for c in checks),
                     "warp_splat": max(r["max_abs_err"] for r in splat_rows)},
            "times": {"warp_gather": gather_rows,
                      "warp_coord_grad": coord_rows,
                      "warp_splat": splat_rows}}


def phase_predict_vae_uniad(smi: str) -> dict:
    """``cli/predict_vae_uniad.py`` on the card for two frames at the JAX
    CLI's 64x64: its box files read back, finite, and K5 launched on the
    track model's path (its DCN, attention and BEV sampling)."""
    import numpy as np
    from sndepth_tpu_torch.cli import predict_vae_uniad
    out_dir = os.path.join(WORK_DIR, "predict_vae_uniad")
    reset_launches()
    recs = predict_vae_uniad.main(["--frames", "2", "--out_dir", out_dir,
                                   "--device", DEV])
    launches = _used(read_launches())
    if not launches.get("warp_gather", 0) > 0 or set(launches) != {
            "warp_gather"}:
        raise AssertionError(f"predict_vae_uniad: launches {launches}")
    for rec in recs:
        boxes = np.load(rec["path"])
        if boxes.ndim != 2 or boxes.shape[1] != 9 or not np.isfinite(
                boxes).all():
            raise AssertionError(f"{rec['path']}: {boxes.shape}")
    emit("predict_vae_uniad", nvidia_smi=smi, launches=launches,
         ms_per_frame=[rec["ms"] for rec in recs],
         active_tracks=[rec["active_tracks"] for rec in recs])
    return launches


def _uniad_step_record(state, metrics: dict) -> dict:
    named = list(state.model.named_parameters())
    for n, p in named:
        _assert_finite(f"gradient {n}", p.grad)
    return {"loss": float(metrics["loss_total"]), "lr": 2e-4,
            "grads": {n: p.grad.detach().cpu() for n, p in named},
            "params": {n: p.detach().cpu() for n, p in named}, "stats": {},
            "decisions": [{k: v.cpu() for k, v in d.items()}
                          for d in state.decisions]}


def phase_uniad_train(smi: str) -> dict:
    """UniAD training. The small config's float32 step (the train CLI's
    ``--small`` clip: T = 3, 4 GTs, 64x64, the GTs on the model's own
    detections) card against CPU from the same seeded weights and QIM draws
    (TF32 off): the matcher's ``assigned`` and ``matched`` and the QIM
    ``keep`` of every frame equal, a slot kept in every frame, the QIM's
    and memory bank's gradients nonzero, then the loss,
    the gradients (each tensor by norm, floored at 1e-5 of the global norm,
    before the clip) and the weights after AdamW. Then the reference config
    with ``remat`` on a clip of T = 2 frames of 6 cameras at 224x416:
    ms/step (median of 3 after a warm-up), peak memory, the K5, K5b and K6
    launches of a step against the count derived from the code, one
    profiled step; and ``cli/train_uniad.py --small`` for 3 steps."""
    import torch
    from sndepth_tpu_torch.cli import train_uniad
    from sndepth_tpu_torch.cli.profile_step import uniad_train_step
    from sndepth_tpu_torch.models import uniad_track as ut
    from sndepth_tpu_torch.train import uniad as tu
    from sndepth_tpu_torch.train.loop import profiled_step
    # The small step, card against CPU.
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        base = train_uniad.small_model()
        ut.init_weights(base, torch.Generator().manual_seed(56))
        gen = torch.Generator().manual_seed(57)
        draws = [tuple(torch.rand(2, base.num_query, generator=gen))
                 for _ in range(3)]
        # The GTs on the model's own detections, so that the QIM keeps
        # slots and its update and the memory bank reach the loss.
        clip = tu.clip_with_gts_on_detections(
            base, tu.synthetic_clip(base, t_frames=3, ng=4, img_hw=(64, 64)),
            draws)
        for side, dev in (("cpu", "cpu"), ("card", DEV)):
            model = train_uniad.small_model()
            model.load_state_dict(base.state_dict())
            state = tu.create_train_state(model, dev)
            metrics = tu.train_step(state, tu.clip_to(clip, dev),
                                    [tuple(d.to(dev) for d in f)
                                     for f in draws])
            # Gradients before the clip: the clip's scale undone.
            scale = max(float(metrics["grad_norm"]) / tu.CLIP_NORM, 1.0)
            for p in model.parameters():
                p.grad.mul_(scale)
            runs[side] = _uniad_step_record(state, metrics)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for t, (dc, dg) in enumerate(zip(runs["cpu"]["decisions"],
                                     runs["card"]["decisions"])):
        for k in dc:
            if not torch.equal(dc[k], dg[k]):
                raise AssertionError(f"UniAD step frame {t}: {k} differs, "
                                     f"card {dg[k]} CPU {dc[k]}")
        if not bool(dc["keep"].any()):
            raise AssertionError(f"UniAD step frame {t}: no slot kept")
    for side, run in runs.items():
        idle = [n for n, g in run["grads"].items()
                if n.startswith(("query_interact.", "memory_bank."))
                and not float(g.norm()) > 0.0]
        if idle:
            raise AssertionError(f"UniAD step ({side}): zero gradients "
                                 f"{idle}")
    # The selection also held card against CPU on random slots, that it
    # keeps and fills with false positives.
    from sndepth_tpu_torch.models import track_runtime as tr
    gen = torch.Generator().manual_seed(58)
    n = 901
    tracks = tr.empty_tracks(n, 8).replace(
        obj_idxes=torch.randint(-1, 40, (n,), generator=gen,
                                dtype=torch.int32),
        iou=torch.rand(n, generator=gen), scores=torch.rand(n, generator=gen))
    u = torch.rand(2, n, generator=gen)
    keep_cpu = tr.qim_select_train(tracks, *u)
    keep_card = tr.qim_select_train(tracks.to(DEV), *u.to(DEV))
    if not torch.equal(keep_card.cpu(), keep_cpu):
        raise AssertionError("QIM selection: card and CPU differ")
    dist = _step_distances(runs["card"], runs["cpu"])
    worst = dist["grads_rel_tensor_worst"][0][0]
    small = {"card_vs_cpu": dist, "loss": runs["cpu"]["loss"],
             "qim_selection_kept": int(keep_cpu.sum()),
             "matched": [int(d["matched"].sum())
                         for d in runs["cpu"]["decisions"]],
             "kept": [int(d["keep"].sum()) for d in runs["cpu"]["decisions"]]}
    del runs

    # The reference config with remat at the JAX package's trained shape.
    h, w = UNIAD_SMALL_HW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, clip, step = uniad_train_step(h, w, DEV, t_frames=UNIAD_TRAIN_T)
    step()
    torch.cuda.synchronize()
    reset_launches()
    metrics = step()
    torch.cuda.synchronize()
    launches = _used(read_launches())
    if launches != UNIAD_TRAIN_LAUNCHES:
        raise AssertionError(f"UniAD train step: launches {launches}, want "
                             f"{UNIAD_TRAIN_LAUNCHES}")
    if not all(_finite(float(v)) for v in metrics.values()):
        raise AssertionError(f"UniAD train step: {metrics}")
    step_ms = time_ms(step, 3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, prof = profiled_step(step, os.path.join(WORK_DIR, "trace"),
                            "uniad_train", DEV)
    ref = {"hw": [h, w], "bev": [200, 200], "t_frames": UNIAD_TRAIN_T,
           "remat": True, "ms_per_step": step_ms, "peak_gb": peak,
           "launches": launches, "steps_applied": state.step,
           "metrics": {k: float(v) for k, v in metrics.items()},
           "profile": {"kernel_ms": prof["kernel_ms"],
                       "launches": prof["launches"],
                       "wall_ms": prof["wall_ms"],
                       "idle_share": 1.0 - prof["kernel_ms"] / prof["wall_ms"],
                       "ms_by_group": prof["ms_by_group"]}}
    del state, clip, step
    torch.cuda.empty_cache()
    cli_state, records = train_uniad.main(
        ["--small", "--max_steps", "3", "--log_every", "1", "--device", DEV,
         "--ckpt_dir", os.path.join(WORK_DIR, "uniad_ckpt")])
    if cli_state.step != 3 or not os.path.exists(
            os.path.join(WORK_DIR, "uniad_ckpt", "uniad.pth")):
        raise AssertionError("train_uniad: no checkpoint after 3 steps")
    emit("uniad_train", nvidia_smi=smi, small_step=small,
         tolerances={"loss_rel": UNIAD_STEP_LOSS_TOL,
                     "grad_rel_tensor": UNIAD_STEP_GRAD_TOL,
                     "params_frac_off": UNIAD_STEP_FRAC_OFF},
         reference_step=ref, cli_losses=[r["loss_total"] for r in records])
    if not dist["loss_rel"] <= UNIAD_STEP_LOSS_TOL:
        raise AssertionError(f"UniAD step loss {dist['loss_rel']}")
    if not worst <= UNIAD_STEP_GRAD_TOL:
        raise AssertionError(f"UniAD step gradients: "
                             f"{dist['grads_rel_tensor_worst']}")
    if not (dist["params_over_lr"] <= 2.01
            and dist["params_frac_off"] <= UNIAD_STEP_FRAC_OFF):
        raise AssertionError(f"UniAD step weights: {dist}")
    return launches


# ---------------------------------------------------------------------------
# Scale-out and serving (data-parallel and FSDP GeoNet training, the
# data-parallel submission writer, exported artifacts)
# ---------------------------------------------------------------------------

DDP_BATCH = 2                   # the float32 steps' batch (phase_step's)
DDP_GLOBAL_BATCH = 4            # two gloo ranks on the card, 2 each
STAGE1_STEP_LAUNCHES = {"photo_pair": 4, "smooth": 4}
# Stage 2 of the two-rank check: PoseNet's pose head scaled up and the
# second shard's focal lengths doubled, so the flows span pixels and the
# consistency masks' means differ between the shards (a step normalising
# by its own shard's mean would take another loss). At 128x416 a scale of
# 100 leaves the masks mixed (means 0.54-0.92 on the CPU, the shards
# 0.14-0.29 apart); 1000 emptied them (0.00-0.09 on the H100).
DDP_POSE_SCALE = 100.0
DDP_FOCAL_SCALE = 2.0


def _dist_store(name: str) -> str:
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, name)
    if os.path.exists(path):
        os.remove(path)
    return path


def _geonet_batch(b: int, seed: int, focal_scale: float = 1.0) -> dict:
    """A numpy GeoNet batch at 128x416 from the synthetic stream; with
    ``focal_scale`` the second half's focal lengths scaled."""
    from sndepth_tpu_torch.data.synthetic import synthetic_batches
    batch = next(synthetic_batches(b, *SCALES[0], seed=seed))
    k = batch["intrinsics"].copy()
    k[b // 2:, 0, 0] *= focal_scale
    k[b // 2:, 1, 1] *= focal_scale
    batch["intrinsics"] = k
    return batch


def _full(p):
    return p.full_tensor() if hasattr(p, "full_tensor") else p


def _geonet_record(state, metrics: dict) -> dict:
    return {"parts": {k: float(v) for k, v in metrics.items()},
            "step": state.step, "notfinite_count": state.notfinite_count,
            "params": {f"{key}.{n}": _full(p).detach().cpu()
                       for key, net in state.nets().items()
                       for n, p in net.named_parameters()}}


def _step_gate(name: str, got: dict, want: dict, lr: float) -> dict:
    """Two GeoNet steps from the same weights on the same global batch:
    bit-equal, or within phase_step's gate (loss parts 1e-4 relative,
    parameters within 2 * lr, at most 1% of them more than 0.01 * lr
    apart). Says which held; raises when neither."""
    parts_rel = max(abs(v - want["parts"][k]) / max(abs(want["parts"][k]),
                                                     1e-30)
                    for k, v in got["parts"].items())
    n_off = n_all = 0
    max_param = 0.0
    bit_equal = parts_rel == 0.0
    for n, p in got["params"].items():
        d = (p - want["params"][n]).abs()
        bit_equal = bit_equal and bool((d == 0).all())
        max_param = max(max_param, float(d.max()))
        n_off += int((d > 0.01 * lr).sum())
        n_all += d.numel()
    out = {"bit_equal": bit_equal, "parts_rel_max": parts_rel,
           "param_max_abs": max_param, "param_frac_off": n_off / n_all,
           "held": "bit-equal" if bit_equal else "phase_step tolerance"}
    if not (bit_equal or (parts_rel <= 1e-4 and max_param <= 2 * lr
                          and n_off <= 0.01 * n_all)):
        raise AssertionError(f"{name}: steps disagree {out}")
    return out


def _step_ms(step, steps: int = 5) -> float:
    """Median ms of ``step()`` after two warm-up calls, synchronised."""
    import torch
    times = []
    for i in range(2 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times = sorted(times[2:])
    return times[len(times) // 2] * 1e3


def phase_ddp(smi: str) -> dict:
    """A world-size-1 NCCL group in this process: the float32 stage-1 and
    stage-2 steps at 128x416, B = 2, through DDP against the undistributed
    step on the card (an all-reduce over one rank is the identity: bit
    equality expected, with cuDNN's deterministic algorithms for the
    comparison, since its default weight-gradient algorithms sum in an
    order that changes from run to run), each kernel's launches a step as
    ``train`` and ``train_flow`` count them; then FSDP2 on the same group
    against the DDP step, with its bytes of state a rank; step times of
    the three at cuDNN's defaults."""
    import torch
    import torch.distributed as dist
    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.parallel import fsdp
    from sndepth_tpu_torch.parallel import mesh as pmesh
    from sndepth_tpu_torch.train import geonet
    dist.init_process_group(
        "nccl" if DEV == "cuda" else "gloo",
        init_method="file://" + _dist_store("ddp_store"), rank=0,
        world_size=1)
    deterministic = torch.backends.cudnn.deterministic
    try:
        mesh = pmesh.make_mesh(DEV)
        out, launches = {}, {}
        for stage, flow in (("stage1", False), ("stage2", True)):
            cfg = GeoNetConfig(batch_size=DDP_BATCH,
                               compute_dtype=torch.float32, train_flow=flow)
            batch = to_device(_geonet_batch(DDP_BATCH, 5), torch.device(DEV))
            torch.backends.cudnn.deterministic = True
            plain = geonet.create_train_state(cfg, DEV)
            want = _geonet_record(plain, geonet.train_step(plain, batch,
                                                           cfg))
            state = geonet.create_train_state(cfg, DEV)
            step = pmesh.make_parallel_train_step(cfg, mesh)
            shard = pmesh.shard_batch(batch, mesh)
            reset_launches()
            got = _geonet_record(state, step(state, shard))
            used = _used(read_launches())
            expect = FLOW_STEP_LAUNCHES if flow else STAGE1_STEP_LAUNCHES
            if used != expect:
                raise AssertionError(f"DDP {stage} launches {used}, want "
                                     f"{expect}")
            for k, v in used.items():
                launches[k] = launches.get(k, 0) + v
            fstate = fsdp.shard_state(geonet.create_train_state(cfg, DEV),
                                      mesh, cfg)
            fstep = fsdp.make_fsdp_train_step(cfg, mesh)
            fgot = _geonet_record(fstate, fstep(fstate, shard))
            torch.backends.cudnn.deterministic = deterministic
            out[stage] = {
                "ddp_vs_step": _step_gate(f"DDP {stage}", got, want,
                                          cfg.learning_rate),
                "fsdp_vs_ddp": _step_gate(f"FSDP {stage}", fgot, got,
                                          cfg.learning_rate),
                "launches": used, "loss_total": got["parts"]["loss_total"],
                "fsdp_param_bytes_per_device":
                    fsdp.sharded_param_bytes_per_device(fstate),
                "ms_step": _step_ms(lambda: geonet.train_step(plain, batch,
                                                              cfg)),
                "ms_ddp": _step_ms(lambda: step(state, shard)),
                "ms_fsdp": _step_ms(lambda: fstep(fstate, shard))}
            del plain, state, fstate
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    emit("ddp", nvidia_smi=smi, batch=DDP_BATCH, hw=list(SCALES[0]), **out)
    return launches


def _gloo_step_worker(rank, world, work):
    """A rank of the two-process check: its shard of the global batch
    through the DDP step on the card, over gloo, for both stages."""
    import torch
    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.parallel import mesh as pmesh
    from sndepth_tpu_torch.train import geonet
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    # The mesh only names the group: the tensors are on the card, and
    # gloo carries CUDA tensors.
    mesh = pmesh.make_mesh("cpu")
    out = {}
    for stage, flow in (("stage1", False), ("stage2", True)):
        cfg = GeoNetConfig(batch_size=DDP_GLOBAL_BATCH,
                           compute_dtype=torch.float32, train_flow=flow)
        state = geonet.create_train_state(cfg, DEV)
        for key, net in state.nets().items():
            net.load_state_dict(inputs[stage]["weights"][key])
        batch = to_device(inputs[stage]["batch"], torch.device(DEV))
        step = pmesh.make_parallel_train_step(cfg, mesh)
        reset_launches()
        out[stage] = _geonet_record(state, step(
            state, pmesh.shard_batch(batch, mesh)))
        out[stage]["launches"] = _used(read_launches())
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def _shard_mask_means(state, batch, cfg) -> list:
    """Each stage-2 consistency mask's mean on each half of ``batch``."""
    import torch
    from sndepth_tpu_torch.train import geonet
    means = []

    def record(mask):
        means.append(mask.reshape(2, -1).mean(1).tolist())
        return mask.mean()
    with torch.no_grad():
        geonet.geonet_loss(state.disp_net, state.pose_net,
                           geonet.preprocess_batch(batch), cfg,
                           state.flow_net, record)
    return means


def phase_ddp_gloo2(smi: str) -> dict:
    """Two processes on the one card over gloo (NCCL refuses two ranks on
    one GPU), each stepping on half of a global batch of 4 at 128x416 in
    float32, held against the one-process step on the whole batch on the
    card, stage 1 and stage 2 (shards whose masks differ)."""
    import torch
    from sndepth_tpu_torch.core.config import GeoNetConfig
    from sndepth_tpu_torch.data.prefetch import to_device
    from sndepth_tpu_torch.parallel.multihost import run_local_group
    from sndepth_tpu_torch.train import geonet
    work = os.path.join(WORK_DIR, "ddp_gloo2")
    os.makedirs(work, exist_ok=True)
    inputs, single, masks = {}, {}, None
    for stage, flow in (("stage1", False), ("stage2", True)):
        cfg = GeoNetConfig(batch_size=DDP_GLOBAL_BATCH,
                           compute_dtype=torch.float32, train_flow=flow)
        state = geonet.create_train_state(cfg, "cpu")
        if flow:
            with torch.no_grad():
                state.pose_net.pred_poses.weight.mul_(DDP_POSE_SCALE)
        batch = _geonet_batch(DDP_GLOBAL_BATCH, 6,
                              DDP_FOCAL_SCALE if flow else 1.0)
        inputs[stage] = {"batch": batch, "weights": {
            k: net.state_dict() for k, net in state.nets().items()}}
        dev_state = geonet.create_train_state(cfg, DEV)
        for key, net in dev_state.nets().items():
            net.load_state_dict(inputs[stage]["weights"][key])
        dev_batch = to_device(batch, torch.device(DEV))
        if flow:
            masks = _shard_mask_means(dev_state, dev_batch, cfg)
        single[stage] = _geonet_record(
            dev_state, geonet.train_step(dev_state, dev_batch, cfg))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    t0 = time.perf_counter()
    run_local_group(_gloo_step_worker, 2, os.path.join(work, "store"), work,
                    timeout_s=600.0, threads=4)
    group_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=True) for r in range(2)]
    out = {}
    for stage in ("stage1", "stage2"):
        r0, r1 = ranks[0][stage], ranks[1][stage]
        if r0["parts"] != r1["parts"] or any(
                not torch.equal(p, r1["params"][n])
                for n, p in r0["params"].items()):
            raise AssertionError(f"gloo {stage}: the ranks part")
        expect = FLOW_STEP_LAUNCHES if stage == "stage2" else \
            STAGE1_STEP_LAUNCHES
        if r0["launches"] != expect:
            raise AssertionError(f"gloo {stage} launches {r0['launches']}")
        out[stage] = {"vs_one_process": _step_gate(
            f"gloo {stage}", r0, single[stage], 2e-4),
            "loss_total": r0["parts"]["loss_total"],
            "launches_per_rank": r0["launches"]}
    spread = max(abs(a - b) for a, b in masks)
    if not spread > 0.05:
        raise AssertionError(f"stage-2 shards' mask means too close: {masks}")
    emit("ddp_gloo2", nvidia_smi=smi, global_batch=DDP_GLOBAL_BATCH,
         hw=list(SCALES[0]), shard_mask_means=masks,
         shard_mask_mean_spread=spread, group_s=group_s, **out)
    return out


def _torchrun(module: str, args: list, timeout: int = 600) -> str:
    """``torchrun --standalone --nproc_per_node 1 -m <module> <args>`` from
    the repo root; returns its output, raises on a failure."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", module] + args, cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {module} failed:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    return proc.stdout


def phase_train_ddp(smi: str) -> dict:
    """``cli/train_geonet`` under torchrun (one process: the one-process
    step, through the CLI as a data-parallel run starts it): 7 bf16
    stage-1 steps with a checkpoint every step, then a resumed run to 9.
    Finite, descending loss; the last 5 step files kept; frames/sec (of
    runs that write a 0.4 GB checkpoint every step: not a throughput)."""
    import json as json_
    import re
    import shutil
    root = os.path.join(WORK_DIR, "train_ddp")
    shutil.rmtree(root, ignore_errors=True)
    ck, logs = os.path.join(root, "ck"), os.path.join(root, "logs")
    args = ["--log_every", "1", "--output_ckpt_iter", "1", "--ckpt_dir", ck,
            "--graphs_dir", logs, "--device", DEV]
    first = _torchrun("sndepth_tpu_torch.cli.train_geonet",
                      args + ["--max_steps", "7"])
    kept = sorted(os.listdir(ck))
    if kept != [f"step_{s:08d}.pt" for s in range(3, 8)]:
        raise AssertionError(f"checkpoints kept: {kept}")
    second = _torchrun("sndepth_tpu_torch.cli.train_geonet",
                       args + ["--max_steps", "9", "--resume"])
    if "resumed from" not in second or "step_00000007.pt" not in second:
        raise AssertionError("the resumed run did not start from step 7")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        records = [json_.loads(line) for line in f]
    steps = [r["step"] for r in records]
    losses = [r["loss_total"] for r in records]
    if steps != list(range(1, 10)) or not all(map(_finite, losses)):
        raise AssertionError(f"steps {steps}, losses {losses}")
    if not sum(losses[-3:]) < sum(losses[:3]):
        raise AssertionError(f"loss did not descend: {losses}")
    fps = [float(m) for m in re.findall(r"\(([0-9.]+) frames/sec\)",
                                        first + second)]
    if len(fps) != 2:
        raise AssertionError("frames/sec not printed")
    emit("train_ddp", nvidia_smi=smi, losses=losses, frames_per_sec=fps,
         checkpoints_kept_after_7=kept,
         checkpoints_kept_after_resume=sorted(os.listdir(ck)))
    return {"losses": losses}


EXPORT_HW = SCALES[0]
# An exported program runs the eager model's operators: bit-equal expected.
# Otherwise held by norm: 1e-3 relative for the bf16 nets, 1e-5 for RAFT3D
# in float32.
EXPORT_TOL = {"dispnet": 1e-3, "nnet": 1e-3, "raft3d": 1e-5}

_EXPORT_CHECK = r"""
import json, sys, time
import torch
torch.backends.cudnn.allow_tf32 = {cudnn_tf32}
torch.backends.cuda.matmul.allow_tf32 = {matmul_tf32}
torch.backends.cudnn.benchmark = False
from sndepth_tpu_torch.serving.export import load_artifact
from sndepth_tpu_torch.utils import tracing
sync = (torch.cuda.synchronize if torch.cuda.is_available()
        else (lambda: None))
out = {{}}
for model, art in {arts!r}:
    t0 = time.perf_counter()
    fn, meta = load_artifact(art)
    load_s = time.perf_counter() - t0
    ref = torch.load(art + "/check.pt", weights_only=True)
    inputs = [x.to({dev!r}) for x in ref["inputs"]]
    before = tracing.counts()
    got = fn(*inputs)
    sync()
    after = tracing.counts()
    launches = {{"warp_gather": after["K5"] - before["K5"],
                 "gn_build": after["K8"] - before["K8"]}}
    want = ref["eager"].to({dev!r})
    rel = float((got.float() - want.float()).norm()
                / want.float().norm().clamp_min(1e-30))
    times = []
    for _ in range(5):
        sync(); t0 = time.perf_counter()
        fn(*inputs)
        sync(); times.append(time.perf_counter() - t0)
    try:
        fn(*[torch.zeros(2, *x.shape[1:], device={dev!r}) for x in inputs])
        rejects = False
    except ValueError:
        rejects = True
    out[model] = {{"bit_equal": bool(torch.equal(got, want)), "rel": rel,
                   "finite": bool(torch.isfinite(got).all()),
                   "launches": launches, "load_s": load_s,
                   "ms": sorted(times)[2] * 1e3, "rejects_wrong_shape": rejects,
                   "device": meta["device"]}}
print("EXPORT_CHECK " + json.dumps(out))
"""


def phase_export(smi: str) -> dict:
    """``cli/export_model`` on the card for ``dispnet``, ``nnet`` and
    ``raft3d`` (128x416, B = 1, RAFT3D with 16 iterations), each artifact
    loaded and run in a fresh process against the eager model's output on
    the same inputs; the loaded RAFT3D program launches K8 and K5 16 times
    a frame (the custom operators' CUDA kernels)."""
    import torch
    from sndepth_tpu_torch.cli import export_model
    h, w = EXPORT_HW
    arts, record = [], {}
    for model in ("dispnet", "nnet", "raft3d"):
        art = os.path.join(WORK_DIR, "export", model)
        t0 = time.perf_counter()
        export_model.main(["--model", model, "--device", DEV, "--out_dir",
                           art, "--img_height", str(h), "--img_width",
                           str(w), "--iters", str(RAFT_ITERS)])
        export_s = time.perf_counter() - t0
        module, inputs = export_model.build(model, 1, h, w, RAFT_ITERS)
        module = module.to(DEV).eval()
        inputs = [x.to(DEV) for x in inputs]
        reset_launches()
        with torch.no_grad():
            eager = module(*inputs)
        eager_launches = _used(read_launches())
        torch.save({"inputs": [x.cpu() for x in inputs],
                    "eager": eager.cpu()}, os.path.join(art, "check.pt"))
        arts.append((model, art))
        record[model] = {"export_s": export_s,
                         "eager_launches": eager_launches,
                         "artifact_mb": os.path.getsize(os.path.join(
                             art, "model.pt2")) / 2**20}
        del module, eager
    code = _EXPORT_CHECK.format(
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32, arts=arts,
        dev=DEV)
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("EXPORT_CHECK ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"artifact check failed:\n{proc.stderr[-3000:]}")
    loaded = json.loads(line[0][len("EXPORT_CHECK "):])
    for model, r in loaded.items():
        record[model].update(r)
        if not (r["finite"] and r["rejects_wrong_shape"]
                and (r["bit_equal"] or r["rel"] <= EXPORT_TOL[model])):
            raise AssertionError(f"{model} artifact: {r}")
    if _used(record["raft3d"]["launches"]) != RAFT_FRAME_LAUNCHES:
        raise AssertionError(f"RAFT3D artifact launches "
                             f"{record['raft3d']['launches']}")
    emit("export", nvidia_smi=smi, hw=list(EXPORT_HW), **record)
    return record["raft3d"]["launches"]


def _kitti_worker(rank, world, root, args):
    from sndepth_tpu_torch.cli import kitti_submission
    kitti_submission.main(args + ["--data_parallel", "--out_dir",
                                  os.path.join(root, "gloo2")])


def _tree_files(d: str) -> list:
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _same_submission(name: str, got: str, want: str) -> dict:
    """The same files; each byte for byte, or else (the dumps' numbers)
    within 1e-5 and (the flow pngs) within one unit."""
    import numpy as np
    from PIL import Image
    files = _tree_files(want)
    if _tree_files(got) != files:
        raise AssertionError(f"{name}: files {_tree_files(got)} != {files}")
    same = 0
    worst = 0.0
    for f in files:
        a, b = os.path.join(got, f), os.path.join(want, f)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() == fb.read():
                same += 1
                continue
        if f.endswith(".txt"):
            d = float(np.abs(np.loadtxt(a) - np.loadtxt(b)).max())
            ok = d <= 1e-5
        else:
            d = float(np.abs(np.asarray(Image.open(a), np.int64)
                             - np.asarray(Image.open(b), np.int64)).max())
            ok = d <= 1
        worst = max(worst, d)
        if not ok:
            raise AssertionError(f"{name}: {f} differs by {d}")
    return {"files": len(files), "byte_equal": same, "worst_other": worst}


def phase_kitti_dp(smi: str) -> dict:
    """``cli/kitti_submission --data_parallel`` on 3 frames at 128x416 (16
    iterations): under torchrun in one process, and in two processes on
    the card over gloo (frames 0 and 2, and 1), against the writer without
    the flag. Every process here runs at torch's default TF32 settings, the
    reference too."""
    import shutil
    import torch
    from sndepth_tpu_torch.cli import kitti_submission
    from sndepth_tpu_torch.parallel.multihost import run_local_group
    root = os.path.join(WORK_DIR, "kitti_dp")
    shutil.rmtree(root, ignore_errors=True)
    _write_kitti_testing_tree(root, 4, 9)
    args = ["--root", root, "--iters", str(RAFT_ITERS), "--max_frames", "3",
            "--device", DEV]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kitti_submission.main(args + ["--out_dir", os.path.join(root, "one")])
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    t0 = time.perf_counter()
    _torchrun("sndepth_tpu_torch.cli.kitti_submission",
              args + ["--data_parallel", "--out_dir",
                      os.path.join(root, "torchrun1")])
    torchrun_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_local_group(_kitti_worker, 2, os.path.join(root, "store"), root, args,
                    timeout_s=600.0, threads=4)
    gloo_s = time.perf_counter() - t0
    one = os.path.join(root, "one")
    out = {"torchrun1": _same_submission(
        "torchrun", os.path.join(root, "torchrun1"), one),
        "gloo2": _same_submission("gloo2", os.path.join(root, "gloo2"), one),
        "torchrun_s": torchrun_s, "gloo2_s": gloo_s}
    emit("kitti_dp", nvidia_smi=smi, **out)
    return out


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
    phase_motion(smi)
    phase_motion_train(smi)
    phase_nnet_train(smi)
    phase_predict(smi)
    raft2d_errs, lookup_times = phase_raft2d(smi)
    errs["warp_gather"] = max(errs["warp_gather"], raft2d_errs["warp_gather"])
    raft2d_launches = phase_predict_raft2d(smi)["raft2d_large"]
    phase_demo(smi)
    phase_vae(smi)
    uniad_launches = phase_uniad(smi)
    uniad_k = phase_uniad_kernels(smi)
    for name, err in uniad_k["errs"].items():
        errs[name] = max(errs[name], err)
    uniad_cli_launches = phase_predict_vae_uniad(smi)
    uniad_train_launches = phase_uniad_train(smi)
    ddp_launches = phase_ddp(smi)
    phase_ddp_gloo2(smi)
    phase_train_ddp(smi)
    export_launches = phase_export(smi)
    phase_kitti_dp(smi)

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
        if k["name"] == "warp_gather":
            # RAFT2DLarge's lookup in the fused prediction's two frames,
            # and its four level calls at both frame sizes, timed.
            k["raft2d_launches"] = raft2d_launches["warp_gather"]
            k["raft2d_lookup"] = lookup_times
        if k["name"] == "gn_build":
            k["err_over_tolerance"] = errs["gn_build_err_over_tol"]
        if k["name"] == "gn_build_bwd":
            k["err_over_tolerance"] = errs["gn_build_bwd_err_over_tol"]
    # K5, K5b and K6 on the UniAD paths: K5's launches in a reference frame
    # and in the pipeline CLI's two frames, each kernel's launches in a
    # reference train step, and their times at the UniAD instantiations.
    for k in kernels:
        if k["name"] in uniad_k["times"]:
            k["uniad_launches"] = uniad_launches.get(k["name"], 0)
            k["predict_vae_uniad_launches"] = uniad_cli_launches.get(
                k["name"], 0)
            k["uniad_train_launches"] = uniad_train_launches[k["name"]]
            k["uniad_times"] = uniad_k["times"][k["name"]]
    # The scale-out and serving paths: each kernel's launches in one DDP
    # step of stage 1 and one of stage 2 (world size 1), and K5's and K8's
    # in a frame of the exported RAFT3D program.
    for k in kernels:
        k["ddp_launches"] = ddp_launches.get(k["name"], 0)
        if k["name"] in export_launches:
            k["export_raft3d_launches"] = export_launches[k["name"]]
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
