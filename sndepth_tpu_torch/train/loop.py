"""Training loop: data -> device -> step -> logging -> checkpoints.

Counterpart of ``sndepth_tpu/train/loop.py`` on one device, without its
mesh, multi-host and trace branches. A GeoNet checkpoint is one
``torch.save`` of the state dicts of the nets (DispNetS, PoseNet and, in
stage 2, FlowNet) and of the optimizer, and the counters. A RAFT3D, motion,
NNET or UniAD checkpoint is two files in its directory: the model's state
dict (``raft3d.pth``, ``motion.pth``, ``nnet.pth``, ``uniad.pth``), as the
serving and evaluation CLIs' ``--ckpt_dir`` load it, and the optimizer's
moments with the counters (``*_train_state.pt``).
"""

from __future__ import annotations

import glob
import os
import re
import time
from typing import Iterator

import torch

from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.prefetch import device_prefetch
from sndepth_tpu_torch.train import geonet, raft3d
from sndepth_tpu_torch.utils.logging import MetricLogger

RAFT3D_MODEL_FILE = "raft3d.pth"
RAFT3D_STATE_FILE = "raft3d_train_state.pt"
MOTION_MODEL_FILE = "motion.pth"
MOTION_STATE_FILE = "motion_train_state.pt"
NNET_MODEL_FILE = "nnet.pth"
NNET_STATE_FILE = "nnet_train_state.pt"
UNIAD_MODEL_FILE = "uniad.pth"
UNIAD_STATE_FILE = "uniad_train_state.pt"


def _save(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def save_checkpoint(state: geonet.TrainState, ckpt_dir: str) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.pt")
    _save({"step": state.step, "notfinite_count": state.notfinite_count,
           **{k: net.state_dict() for k, net in state.nets().items()},
           "optimizer": state.optimizer.state_dict()}, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    paths = glob.glob(os.path.join(ckpt_dir, "step_*.pt"))
    if not paths:
        return None
    return max(paths, key=lambda p: int(re.findall(r"\d+", p)[-1]))


def restore_checkpoint(state: geonet.TrainState, path: str) -> None:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key, net in state.nets().items():
        if key not in ckpt:
            raise KeyError(f"{path} holds no {key}: it was saved by a run "
                           "without that net")
        net.load_state_dict(ckpt[key])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.notfinite_count = int(ckpt["notfinite_count"])


def profiled_step(step, trace_dir: str, label: str, device):
    """Run ``step()`` under ``torch.profiler`` (the card's kernels too on a
    CUDA device), write the Chrome trace to ``trace_dir/<label>.json`` and
    print the device time by kernel group as ``cli/profile_step.py`` counts
    it; returns what ``step()`` returned and that summary."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from sndepth_tpu_torch.utils.profiling import device_kernels
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = step()
        if cuda:
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{label}.json")
    prof.export_chrome_trace(path)
    by_group, _, launches = device_kernels(prof)
    summary = {"trace": path, "wall_ms": wall_ms,
               "kernel_ms": sum(by_group.values()), "launches": launches,
               "ms_by_group": dict(sorted(by_group.items(),
                                          key=lambda kv: -kv[1]))}
    print(json.dumps(summary), flush=True)
    return out, summary


def train_geonet(config: GeoNetConfig, batches: Iterator[dict],
                 max_steps: int, *, device, ckpt_dir: str | None = None,
                 log_dir: str | None = None, log_every: int = 100,
                 ckpt_every: int = 5000, resume: bool = False,
                 profile_at: int | None = None
                 ) -> tuple[geonet.TrainState, list[dict]]:
    """Run train steps up to ``max_steps`` over numpy ``batches`` on
    ``device``; returns the final state and the logged metric records.
    ``profile_at`` traces that step (:func:`profiled_step`) into
    ``<log_dir>/trace``."""
    device = torch.device(device)
    state = geonet.create_train_state(config, device)
    if resume and ckpt_dir is not None:
        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            restore_checkpoint(state, path)
            print(f"resumed from {path}")
    start_step = state.step

    logger = MetricLogger(log_dir)
    batches = device_prefetch(batches, device)
    t0 = time.perf_counter()
    for i in range(start_step, max_steps):
        try:
            batch = next(batches)
        except StopIteration:
            print("data stream exhausted")
            break
        step = i + 1
        if step == profile_at:
            metrics, _ = profiled_step(
                lambda: geonet.train_step(state, batch, config),
                os.path.join(log_dir or "logs", "trace"), f"step_{step}",
                device)
        else:
            metrics = geonet.train_step(state, batch, config)
        if step % log_every == 0 or step == max_steps:
            logger.log(step, metrics)
        if ckpt_dir is not None and (step % ckpt_every == 0
                                     or step == max_steps):
            print(f"checkpoint -> {save_checkpoint(state, ckpt_dir)}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    done = max(state.step - start_step, 1)
    fps = done * config.batch_size * config.sequence_length / dt
    print(f"trained {done} steps in {dt:.1f}s ({fps:.0f} frames/sec)")
    logger.close()
    return state, logger.records


def _save_split(model: torch.nn.Module, rest: dict, ckpt_dir: str,
                model_file: str, state_file: str) -> str:
    """Write ``model``'s state dict and ``rest`` (the optimizer's and the
    counters) as two files of ``ckpt_dir``; returns the model's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, model_file)
    _save(model.state_dict(), path)
    _save(rest, os.path.join(ckpt_dir, state_file))
    return path


def _restore_split(model: torch.nn.Module, optimizer, ckpt_dir: str,
                   model_file: str, state_file: str) -> dict:
    """Load what :func:`_save_split` wrote into ``model`` and ``optimizer``;
    returns the counters' dict."""
    model.load_state_dict(torch.load(os.path.join(ckpt_dir, model_file),
                                     map_location="cpu", weights_only=True))
    rest = torch.load(os.path.join(ckpt_dir, state_file),
                      map_location="cpu", weights_only=True)
    optimizer.load_state_dict(rest["optimizer"])
    return rest


def save_raft3d_checkpoint(state: raft3d.RAFT3DTrainState,
                           ckpt_dir: str) -> str:
    """Write the model and the rest of the train state; returns the
    model's path."""
    return _save_split(
        state.model, {"step": state.step,
                      "notfinite_count": state.notfinite_count,
                      "calls": state.calls,
                      "optimizer": state.optimizer.state_dict()},
        ckpt_dir, RAFT3D_MODEL_FILE, RAFT3D_STATE_FILE)


def restore_raft3d_checkpoint(state: raft3d.RAFT3DTrainState,
                              ckpt_dir: str) -> None:
    """Load what :func:`save_raft3d_checkpoint` wrote into ``state``."""
    rest = _restore_split(state.model, state.optimizer, ckpt_dir,
                          RAFT3D_MODEL_FILE, RAFT3D_STATE_FILE)
    state.step = int(rest["step"])
    state.notfinite_count = int(rest["notfinite_count"])
    state.calls = int(rest.get("calls", state.step))


def save_motion_checkpoint(state, ckpt_dir: str) -> str:
    """Write a :class:`~sndepth_tpu_torch.train.motion.MotionTrainState`:
    ``motion.pth`` (the model, in the reference's key names) and its
    optimizer and step; returns the model's path."""
    return _save_split(
        state.model, {"step": state.step,
                      "optimizer": state.optimizer.state_dict()},
        ckpt_dir, MOTION_MODEL_FILE, MOTION_STATE_FILE)


def restore_motion_checkpoint(state, ckpt_dir: str) -> None:
    """Load what :func:`save_motion_checkpoint` wrote into ``state``."""
    rest = _restore_split(state.model, state.optimizer, ckpt_dir,
                          MOTION_MODEL_FILE, MOTION_STATE_FILE)
    state.step = int(rest["step"])


def load_motion_weights(path: str) -> dict:
    """A MotionFusionNet state dict in the reference's key names: the
    ``motion.pth`` of ``path`` where it is a directory (what
    :func:`save_motion_checkpoint` writes), else the file at ``path`` (such
    as the reference's ``best.pt`` saved as a state dict), DataParallel's
    ``module.`` prefixes dropped as ``convert_motionfusion`` drops them."""
    if os.path.isdir(path):
        path = os.path.join(path, MOTION_MODEL_FILE)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items()}


def save_nnet_checkpoint(state, ckpt_dir: str) -> str:
    """Write a :class:`~sndepth_tpu_torch.train.nnet.NNETTrainState`:
    ``nnet.pth`` (the encoder's and decoder's weights, which
    ``cli/evaluate_normals.py --ckpt_dir`` reads) and the optimizer, step
    and sampler state; returns the model's path."""
    return _save_split(state.model, {
        "step": state.step, "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state()},
        ckpt_dir, NNET_MODEL_FILE, NNET_STATE_FILE)


def restore_nnet_checkpoint(state, ckpt_dir: str) -> None:
    """Load what :func:`save_nnet_checkpoint` wrote into ``state``."""
    rest = _restore_split(state.model, state.optimizer, ckpt_dir,
                          NNET_MODEL_FILE, NNET_STATE_FILE)
    state.step = int(rest["step"])
    state.generator.set_state(rest["generator"])


def save_uniad_checkpoint(state, ckpt_dir: str) -> str:
    """Write a :class:`~sndepth_tpu_torch.train.uniad.UniADTrainState`:
    ``uniad.pth`` (the model in the reference's key names) and the
    optimizer, counters and QIM generator; returns the model's path."""
    return _save_split(state.model, {
        "step": state.step, "calls": state.calls,
        "notfinite_count": state.notfinite_count,
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state()},
        ckpt_dir, UNIAD_MODEL_FILE, UNIAD_STATE_FILE)


def restore_uniad_checkpoint(state, ckpt_dir: str) -> None:
    """Load what :func:`save_uniad_checkpoint` wrote into ``state``."""
    rest = _restore_split(state.model, state.optimizer, ckpt_dir,
                          UNIAD_MODEL_FILE, UNIAD_STATE_FILE)
    state.step, state.calls = int(rest["step"]), int(rest["calls"])
    state.notfinite_count = int(rest["notfinite_count"])
    state.generator.set_state(rest["generator"])


def run_steps(step, batches: Iterator[dict], max_steps: int, *, device,
              log_every: int) -> list[dict]:
    """``step(batch)`` on ``max_steps`` numpy ``batches`` moved to
    ``device``, printing ``step i/n`` and the metrics, detached scalars, of
    every ``log_every``-th step and the last; returns those records with
    their ``step``."""
    device = torch.device(device)
    records = []
    t0 = time.perf_counter()
    batches = device_prefetch(batches, device)
    for i in range(1, max_steps + 1):
        metrics = step(next(batches))
        if i % log_every == 0 or i == max_steps:
            record = {"step": i, **{k: float(v) for k, v in metrics.items()}}
            records.append(record)
            print(f"step {i}/{max_steps} " + " ".join(
                f"{k}={v:.4f}" for k, v in record.items() if k != "step"),
                flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"trained {max_steps} steps in {dt:.1f}s "
          f"({dt / max(max_steps, 1) * 1e3:.0f} ms/step)", flush=True)
    return records


def train_raft3d(batches: Iterator[dict], max_steps: int, *, device,
                 model: raft3d.RAFT3D | None = None, iters: int = 12,
                 ckpt_dir: str | None = None, log_every: int = 10
                 ) -> tuple[raft3d.RAFT3DTrainState, list[dict]]:
    """Run ``max_steps`` RAFT3D train steps over numpy ``batches`` on
    ``device`` and write the checkpoint at the end; returns the final state
    and the logged metric records."""
    device = torch.device(device)
    state = raft3d.create_train_state(model, device)
    logger = MetricLogger()
    batches = device_prefetch(batches, device)
    t0 = time.perf_counter()
    for step in range(1, max_steps + 1):
        try:
            batch = next(batches)
        except StopIteration:
            print("data stream exhausted")
            break
        metrics = raft3d.train_step(state, batch, iters)
        if step % log_every == 0 or step == max_steps:
            logger.log(step, metrics)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"trained {state.calls} steps ({state.step} applied) in "
          f"{dt:.1f}s ({dt / max(state.calls, 1) * 1e3:.0f} ms/step)")
    if ckpt_dir is not None:
        print(f"checkpoint -> {save_raft3d_checkpoint(state, ckpt_dir)}")
    return state, logger.records
