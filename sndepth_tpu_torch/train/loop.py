"""Training loop: data -> device -> step -> logging -> checkpoints.

Counterpart of ``sndepth_tpu/train/loop.py``. Under torchrun with more
than one process, :func:`train_geonet` runs the data-parallel step
(``parallel/mesh.py``): each rank is fed its part of every global batch,
rank 0 logs and writes the checkpoints. A GeoNet checkpoint
(``train/checkpoint.py``, ``step_%08d.pt``, the last 5 kept) is one
``torch.save`` of the state dicts of the nets (DispNetS, PoseNet and, in
stage 2, FlowNet) and of the optimizer, and the counters, written off the
train loop by a background thread. A RAFT3D, motion,
NNET or UniAD checkpoint is two files in its directory: the model's state
dict (``raft3d.pth``, ``motion.pth``, ``nnet.pth``, ``uniad.pth``), as the
serving and evaluation CLIs' ``--ckpt_dir`` load it, and the optimizer's
moments with the counters (``*_train_state.pt``).
"""

from __future__ import annotations

import os
import time
from typing import Iterator

import torch

from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.data.prefetch import device_prefetch
from sndepth_tpu_torch.parallel import multihost
from sndepth_tpu_torch.train import checkpoint as ckpt_lib
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
    """Write ``state`` as its step's file of ``ckpt_dir`` and keep the last
    5; returns the path."""
    return ckpt_lib.save_checkpoint(ckpt_dir, state, state.step)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    step = ckpt_lib.latest_step(ckpt_dir)
    return None if step is None else ckpt_lib.checkpoint_path(ckpt_dir, step)


def restore_checkpoint(state: geonet.TrainState, path: str) -> None:
    """Load the file at ``path``: a full train state, or the nets alone
    (``cli/convert_weights geonet``), grafted onto ``state``."""
    step = int(os.path.basename(path)[len("step_"):-len(".pt")])
    ckpt_lib.restore_params_or_state(os.path.dirname(path), state, step)


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
    ``<log_dir>/trace``. The checkpoint directory keeps the last 5 steps.

    In a process group of more than one rank (torchrun, or
    :func:`~sndepth_tpu_torch.parallel.multihost.initialize_multihost`),
    ``batches`` yields this rank's part of each global batch
    (``config.batch_size``; the loader's ``part``, or
    :func:`~sndepth_tpu_torch.parallel.multihost.make_global_batch` of a
    global batch), and each rank steps on it
    (:func:`~sndepth_tpu_torch.parallel.mesh.make_parallel_train_step`):
    the global batch is the one-process run's. Every rank resumes from the
    checkpoint and keeps the (identical) records; rank 0 alone prints and
    writes the logs and the checkpoints. At world size 1 the step is the
    one-process step."""
    device = multihost.local_device(device)
    world = multihost.world_size()
    state = geonet.create_train_state(config, device)
    if resume and ckpt_dir is not None:
        step = ckpt_lib.latest_step(ckpt_dir)
        if step is not None:
            ckpt_lib.restore_checkpoint(ckpt_dir, state, step)
            if multihost.rank() == 0:
                print("resumed from "
                      f"{ckpt_lib.checkpoint_path(ckpt_dir, step)}")
    start_step = state.step

    if world > 1:
        from sndepth_tpu_torch.parallel import mesh as pmesh
        mesh = pmesh.make_mesh(device)
        pmesh.replicate_state(state, mesh)
        parallel_step = pmesh.make_parallel_train_step(config, mesh)

        def step_fn(batch):
            return parallel_step(state, batch)
    else:
        def step_fn(batch):
            return geonet.train_step(state, batch, config)
    batches = device_prefetch(batches, device)
    lead = multihost.rank() == 0
    logger = MetricLogger(log_dir if lead else None, echo=lead)
    writer = (ckpt_lib.AsyncCheckpointWriter(ckpt_dir)
              if ckpt_dir is not None and lead else None)
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
                lambda: step_fn(batch),
                os.path.join(log_dir or "logs", "trace"), f"step_{step}",
                device)
        else:
            metrics = step_fn(batch)
        if step % log_every == 0 or step == max_steps:
            logger.log(step, metrics)
        if ckpt_dir is not None and (step % ckpt_every == 0
                                     or step == max_steps):
            # The device-to-host copy here, the disk write on the writer's
            # thread while the next steps run; the next save (or the close
            # below) joins it.
            multihost.sync_hosts("pre-checkpoint")
            if writer is not None:
                print(f"checkpoint (async) -> {writer.save(state, step)}")
            multihost.sync_hosts("post-checkpoint")
    if writer is not None:
        writer.close()
    multihost.sync_hosts("checkpoints-written")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    done = max(state.step - start_step, 1)
    # Frames of the global batch: every rank's slices together.
    fps = done * config.batch_size * config.sequence_length / dt
    if lead:
        print(f"trained {done} steps in {dt:.1f}s ({fps:.0f} frames/sec)",
              flush=True)
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
