"""Training loop: data -> device -> step -> logging -> checkpoints.

Counterpart of ``sndepth_tpu/train/loop.py`` on one device, without its
mesh, multi-host and trace branches. A checkpoint is one ``torch.save`` of
the model and optimizer state dicts and the counters.
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
from sndepth_tpu_torch.train import geonet
from sndepth_tpu_torch.utils.logging import MetricLogger


def save_checkpoint(state: geonet.TrainState, ckpt_dir: str) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.pt")
    torch.save({"step": state.step,
                "notfinite_count": state.notfinite_count,
                "disp_net": state.disp_net.state_dict(),
                "pose_net": state.pose_net.state_dict(),
                "optimizer": state.optimizer.state_dict()}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    paths = glob.glob(os.path.join(ckpt_dir, "step_*.pt"))
    if not paths:
        return None
    return max(paths, key=lambda p: int(re.findall(r"\d+", p)[-1]))


def restore_checkpoint(state: geonet.TrainState, path: str) -> None:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.disp_net.load_state_dict(ckpt["disp_net"])
    state.pose_net.load_state_dict(ckpt["pose_net"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.notfinite_count = int(ckpt["notfinite_count"])


def train_geonet(config: GeoNetConfig, batches: Iterator[dict],
                 max_steps: int, *, device, ckpt_dir: str | None = None,
                 log_dir: str | None = None, log_every: int = 100,
                 ckpt_every: int = 5000, resume: bool = False
                 ) -> tuple[geonet.TrainState, list[dict]]:
    """Run train steps up to ``max_steps`` over numpy ``batches`` on
    ``device``; returns the final state and the logged metric records."""
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
        metrics = geonet.train_step(state, batch, config)
        step = i + 1
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
