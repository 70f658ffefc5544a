"""Pipeline parallelism (GPipe) over the ranks of a group.

Counterpart of ``sndepth_tpu/parallel/pipeline.py`` for the denoiser's
uniform encoder layers: L layers are split into S contiguous stages, one a
rank, and ``n_micro`` microbatches stream through them under
``torch.distributed.pipelining``'s ``ScheduleGPipe`` (each stage's
activations sent to the next rank); stage s is busy on ticks
[s, s + n_micro), a bubble of (S - 1) / (n_micro + S - 1). The last stage
holds the output and broadcasts it, so every rank returns it, as the JAX
version's ``psum`` does.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn as nn


def stack_layer_params(layers, n_stages: int) -> dict:
    """The layers' parameters stacked stage-major: each entry of their
    state dict as (S, L/S, ...)."""
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers not divisible into "
                         f"{n_stages} stages")
    per = len(layers) // n_stages
    states = [layer.state_dict() for layer in layers]
    return {k: torch.stack([s[k] for s in states]).reshape(
        n_stages, per, *states[0][k].shape) for k in states[0]}


def _stage_module(template: nn.Module, stacked: dict, stage: int
                  ) -> nn.Sequential:
    per = next(iter(stacked.values())).shape[1]
    layers = []
    for j in range(per):
        layer = copy.deepcopy(template)
        layer.load_state_dict({k: v[stage, j] for k, v in stacked.items()})
        layers.append(layer)
    return nn.Sequential(*layers)


def pipeline_apply(template: nn.Module, stacked: dict, x: torch.Tensor,
                   n_micro: int, group=None, device="cpu") -> torch.Tensor:
    """Apply the S * L/S layers of ``stacked`` (copies of ``template``
    holding them) to ``x`` (batch divisible by ``n_micro``), stage s on
    rank s of ``group``; every rank returns the output, equal to applying
    the layers in sequence."""
    from torch.distributed.pipelining import PipelineStage, ScheduleGPipe
    n_stages = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if next(iter(stacked.values())).shape[0] != n_stages:
        raise ValueError("the stacked stages do not match the group")
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n_micro} "
                         "microbatches")
    module = _stage_module(template, stacked, rank).to(device)
    stage = PipelineStage(module, stage_index=rank, num_stages=n_stages,
                          device=torch.device(device), group=group)
    schedule = ScheduleGPipe(stage, n_microbatches=n_micro)
    with torch.no_grad():
        if rank == 0:
            schedule.step(x)
            out = torch.empty_like(x)
        elif rank == n_stages - 1:
            out = schedule.step()
        else:
            schedule.step()
            out = torch.empty_like(x)
    last = (dist.get_global_rank(group, n_stages - 1) if group is not None
            else n_stages - 1)
    dist.broadcast(out, src=last, group=group)
    return out


def run_pipeline_denoiser(layers, x: torch.Tensor, n_micro: int,
                          group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(pipelined, sequential) outputs of the encoder ``layers`` on ``x``
    over as many stages as the group has ranks."""
    n_stages = dist.get_world_size(group)
    out = pipeline_apply(layers[0], stack_layer_params(layers, n_stages), x,
                         n_micro, group)
    with torch.no_grad():
        seq = x
        for layer in layers:
            seq = layer(seq)
    return out, seq
