"""The (data, model) device mesh and the data-parallel GeoNet train step.

Counterpart of ``sndepth_tpu/parallel/mesh.py``: there one jitted program
over a mesh, the batch sharded and the state replicated, and XLA inserts
the gradient sum. Here each rank runs its own step on its shard of the
global batch, each net wrapped in ``DistributedDataParallel``, whose
backward averages the gradients over the mesh's data axis.

Three places of the GeoNet step read the batch as a whole where a rank
sees only its shard; :class:`DataReduce` gives ``train/geonet.train_step``
the global answers: the stage-2 consistency masks' normalisers, the
non-finite flag (a rank that skipped while the others stepped would leave
the replicas apart for good) and the logged loss parts.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.parallel.multihost import (make_global_batch,
                                                  world_size)
from sndepth_tpu_torch.train import geonet

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(device="cuda", data_parallel: int | None = None,
              model_parallel: int = 1):
    """A (data, model) ``DeviceMesh`` over the group's ranks, by default
    every rank on the data axis. Needs a process group (one rank is
    enough)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if data_parallel is None or data_parallel <= 0:
        data_parallel = n // model_parallel
    if data_parallel < 1 or data_parallel * model_parallel != n:
        raise ValueError(f"{n} rank(s) cannot form a {data_parallel} x "
                         f"{model_parallel} mesh")
    return init_device_mesh(torch.device(device).type,
                            (data_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's shard of a global batch of tensors: the part of the
    leading axis that its coordinate on the mesh's data axis owns
    (:func:`~sndepth_tpu_torch.parallel.multihost.make_global_batch`)."""
    return make_global_batch(
        batch, mesh.get_local_rank(DATA_AXIS),
        mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)))


def replicate_state(state: geonet.TrainState, mesh) -> geonet.TrainState:
    """Rank 0's weights (parameters and buffers) and counters on every
    rank of the mesh's data axis."""
    group = mesh.get_group(DATA_AXIS)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for net in state.nets().values():
            for t in list(net.parameters()) + list(net.buffers()):
                dist.broadcast(t.data, src=src, group=group)
    counters = [state.step, state.notfinite_count]
    dist.broadcast_object_list(counters, src=src, group=group)
    state.step, state.notfinite_count = counters
    return state


class DataReduce:
    """The reductions of a data-parallel GeoNet step over ``group``."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the global batch, whose shards ``t``
        holds on the ranks (equal or not); carries no gradient."""
        s = torch.stack([t.detach().sum(dtype=torch.float64),
                         t.new_full((), t.numel(), dtype=torch.float64)])
        dist.all_reduce(s, group=self.group)
        return (s[0] / s[1]).to(t.dtype)

    def all(self, flag: torch.Tensor) -> torch.Tensor:
        """``flag`` holds on every rank (a MIN over the ranks)."""
        f = flag.detach().to(torch.float32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=self.group)
        return f[0] > 0

    def average(self, metrics: dict) -> dict:
        """Each scalar of ``metrics`` averaged over the ranks: the same
        values on every rank."""
        keys = list(metrics)
        v = torch.stack([metrics[k].detach().float() for k in keys])
        dist.all_reduce(v, group=self.group)
        v = v / self.size
        return dict(zip(keys, v.unbind()))


def _ddp(net: torch.nn.Module, group) -> DistributedDataParallel:
    device = next(net.parameters()).device
    return DistributedDataParallel(
        net, device_ids=[device] if device.type == "cuda" else None,
        process_group=group)


def make_parallel_train_step(config: GeoNetConfig, mesh):
    """The data-parallel GeoNet step: ``step(state, batch) -> metrics``,
    ``batch`` this rank's shard of the global batch (:func:`shard_batch`).

    ``config.batch_size`` is the global batch and must divide by the size
    of the mesh's data axis. The step is ``train/geonet.train_step`` with
    each net wrapped in ``DistributedDataParallel`` over the data axis (at
    the first call, which also makes rank 0's weights everyone's) and the
    axis's :class:`DataReduce`. The state keeps the bare nets, so a
    checkpoint holds their keys without ``module.`` prefixes: the same file
    as a single-process run writes."""
    group = mesh.get_group(DATA_AXIS)
    n = dist.get_world_size(group)
    if config.batch_size % n:
        raise ValueError(f"global batch {config.batch_size} does not divide "
                         f"over {n} data-parallel ranks")
    ranks = DataReduce(group)
    wrapped: dict = {}

    def step(state: geonet.TrainState, batch: dict) -> dict:
        if wrapped.get("state") is not state:
            wrapped["state"] = state
            wrapped["nets"] = tuple(
                _ddp(net, group) if net is not None else None
                for net in (state.disp_net, state.pose_net, state.flow_net))
        return geonet.train_step(state, batch, config, wrapped["nets"], ranks)

    return step
