"""FSDP (ZeRO-3) sharding of a GeoNet train state with FSDP2.

Counterpart of ``sndepth_tpu/parallel/fsdp.py``, which places every large
parameter and optimizer leaf sharded along the data axis (the largest
dimension that divides, leaves under 2^11 elements replicated: a TPU
layout) and lets XLA gather at each use. Here ``fully_shard`` splits every
parameter of each trained net on its first dimension over the mesh's data
axis: each rank holds a 1/N shard of the weights, of their gradients and of
Adam's moments, gathers a net's weights for its forward and backward and
reduce-scatters the gradients (averaged over the ranks, as DDP averages
them). The step is the data-parallel step's (``train/geonet.train_step``
with the same :class:`~sndepth_tpu_torch.parallel.mesh.DataReduce`), so
the loss is the same.

The gradients are sharded DTensors: ``torch.isfinite(g).all()`` on one is
this rank's answer only, so the step reduces the finite flag over the
ranks, as it does under DDP.
"""

from __future__ import annotations

import torch

from sndepth_tpu_torch.core.config import GeoNetConfig
from sndepth_tpu_torch.parallel.mesh import DATA_AXIS, DataReduce
from sndepth_tpu_torch.train import geonet


def shard_state(state: geonet.TrainState, mesh,
                config: GeoNetConfig) -> geonet.TrainState:
    """Shard each net of ``state`` over the mesh's data axis (in place: its
    parameters become DTensors) and give it a fresh optimizer over them.
    Call it on the same weights on every rank (a seeded state, or one
    :func:`~sndepth_tpu_torch.parallel.mesh.replicate_state` made so)."""
    from torch.distributed.fsdp import fully_shard
    data_mesh = mesh[DATA_AXIS]
    for net in state.nets().values():
        fully_shard(net, mesh=data_mesh)
    state.optimizer = geonet.make_optimizer(config, state.parameters())
    return state


def make_fsdp_train_step(config: GeoNetConfig, mesh):
    """``step(state, batch) -> metrics`` on a state made by
    :func:`shard_state`, ``batch`` this rank's shard of the global batch."""
    ranks = DataReduce(mesh.get_group(DATA_AXIS))

    def step(state: geonet.TrainState, batch: dict) -> dict:
        return geonet.train_step(state, batch, config, ranks=ranks)

    return step


def _local_bytes(t: torch.Tensor) -> int:
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.numel() * t.element_size()


def sharded_param_bytes_per_device(state: geonet.TrainState) -> int:
    """This rank's bytes of the parameters and of Adam's two moments (as
    large as the parameters; counted so before the first step allocates
    them)."""
    total = 0
    for p in state.parameters():
        n = _local_bytes(p)
        moments = state.optimizer.state.get(p, {})
        total += n + (sum(_local_bytes(v) for k, v in moments.items()
                          if k in ("exp_avg", "exp_avg_sq"))
                      if moments else 2 * n)
    return total
