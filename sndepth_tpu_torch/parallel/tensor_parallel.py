"""Tensor parallelism: linear layers split on their output features.

Counterpart of ``sndepth_tpu/parallel/tensor_parallel.py``, whose rule
shards every flax ``Dense`` kernel (in, out) on its output axis over the
mesh's model axis when the output width divides it, and replicates the
rest. Here the same rule picks the ``nn.Linear`` layers that stand for
2-D ``Dense`` kernels and applies DTensor's ``ColwiseParallel`` to them
(weight rows and bias sharded, ``Shard(0)``; the output all-gathered, so
every layer hands the next a whole, replicated activation):

- the attention projections stay replicated: flax's attention keeps them
  in ``DenseGeneral`` with 3-D kernels, which the JAX rule leaves alone
  (``SelfAttention``'s packed ``in_proj_weight`` is no ``nn.Linear``, and
  its ``out_proj`` is excluded by name);
- a ragged output, such as the denoiser's 9-dim pose head, stays
  replicated.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.distributed as dist

from sndepth_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, make_mesh,
                                             shard_batch)

# The attention modules of the port's transformers (the denoiser's
# ``self_attn``, the ViT's ``attn``).
ATTENTION_NAMES = ("self_attn", "attn")


def _is_attention_projection(name: str) -> bool:
    return any(part in ATTENTION_NAMES for part in name.split(".")[:-1])


def dense_tp_plan(module: nn.Module, model_size: int) -> dict:
    """``parallelize_module``'s plan for ``module``: ``ColwiseParallel``
    (output replicated) for each ``nn.Linear`` outside attention whose
    output width divides ``model_size``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel
    return {name: ColwiseParallel(output_layouts=Replicate())
            for name, m in module.named_modules()
            if isinstance(m, nn.Linear) and not _is_attention_projection(name)
            and m.out_features % model_size == 0}


def tensor_parallel(module: nn.Module, mesh) -> nn.Module:
    """Shard ``module``'s linear layers over the mesh's model axis by
    :func:`dense_tp_plan` (in place); returns it."""
    from torch.distributed.tensor.parallel import parallelize_module
    model_mesh = mesh[MODEL_AXIS]
    return parallelize_module(module, model_mesh,
                              dense_tp_plan(module, model_mesh.size()))


def run_tensor_parallel_denoiser(model: nn.Module, x: torch.Tensor,
                                 t: torch.Tensor, z: torch.Tensor,
                                 model_parallel: int = 2,
                                 device="cpu") -> torch.Tensor:
    """One forward of the pose denoiser ``model`` with its linear layers
    split over the model axis of a (data, model) mesh of every rank of the
    group (in place: ``model``'s weights become DTensors), the batch split
    over the data axis. Every rank gets the whole output (B, N, 9)."""
    mesh = make_mesh(device, model_parallel=model_parallel)
    tensor_parallel(model, mesh)
    data_group = mesh.get_group(DATA_AXIS)
    mine = shard_batch({"x": x, "t": t, "z": z}, mesh)
    with torch.no_grad():
        out = model(mine["x"], mine["t"], mine["z"]).contiguous()
    parts = [torch.empty_like(out) for _ in range(mesh.size(0))]
    dist.all_gather(parts, out, group=data_group)
    return torch.cat(parts)
