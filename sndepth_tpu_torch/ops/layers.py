"""Seeded weights for a net that runs without a checkpoint.

One LeCun initialisation for every net that takes it: RAFT3D, RAFT2D and
the VAE / diffusion stack (``models.raft3d`` re-exports it).
"""

from __future__ import annotations

import torch
import torch.nn as nn


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights, drawn from ``generator`` in module order: convolution
    and linear weights normal with variance 1 / fan_in (LeCun), biases
    zero, norms at identity (BatchNorm's running statistics too); a packed
    attention projection (``nn.MultiheadAttention``'s ``in_proj_weight``)
    like a linear layer."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            if hasattr(m, "in_proj_weight"):
                d = m.in_proj_weight.shape[1]
                m.in_proj_weight.normal_(0.0, d ** -0.5, generator=generator)
                m.in_proj_bias.zero_()
