"""GeoNet stage-1 training configuration.

Counterpart of :class:`sndepth_tpu.core.config.GeoNetConfig` with the
reference's fields only (reference `models/baseline.py:43-123`). The
TPU layout knobs of the JAX config (space-to-depth convs, packed gradients,
matmul heads, remat) change layout, not values, and have no counterpart
here.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GeoNetConfig:
    """Self-supervised depth+pose training config (reference defaults)."""

    # Workload shape (`baseline.py:51-66`)
    sequence_length: int = 3
    batch_size: int = 4
    img_height: int = 128
    img_width: int = 416
    num_scales: int = 4
    seed: int = 8964
    epochs: int = 30

    # Loss hyperparameters (`baseline.py:95-100`)
    simi_alpha: float = 0.85
    loss_weight_rigid_warp: float = 1.0
    loss_weight_disparity_smooth: float = 0.5

    # Optimizer (`baseline.py:101-108`)
    learning_rate: float = 2e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999

    # Convolution compute type; parameters and the losses stay float32.
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def num_source(self) -> int:
        return self.sequence_length - 1


def apply_precision(config: GeoNetConfig) -> None:
    """In float32 mode, turn off TF32 for cuDNN convolutions and matmuls.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and would break float32 parity with the JAX
    reference. Process-wide: it sets ``torch.backends`` flags.
    """
    if config.compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
