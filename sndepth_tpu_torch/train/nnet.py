"""Surface-normal network training (encoder + uncertainty decoder), PyTorch.

Counterpart of ``sndepth_tpu/train/nnet.py``: :class:`NormalNet` is the
EfficientNet encoder and the normal decoder, fed ``bgr_preprocess(rgb) /
255``; the train step runs the decoder in train mode (each level refines a
sample of its points, drawn with the state's generator) and minimises the
multi-scale angular NLL of :mod:`sndepth_tpu_torch.losses.normal_loss` with
AdamW at 3.57e-4 and ``weight_decay=1e-3`` on every parameter, as
``optax.adamw`` (betas 0.9 / 0.999, eps 1e-8 outside the root, the decay
decoupled and times the rate). The encoder's BatchNorms normalise with the
batch's statistics and carry their running averages to the next step. As
the JAX step, the port's has no guard against a non-finite loss.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn

from sndepth_tpu_torch.losses.normal_loss import decoder_multi_scale_loss
from sndepth_tpu_torch.models import nnet as nnet_lib
from sndepth_tpu_torch.models.efficientnet import (BlockSpec,
                                                   EfficientNetEncoder)
from sndepth_tpu_torch.models.normal_decoder import NormalDecoder

LR, WEIGHT_DECAY = 3.57e-4, 1e-3


class NormalNet(nn.Module):
    """``net(rgb)``: rgb (B, H, W, 3) in the training-value range -> the
    decoder's four (B, h, w, 4) maps; ``net(rgb, mode="train",
    gt_norm_mask=..., generator=...)`` -> the decoder's train triple.
    Module names ``encoder.*`` and ``decoder.*`` are those of
    :class:`~sndepth_tpu_torch.models.nnet.NNET`. ``blocks``, ``stem_ch`` and
    ``head_ch`` size the encoder (EfficientNet-B5 by default)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 blocks: Sequence[BlockSpec] | None = None,
                 stem_ch: int = 48, head_ch: int = 2048):
        super().__init__()
        self.encoder = EfficientNetEncoder(blocks, stem_ch, head_ch, dtype)
        self.decoder = NormalDecoder(self.encoder.channels(), "GN", dtype)

    def forward(self, rgb: torch.Tensor, mode: str = "test", **train_args):
        x = nnet_lib.bgr_preprocess(rgb) / 255.0
        return self.decoder(self.encoder(x.permute(0, 3, 1, 2)), mode,
                            **train_args)


@dataclasses.dataclass
class NNETTrainState:
    """Model, optimizer, the sampler's generator (on the model's device)
    and the count of updates; :func:`train_step` updates it in place."""
    model: NormalNet
    optimizer: torch.optim.AdamW
    generator: torch.Generator
    step: int = 0


def make_optimizer(params) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def create_train_state(model: NormalNet | None = None, device="cuda",
                       dtype: torch.dtype = torch.float32,
                       seed: int = 0) -> NNETTrainState:
    """A train state on ``device``. Without a ``model``, a full-width
    :class:`NormalNet` computing in ``dtype``, with weights drawn on the
    host from ``seed``; the sampler's generator is seeded from ``seed``
    too."""
    if model is None:
        model = NormalNet(dtype)
        nnet_lib.init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    generator = torch.Generator(torch.device(device)).manual_seed(seed)
    return NNETTrainState(model, make_optimizer(model.parameters()),
                          generator)


def train_step(state: NNETTrainState, batch: dict) -> dict:
    """One AdamW update on ``batch``: ``rgb`` (B, H, W, 3), ``normals``
    (B, H, W, 3) and ``mask`` (B, H, W) bool, tensors on the model's
    device. Returns ``{"loss"}``, detached."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    outs, points, selections = state.model(
        batch["rgb"], "train", gt_norm_mask=batch["mask"][..., None],
        generator=state.generator)
    loss = decoder_multi_scale_loss(outs, points, selections,
                                    batch["normals"], batch["mask"])
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach()}
