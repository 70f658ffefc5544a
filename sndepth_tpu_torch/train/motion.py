"""Motion-segmentation training and evaluation (PyTorch).

Counterpart of ``sndepth_tpu/train/motion.py`` (reference `train.py`: Adam at
lr 0.01 with ``StepLR(3000, 0.9)``, cross-entropy): the loss of
:class:`MotionFusionNet` on a batch, one train step with the BatchNorm
statistics carried to the next step, and the evaluation step (argmax and
mean IoU). The rate is optax's staircase ``exponential_decay(0.01, 3000,
0.9)`` written out (:func:`lr_at`): ``lr 0.9^floor(count / 3000)`` at the
count of the updates before this one, set on ``torch.optim.Adam`` (betas
0.9 / 0.999, eps 1e-8 outside the root, as ``optax.adam``) before each
update. As the JAX step, the port's has no guard against a non-finite loss.
"""

from __future__ import annotations

import dataclasses

import torch

from sndepth_tpu_torch.losses.segmentation import cross_entropy
from sndepth_tpu_torch.models.motionseg import MotionFusionNet, init_weights
from sndepth_tpu_torch.utils.metrics import mean_iou

LR, DECAY_STEPS, DECAY_RATE = 0.01, 3000, 0.9


def lr_at(count: int) -> float:
    """``optax.exponential_decay(0.01, 3000, 0.9, staircase=True)`` at
    ``count``."""
    return LR * DECAY_RATE ** (count // DECAY_STEPS)


@dataclasses.dataclass
class MotionTrainState:
    """Model, optimizer and the count of updates applied; :func:`train_step`
    updates it in place."""
    model: MotionFusionNet
    optimizer: torch.optim.Adam
    step: int = 0


def create_train_state(model: MotionFusionNet | None = None, device="cuda",
                       dtype: torch.dtype = torch.float32,
                       seed: int = 0) -> MotionTrainState:
    """A train state on ``device``. Without a ``model``, a
    :class:`MotionFusionNet` computing in ``dtype`` with weights drawn on the
    host from ``seed``: the same seed gives the same weights on every
    device."""
    if model is None:
        model = MotionFusionNet(dtype=dtype)
        init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=lr_at(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return MotionTrainState(model, optimizer)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def motion_loss(model: MotionFusionNet, batch: dict
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of one batch as the readers give it: ``image`` and
    ``flow`` (B, H, W, 3) in [0, 1], ``label`` (B, H, W) integer, tensors on
    the model's device. Returns the loss and the logits (B, H, W, C)."""
    logits = model(_nchw(batch["image"]), _nchw(batch["flow"]))
    logits = logits.permute(0, 2, 3, 1)
    return cross_entropy(logits, batch["label"]), logits


def train_step(state: MotionTrainState, batch: dict) -> dict:
    """One Adam update on ``batch`` in train mode (batch statistics, which
    move the running averages). Returns ``{"loss", "pixel_acc"}``,
    detached."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, logits = motion_loss(state.model, batch)
    loss.backward()
    for group in state.optimizer.param_groups:
        group["lr"] = lr_at(state.step)
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        acc = (logits.argmax(-1) == batch["label"]).float().mean()
    return {"loss": loss.detach(), "pixel_acc": acc}


@torch.no_grad()
def eval_step(model: MotionFusionNet, batch: dict) -> dict:
    """The model on its running statistics: ``{"miou", "pred"}``, the mean
    IoU of the argmax ``pred`` (B, H, W) against ``batch["label"]``. The
    model's train or eval mode is left as it was."""
    was_training = model.training
    model.eval()
    try:
        _, logits = motion_loss(model, batch)
    finally:
        model.train(was_training)
    pred = logits.argmax(-1)
    return {"miou": mean_iou(pred, batch["label"], logits.shape[-1]),
            "pred": pred}
