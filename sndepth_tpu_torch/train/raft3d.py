"""RAFT3D training: per-iteration sequence loss and the train step (PyTorch).

Counterpart of ``sndepth_tpu/train/raft3d.py``:

    L = sum_i gamma^(N-1-i) * (mean_valid |flow_est_i - flow_gt|_1
                               + mean_valid |flow_rev_i - flow_gt[:2]|_1)

over the (u, v, inverse-depth-change) flow that each iteration's upsampled
SE3 field induces, and over the upsampled revised flow. The optimizer is the
JAX step's ``optax.chain(clip_by_global_norm(1), adamw(onecycle))`` written
out: :func:`onecycle_lr` is optax's piecewise-linear one-cycle schedule,
:func:`clip_by_global_norm_` scales by ``1 / norm`` only where the norm
exceeds the bound, and ``torch.optim.AdamW`` (eps outside the root, decay
decoupled and times the scheduled rate, on every parameter) takes the rate
of the step's count before each update.

The model's Gauss-Newton build runs the hand-written kernels forward and
backward on a CUDA tensor (:mod:`sndepth_tpu_torch.kernels.gn_build`), their
plain versions on the CPU. The context net's BatchNorm stays on its running
statistics, which a step never changes; its scales and biases train. The
activations of every refinement iteration are kept for the backward pass:
the JAX model's ``remat_iters`` has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from sndepth_tpu_torch.models.raft3d import RAFT3D, init_weights

# A step whose loss or gradient is not finite is skipped and counted; this
# many in a row raise (the rule of the GeoNet step).
MAX_CONSECUTIVE_SKIPS = 100
TOTAL_STEPS = 200_000


def onecycle_lr(count: int, lr: float = 2e-4,
                total_steps: int = TOTAL_STEPS) -> float:
    """``optax.linear_onecycle_schedule(total_steps, lr)`` at ``count``:
    linear from ``lr / 25`` at 0 to ``lr`` at ``int(0.3 * total_steps)``,
    to ``lr / 25`` at ``int(0.85 * total_steps)``, to ``lr / 25e4`` at
    ``total_steps``, and constant from there."""
    low, last = lr / 25.0, lr / 25.0 / 1e4
    b1, b2 = int(0.3 * total_steps), int(0.85 * total_steps)
    for x0, x1, y0, y1 in ((0, b1, low, lr), (b1, b2, lr, low),
                           (b2, total_steps, low, last)):
        if count < x1:
            return y0 + (y1 - y0) * (count - x0) / (x1 - x0)
    return last


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float = 1.0
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global
    L2 norm exceeds ``max_norm`` (``optax.clip_by_global_norm``: no epsilon,
    and no change below the bound). Returns the norm before clipping."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    torch._foreach_mul_(grads, scale)
    return norm


def sequence_loss(flow_est: torch.Tensor, flow_rev: torch.Tensor,
                  flow_gt: torch.Tensor, valid: torch.Tensor,
                  gamma: float = 0.9) -> tuple[torch.Tensor, dict]:
    """flow_est (iters, B, H, W, 3), flow_rev (iters, B, H, W, 2), flow_gt
    (B, H, W, 3), valid (B, H, W). Returns the loss and ``{"loss",
    "epe2d"}``: ``epe2d`` is the mean end-point error of the last
    iteration's 2-D flow over the valid pixels."""
    n = flow_est.shape[0]
    mask = valid[None, ..., None]
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_est.device)
    count = mask.sum()
    err_est = (flow_est - flow_gt[None]).abs() * mask
    per_iter_est = err_est.sum((1, 2, 3, 4)) / (
        count * flow_est.shape[-1] + 1e-8)
    err_rev = (flow_rev - flow_gt[None, ..., :2]).abs() * mask
    per_iter_rev = err_rev.sum((1, 2, 3, 4)) / (count * 2 + 1e-8)
    loss = (weights * (per_iter_est + per_iter_rev)).sum()
    epe = (torch.linalg.vector_norm(
        flow_est[-1][..., :2] - flow_gt[..., :2], dim=-1) * valid
    ).sum() / (valid.sum() + 1e-8)
    return loss, {"loss": loss, "epe2d": epe}


def make_optimizer(params, lr: float = 2e-4,
                   weight_decay: float = 1e-5) -> torch.optim.AdamW:
    """AdamW as ``optax.adamw``: betas (0.9, 0.999), eps 1e-8 outside the
    root, decoupled decay on every parameter. The rate it starts with is the
    schedule's at count 0; :func:`train_step` sets it before each update."""
    return torch.optim.AdamW(params, lr=onecycle_lr(0, lr),
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class RAFT3DTrainState:
    """Model, optimizer and counters; :func:`train_step` updates it in
    place. ``step`` counts the updates applied, and the schedule is read at
    it; ``calls`` counts every call, skipped ones included."""
    model: RAFT3D
    optimizer: torch.optim.AdamW
    step: int = 0
    notfinite_count: int = 0
    calls: int = 0


def create_train_state(model: RAFT3D | None = None, device="cuda",
                       seed: int = 0) -> RAFT3DTrainState:
    """A train state on ``device``. Without a ``model``, a default
    :class:`RAFT3D` with weights drawn on the host from ``seed``: the same
    seed gives the same weights on every device."""
    if model is None:
        model = RAFT3D()
        init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).train()
    return RAFT3DTrainState(model, make_optimizer(list(model.parameters())))


def raft3d_loss(model: RAFT3D, batch: dict, iters: int = 12,
                gamma: float = 0.9) -> tuple[torch.Tensor, dict]:
    """Sequence loss of one batch as the readers give it: ``image1`` /
    ``image2`` (B, H, W, 3), ``depth1`` / ``depth2`` (B, H, W),
    ``intrinsics`` (B, 4), ``flow`` (B, H, W, 3), ``valid`` (B, H, W), all
    float tensors on the model's device."""
    image1, image2 = (batch[k].permute(0, 3, 1, 2).contiguous()
                      for k in ("image1", "image2"))
    flow_est, flow_rev, _ = model(image1, image2, batch["depth1"],
                                  batch["depth2"], batch["intrinsics"],
                                  iters=iters, train_mode=True)
    return sequence_loss(flow_est, flow_rev, batch["flow"], batch["valid"],
                         gamma)


def train_step(state: RAFT3DTrainState, batch: dict, iters: int = 12,
               gamma: float = 0.9) -> dict:
    """One optimizer step on a batch on the model's device. The schedule
    runs over ``TOTAL_STEPS`` whatever the length of the run, as the JAX
    step's does. The update is skipped, and the skip counted, when the loss
    or any gradient is not finite; a skipped update moves neither the
    optimizer's count nor the schedule's (``state.step``), as optax's
    ``apply_if_finite`` leaves the JAX GeoNet step's, and only
    ``state.calls`` counts it. Returns ``{"loss", "epe2d", "grad_norm"}``,
    detached."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = raft3d_loss(state.model, batch, iters, gamma)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = clip_by_global_norm_([p.grad for p in params])
    state.calls += 1
    # The norm is finite exactly when every gradient entry is.
    if bool(torch.isfinite(loss) & torch.isfinite(norm)):
        for group in state.optimizer.param_groups:
            group["lr"] = onecycle_lr(state.step)
        state.optimizer.step()
        state.step += 1
        state.notfinite_count = 0
    else:
        state.notfinite_count += 1
        if state.notfinite_count > MAX_CONSECUTIVE_SKIPS:
            raise FloatingPointError(
                f"{state.notfinite_count} consecutive non-finite steps")
    return {"loss": metrics["loss"].detach(),
            "epe2d": metrics["epe2d"].detach(), "grad_norm": norm}


def make_train_step(iters: int = 12, gamma: float = 0.9):
    """``step(state, batch)`` with the iteration count and gamma bound."""
    def step(state: RAFT3DTrainState, batch: dict) -> dict:
        return train_step(state, batch, iters, gamma)
    return step
