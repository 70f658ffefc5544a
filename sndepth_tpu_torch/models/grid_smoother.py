"""Grid-structured embedding smoothing by conjugate gradient.

Counterpart of ``sndepth_tpu/models/grid_smoother.py``: a matrix-free
conjugate-gradient solve, with a fixed number of iterations, of the screened
grid-Laplacian normal equations

    (I + Dx^T Wx Dx + Dy^T Wy Dy) x = ae

where Dx / Dy are forward differences along W / H. Fields are channel-last,
``(B, H, W, C)``, as the embeddings of the RAFT3D update block are where
they meet the Gauss-Newton step; differentiable by autograd through the
unrolled iterations.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _dx(x: torch.Tensor) -> torch.Tensor:
    """Forward difference along W: (B, H, W-1, C)."""
    return x[:, :, 1:] - x[:, :, :-1]


def _dxT(r: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`_dx`: back to (B, H, W, C)."""
    return F.pad(r, (0, 0, 1, 0)) - F.pad(r, (0, 0, 0, 1))


def _dy(x: torch.Tensor) -> torch.Tensor:
    return x[:, 1:] - x[:, :-1]


def _dyT(r: torch.Tensor) -> torch.Tensor:
    return F.pad(r, (0, 0, 0, 0, 1, 0)) - F.pad(r, (0, 0, 0, 0, 0, 1))


def grid_solve(ae: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
               iters: int = 16) -> torch.Tensor:
    """Solve the system for each channel.

    ae: (B, H, W, C) unary targets; wx / wy: (B, H, W, 1) weights of the edge
    between a pixel and its right / lower neighbour (the last column of wx
    and the last row of wy are unused). Returns the smoothed field."""
    wx_e = wx[:, :, :-1]
    wy_e = wy[:, :-1]

    def apply(x):
        return x + _dxT(wx_e * _dx(x)) + _dyT(wy_e * _dy(x))

    x = ae                      # warm start at the unary target
    r = ae - apply(x)
    p = r
    rs = (r * r).sum((1, 2, 3), keepdim=True)
    for _ in range(iters):
        ap = apply(p)
        alpha = rs / ((p * ap).sum((1, 2, 3), keepdim=True) + 1e-12)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = (r * r).sum((1, 2, 3), keepdim=True)
        p = r + (rs_new / (rs + 1e-12)) * p
        rs = rs_new
    return x


class GridSmoother(nn.Module):
    """Smooth the embedding field with the per-edge weights that the update
    block predicts."""

    def __init__(self, cg_iters: int = 16):
        super().__init__()
        self.cg_iters = cg_iters

    def forward(self, ae: torch.Tensor, wxwy: torch.Tensor) -> torch.Tensor:
        """ae: (B, H, W, C); wxwy: (B, H, W, 2) softplus edge weights."""
        return grid_solve(ae, wxwy[..., 0:1], wxwy[..., 1:2], self.cg_iters)
