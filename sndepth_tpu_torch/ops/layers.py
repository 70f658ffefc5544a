"""Seeded weights for a net that runs without a checkpoint, and the flax
layers of the UniAD track family in torch's parameter names.

One LeCun initialisation for every net that takes it: RAFT3D, RAFT2D, the
VAE / diffusion stack and UniAD (``models.raft3d`` re-exports it).

:class:`Dense`, :class:`Conv2d`, :class:`LayerNorm` and
:class:`MultiheadAttention` compute as flax's ``nn.Dense``, ``nn.Conv``,
``nn.LayerNorm`` and
``nn.MultiHeadDotProductAttention`` with a ``dtype``: the parameters stay
float32 and are cast to ``dtype`` with the input; LayerNorm takes its
statistics in float32 at flax's epsilon 1e-6 (torch's default is 1e-5);
attention scales the query by 1 / sqrt(head_dim) before its product with
the keys and fills the logits of masked keys with the dtype's most negative
finite value, as flax does, not with -inf: a row with no valid key is then
a uniform softmax, where -inf would give NaN.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype where that is wider: where the
    JAX package computes in float32, a float64 evaluation stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: input, weight and bias cast to
    it (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (flax ``nn.Conv(dtype=...)``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(
            x.to(dt), self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: float32 statistics, epsilon 1e-6, the output
    in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(at_least_f32(x),
                         self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return y.to(self.compute_dtype)


class MultiheadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` in the parameter names of
    ``torch.nn.MultiheadAttention``: ``in_proj_weight`` (3 dim, dim) and
    ``in_proj_bias`` pack the query, key and value projections;
    ``out_proj``. Batch first: q (B, N, dim), k and v (B, M, dim), ``mask``
    broadcastable to (B, heads, N, M), True where a key may be attended."""

    def __init__(self, dim: int, heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Dense(dim, dim, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, mask=None):
        dt = self.compute_dtype
        w = self.in_proj_weight.to(dt).chunk(3)
        b = self.in_proj_bias.to(dt).chunk(3)
        hd = q.shape[-1] // self.heads

        def proj(x, i):
            y = F.linear(x.to(dt), w[i], b[i])
            return y.reshape(*y.shape[:-1], self.heads, hd)

        qh, kh, vh = proj(q, 0), proj(k, 1), proj(v, 2)
        qh = qh / torch.sqrt(torch.tensor(float(hd))).to(dt)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(dt).min)
        attn = torch.softmax(logits, -1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        return self.out_proj(out.flatten(-2))


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
