"""The attention library of the VAE / diffusion stack (NCHW images, (B, N, C)
token sequences).

Counterpart of ``sndepth_tpu/models/attention.py``, in the reference's
module names (``to_q``, ``to_out.0``, ``ff.net.0.proj``,
``transformer_blocks.{i}``, ``proj_in`` ...): linear attention, multi-head
cross-attention, spatial self-attention, the gated feed-forward, the
transformer blocks and the spatial transformers (also the cross-frame 3-D
one, whose tokens span every frame of a clip), and
:func:`chunked_attention`, the form that never holds all the logits.

As in JAX: a mask fills the logits of invalid keys with -1e9, the
feed-forward's GELU is the tanh form (flax ``nn.gelu``'s default), LayerNorm
and GroupNorm at epsilon 1e-6, and the output projection of a spatial
transformer starts at zero. Everything runs in float32, as in
``models.vae``. Attention is ``torch.matmul``: no hand-written kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.vae import AttnBlock


def _attend(q, k, v, mask=None):
    """q (B, N, H, D), k and v (B, M, H, D), mask (B, M) -> (B, N, H, D):
    softmax(q k^T / sqrt(D)) v."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k)
    logits = logits * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
    attn = torch.softmax(logits, -1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def dot_product_attention(q, k, v):
    """flax ``MultiHeadDotProductAttention``'s core: the query scaled by
    1 / sqrt(D) before its product with the keys, softmax over the keys.
    q (B, N, H, D), k and v (B, M, H, D) -> (B, N, H, D)."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q / q.shape[-1] ** 0.5, k)
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, -1), v)


class LinearAttention(nn.Module):
    """O(N) attention: the softmax over the keys' positions, a (D, D)
    context a head."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, 3 * inner, 1, bias=False)
        self.to_out = nn.Conv2d(inner, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        qkv = self.to_qkv(x).reshape(b, 3, self.heads, self.dim_head, h * w)
        q, k, v = qkv.unbind(1)                                  # b,h,d,n
        k = torch.softmax(k, -1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(b, -1, h, w))


class CrossAttention(nn.Module):
    """Multi-head attention of ``x`` (B, N, query_dim) over ``context``
    (B, M, context_dim), itself when None; ``mask`` (B, M) marks valid
    keys."""

    def __init__(self, query_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context=None, mask=None):
        context = x if context is None else context
        split = lambda t: t.reshape(*t.shape[:2], self.heads, self.dim_head)
        out = _attend(split(self.to_q(x)), split(self.to_k(context)),
                      split(self.to_v(context)), mask)
        return self.to_out(out.flatten(2))


class SpatialSelfAttention(AttnBlock):
    """GroupNorm and single-head attention over the positions, projected
    by 1x1 convolutions, with a residual: the VAE's :class:`AttnBlock`."""


class FeedForward(nn.Module):
    """GEGLU (``gated``, the default) or GELU feed-forward, ``mult`` times
    wider inside; GELU in its tanh form."""

    def __init__(self, dim: int, mult: int = 4, gated: bool = True):
        super().__init__()
        self.gated = gated
        inner = dim * mult
        proj = nn.Linear(dim, 2 * inner if gated else inner)
        first = nn.Module()
        if gated:
            first.proj = proj
        else:
            first = nn.Sequential(proj)
        self.net = nn.Sequential(first, nn.Identity(),
                                 nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h, gate = self.net[0].proj(x).chunk(2, -1)
            h = h * F.gelu(gate, approximate="tanh")
        else:
            h = F.gelu(self.net[0][0](x), approximate="tanh")
        return self.net[2](h)


class BasicTransformerBlock21(nn.Module):
    """Self-attention (cross-attention to ``context`` with
    ``disable_self_attn``), cross-attention and the feed-forward, each a
    pre-norm residual."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 context_dim: int | None = None,
                 disable_self_attn: bool = False):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(
            dim, context_dim if disable_self_attn else None, heads, dim_head)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.ff = FeedForward(dim)
        for i in (1, 2, 3):
            setattr(self, f"norm{i}", nn.LayerNorm(dim, eps=1e-6))

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x),
                           context if self.disable_self_attn else None)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class BasicTransformerBlock(BasicTransformerBlock21):
    """Self-attention, cross-attention to ``context`` (itself when None)
    and the feed-forward, each a pre-norm residual."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 context_dim: int | None = None):
        super().__init__(dim, heads, dim_head, context_dim, False)


class SpatialTransformer21(nn.Module):
    """GroupNorm, an input projection (a 1x1 convolution, or with
    ``use_linear`` a linear layer on the tokens), ``depth`` transformer
    blocks (``context`` one for all or a list, one a block), the output
    projection (zero at the start) and the residual. (B, C, H, W) in and
    out."""

    def __init__(self, in_channels: int, heads: int = 8, dim_head: int = 64,
                 depth: int = 1, context_dim: int | None = None,
                 use_linear: bool = False, disable_self_attn: bool = False):
        super().__init__()
        self.use_linear = use_linear
        self.depth = depth
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        make = ((lambda i, o: nn.Linear(i, o)) if use_linear
                else (lambda i, o: nn.Conv2d(i, o, 1)))
        self.proj_in = make(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock21(inner, heads, dim_head, context_dim,
                                    disable_self_attn)
            for _ in range(depth))
        self.proj_out = make(inner, in_channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def _tokens(self, y: torch.Tensor) -> torch.Tensor:
        return y.flatten(2).transpose(1, 2)

    def forward(self, x, context=None):
        if not isinstance(context, list):
            context = [context] * self.depth
        b, c, h, w = x.shape
        y = self.norm(x)
        if self.use_linear:
            y = self.proj_in(self._tokens(y))
        else:
            y = self._tokens(self.proj_in(y))
        for block, ctx in zip(self.transformer_blocks, context):
            y = block(y, ctx)
        if self.use_linear:
            y = self.proj_out(y).transpose(1, 2).reshape(b, c, h, w)
        else:
            y = self.proj_out(y.transpose(1, 2).reshape(b, -1, h, w))
        return y + x


class SpatialTransformer(SpatialTransformer21):
    """The image-to-sequence transformer: GroupNorm, 1x1 projections around
    ``depth`` :class:`BasicTransformerBlock` s, the residual."""

    def __init__(self, in_channels: int, heads: int = 8, dim_head: int = 64,
                 depth: int = 1, context_dim: int | None = None):
        super().__init__(in_channels, heads, dim_head, depth, context_dim)


class SpatialTransformer3D(SpatialTransformer):
    """The cross-frame variant: the tokens of all ``frames`` of a clip,
    (B F, C, H, W) in, attend jointly as (B, F H W) sequences."""

    def __init__(self, in_channels: int, frames: int, heads: int = 8,
                 dim_head: int = 64, depth: int = 1,
                 context_dim: int | None = None):
        super().__init__(in_channels, heads, dim_head, depth, context_dim)
        self.frames = frames

    def _tokens(self, y: torch.Tensor) -> torch.Tensor:
        bf, c = y.shape[:2]
        return (y.reshape(bf // self.frames, self.frames, c, -1)
                .permute(0, 1, 3, 2).reshape(bf // self.frames, -1, c))

    def forward(self, x, context=None):
        bf, c, h, w = x.shape
        y = self._tokens(self.proj_in(self.norm(x)))
        for block in self.transformer_blocks:
            y = block(y, context)
        y = y.reshape(bf, h * w, -1).transpose(1, 2).reshape(bf, -1, h, w)
        return self.proj_out(y) + x


def chunked_attention(q, k, v, *, chunk: int = 1024, mask=None):
    """Attention over blocks of ``chunk`` queries at a time, so that at most
    (B, H, chunk, M) logits exist at once; the same arithmetic as the dense
    form, block by block. q (B, N, H, D), k and v (B, M, H, D), mask
    (B, M) of valid keys -> (B, N, H, D)."""
    return torch.cat([_attend(q[:, i:i + chunk], k, v, mask)
                      for i in range(0, q.shape[1], chunk)], 1)
