"""The pose-denoising transformer ("opt former") and its embeddings.

Counterpart of ``sndepth_tpu/models/denoiser.py``: the sinusoidal timestep
embedding and its SiLU MLP (128 wide out), the harmonic pose embedding
([sin 2^k x, cos 2^k x, x], pytorch3d's ``HarmonicEmbedding``), an 8-layer
pre-norm transformer encoder (d 512, 4 heads, feed-forward 1024) over the
per-track tokens [pose embedding | time embedding | image features | pivot
one-hot], and a LayerNorm MLP head to a 9-dim pose update.

Module names follow torch's ``nn.TransformerEncoderLayer``
(``_trunk.layers.{i}.self_attn.in_proj_weight``, ``linear1``, ``norm1`` ...)
and the reference's ``TimeStepEmbedding`` (``time_embed.linear.{0,2}``);
:func:`sndepth_tpu_torch.utils.weights.denoiser_state_dict_from_jax` carries
the JAX parameters across. As in JAX: LayerNorm at epsilon 1e-6, the query
scaled before the attention product, ReLU in the feed-forward. Everything
runs in float32, as in ``models.vae``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.attention import dot_product_attention


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """(B,) -> (B, dim) sinusoidal embedding, [cos | sin], a zero column
    appended for an odd ``dim``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], -1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], -1)
    return emb


class TimeStepEmbedding(nn.Module):
    """The sinusoidal embedding of ``dim`` through Linear, SiLU, Linear to
    ``dim // 2``."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.dim = dim
        self.linear = nn.Sequential(nn.Linear(dim, dim // 2), nn.SiLU(),
                                    nn.Linear(dim // 2, dim // 2))

    @property
    def out_dim(self) -> int:
        return self.dim // 2

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.linear(timestep_embedding(t, self.dim))


def harmonic_embedding(x: torch.Tensor, n_harmonics: int = 10,
                       append_input: bool = True) -> torch.Tensor:
    """[sin(2^k x), cos(2^k x), x] over the last axis, k-minor."""
    freqs = 2.0 ** torch.arange(n_harmonics, dtype=x.dtype, device=x.device)
    xb = x[..., None] * freqs
    parts = [torch.sin(xb).flatten(-2), torch.cos(xb).flatten(-2)]
    return torch.cat(parts + ([x] if append_input else []), -1)


def harmonic_out_dim(target_dim: int, n_harmonics: int = 10,
                     append_input: bool = True) -> int:
    return target_dim * (2 * n_harmonics + int(append_input))


class SelfAttention(nn.Module):
    """Multi-head self-attention under ``nn.MultiheadAttention``'s names:
    the packed ``in_proj_weight`` (3 d, d) and ``in_proj_bias``, and
    ``out_proj``."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.reshape(b, n, 3, self.nhead, d // self.nhead).unbind(2)
        return self.out_proj(dot_product_attention(q, k, v).reshape(b, n, d))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer (torch ``norm_first=True``), ReLU
    feed-forward, no dropout."""

    def __init__(self, d_model: int = 512, nhead: int = 4,
                 dim_feedforward: int = 1024):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.self_attn = SelfAttention(d_model, nhead)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        return x + self.linear2(F.relu(self.linear1(self.norm2(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int = 512, nhead: int = 4,
                 num_layers: int = 8, dim_feedforward: int = 1024):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class Denoiser(nn.Module):
    """forward(x, t, z): x (B, N, target_dim) noisy poses, t (B,)
    timesteps, z (B, N, z_dim) per-track features -> (B, N, target_dim),
    float32."""

    def __init__(self, target_dim: int = 9, z_dim: int = 384,
                 d_model: int = 512, nhead: int = 4, num_layers: int = 8,
                 dim_feedforward: int = 1024, mlp_hidden_dim: int = 128,
                 pivot_cam_onehot: bool = True):
        super().__init__()
        self.pivot_cam_onehot = pivot_cam_onehot
        self.time_embed = TimeStepEmbedding()
        first_dim = (harmonic_out_dim(target_dim) + self.time_embed.out_dim
                     + z_dim + int(pivot_cam_onehot))
        self._first = nn.Linear(first_dim, d_model)
        self._trunk = TransformerEncoder(d_model, nhead, num_layers,
                                         dim_feedforward)
        self._last = nn.Sequential(
            nn.LayerNorm(d_model, eps=1e-6),
            nn.Linear(d_model, mlp_hidden_dim), nn.ReLU(),
            nn.Linear(mlp_hidden_dim, target_dim))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        t_emb = self.time_embed(t)
        t_emb = t_emb[:, None].expand(b, n, t_emb.shape[-1])
        if self.pivot_cam_onehot:
            pivot = torch.zeros(b, n, 1, dtype=z.dtype, device=z.device)
            pivot[:, 0, 0] = 1.0
            z = torch.cat([z, pivot], -1)
        feats = torch.cat([harmonic_embedding(x), t_emb, z], -1)
        return self._last(self._trunk(self._first(feats)))


def get_opt_model() -> Denoiser:
    """The reference's configuration (`denoiser.py:167-184`)."""
    return Denoiser()
