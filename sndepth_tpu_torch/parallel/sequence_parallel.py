"""Sequence parallelism for the denoiser's transformer encoder layers.

Counterpart of ``sndepth_tpu/parallel/sequence_parallel.py``: each rank of
a group holds T / S positions of the sequence; layer norm, the MLP, the
residuals and the Q / K / V projections run on the local positions with
replicated weights, and attention takes the local queries against keys and
values all-gathered over the group (2 T D floats a layer against the T^2
attention work; its memory drops S-fold).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sndepth_tpu_torch.models.attention import dot_product_attention
from sndepth_tpu_torch.models.denoiser import TransformerEncoderLayer


def _all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 1)


def sp_encoder_layer_apply(layer: TransformerEncoderLayer,
                           x_local: torch.Tensor, group=None) -> torch.Tensor:
    """``layer`` on a sequence shard (B, T/S, D), attention over the
    whole sequence: the layer's own arithmetic, keys and values from every
    rank's shard."""
    attn = layer.self_attn
    b, n, d = x_local.shape
    h = attn.nhead
    y = layer.norm1(x_local)
    y_kv = _all_gather_seq(y, group)
    w, bias = attn.in_proj_weight, attn.in_proj_bias
    q = F.linear(y, w[:d], bias[:d]).reshape(b, n, h, d // h)
    kv = F.linear(y_kv, w[d:], bias[d:]).reshape(b, -1, 2, h, d // h)
    k, v = kv.unbind(2)
    y = attn.out_proj(dot_product_attention(q, k, v).reshape(b, n, d))
    x = x_local + y
    return x + layer.linear2(F.relu(layer.linear1(layer.norm2(x))))


def sequence_parallel_encoder(layers, x: torch.Tensor,
                              group=None) -> torch.Tensor:
    """Apply ``layers`` to x (B, T, D) with the sequence split over the
    group's ranks (T divisible by their number); every rank gets the whole
    output."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} not divisible by {n}")
    per = x.shape[1] // n
    h = x[:, r * per:(r + 1) * per]
    for layer in layers:
        h = sp_encoder_layer_apply(layer, h, group)
    return _all_gather_seq(h, group)


def run_sequence_parallel_encoder(layers, x: torch.Tensor, group=None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sequence-parallel, sequential) outputs of ``layers`` on ``x``."""
    with torch.no_grad():
        sp = sequence_parallel_encoder(layers, x, group)
        seq = x
        for layer in layers:
            seq = layer(seq)
    return sp, seq
