"""BEVFormerTrackHead: the BEV features and the DETR detection head.

Counterpart of ``sndepth_tpu/models/track_head.py`` (reference
`models/track_head.py` and the PerceptionTransformer of
`transformer_modules/transformer.py`): the learned BEV queries with the
can-bus MLP and the sine positional embedding, the camera and level
embeddings on the flattened image features, the encoder (with the previous
BEV shifted for ego motion where a shift is given), and the decoder over
the track queries with one classification, box and past-trajectory branch
per decoder layer, boxes refined in sigmoid space.

The state_dict names are the reference's ``pts_bbox_head.*``:
``bev_embedding``, ``transformer.{level_embeds, cams_embeds, can_bus_mlp,
encoder, decoder}``, ``cls_branches``, ``reg_branches``,
``past_traj_reg_branches``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from sndepth_tpu_torch.models.bevformer import (BEVFormerEncoder,
                                                DetectionTransformerDecoder,
                                                inverse_sigmoid,
                                                shift_prev_bev)
from sndepth_tpu_torch.ops.layers import Dense, LayerNorm
from sndepth_tpu_torch.utils.uniad import pos2posemb2d


class Branch(nn.Sequential):
    """A decoder layer's MLP: (Linear, [LayerNorm,] ReLU) x 2, then a
    float32 Linear; hidden width 256 (the classification branch has the
    LayerNorms, at indices 1 and 4)."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 256,
                 use_ln: bool = False, dtype: torch.dtype = torch.float32):
        mods = []
        d = in_dim
        for _ in range(2):
            mods.append(Dense(d, hidden, dtype=dtype))
            if use_ln:
                mods.append(LayerNorm(hidden, dtype=dtype))
            mods.append(nn.ReLU())
            d = hidden
        mods.append(Dense(hidden, out_dim))
        super().__init__(*mods)


class _Transformer(nn.Module):
    """The PerceptionTransformer's parameters and its encoder / decoder."""

    def __init__(self, encoder, decoder, num_levels, num_cams, embed_dims):
        super().__init__()
        self.level_embeds = nn.Parameter(torch.randn(num_levels, embed_dims))
        self.cams_embeds = nn.Parameter(torch.randn(num_cams, embed_dims))
        self.can_bus_mlp = nn.Sequential(
            nn.Linear(18, embed_dims // 2), nn.ReLU(),
            nn.Linear(embed_dims // 2, embed_dims), nn.ReLU())
        self.can_bus_mlp.add_module("norm", LayerNorm(embed_dims))
        self.encoder = encoder
        self.decoder = decoder


class BEVFormerTrackHead(nn.Module):
    def __init__(self, bev_h: int = 200, bev_w: int = 200,
                 embed_dims: int = 256, num_classes: int = 10,
                 num_query: int = 901, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, num_cams: int = 6,
                 num_levels: int = 4,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2,
                                              3.0),
                 past_steps: int = 4, fut_steps: int = 4,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.embed_dims, self.num_cams = embed_dims, num_cams
        self.pc_range = tuple(pc_range)
        self.traj_steps = past_steps + fut_steps
        self.bev_embedding = nn.Embedding(bev_h * bev_w, embed_dims)
        self.transformer = _Transformer(
            BEVFormerEncoder(bev_h, bev_w, embed_dims, num_encoder_layers,
                             num_cams, num_levels, pc_range=pc_range,
                             dtype=dtype, remat=remat),
            DetectionTransformerDecoder(embed_dims, num_decoder_layers,
                                        dtype=dtype, remat=remat),
            num_levels, num_cams, embed_dims)
        n = num_decoder_layers
        self.cls_branches = nn.ModuleList([
            Branch(embed_dims, num_classes, use_ln=True, dtype=dtype)
            for _ in range(n)])
        self.reg_branches = nn.ModuleList([
            Branch(embed_dims, 10, dtype=dtype) for _ in range(n)])
        self.past_traj_reg_branches = nn.ModuleList([
            Branch(embed_dims, self.traj_steps * 2, dtype=dtype)
            for _ in range(n)])

    def bev_positional(self) -> torch.Tensor:
        dev = self.bev_embedding.weight.device
        ys = (torch.arange(self.bev_h, dtype=torch.float32, device=dev)
              + 0.5) / self.bev_h
        xs = (torch.arange(self.bev_w, dtype=torch.float32, device=dev)
              + 0.5) / self.bev_w
        pos = torch.stack([xs[None, :].expand(self.bev_h, self.bev_w),
                           ys[:, None].expand(self.bev_h, self.bev_w)],
                          -1).reshape(-1, 2)
        return pos2posemb2d(pos, self.embed_dims // 2)[None]

    def get_bev_features(self, mlvl_feats, lidar2img, img_hw, prev_bev=None,
                         ego_shift=None, ego_rotation_deg=None, can_bus=None):
        """mlvl_feats: per level (cams, B, C, h, w). Returns the BEV (B,
        bev_h bev_w, C)."""
        t = self.transformer
        b = mlvl_feats[0].shape[1]
        spatial_shapes = [tuple(f.shape[3:5]) for f in mlvl_feats]
        value = torch.cat(
            [f.flatten(3).transpose(2, 3)
             + t.cams_embeds[:, None, None, :].to(f.dtype)
             + t.level_embeds[li][None, None, None, :].to(f.dtype)
             for li, f in enumerate(mlvl_feats)], 2)
        emb = self.bev_embedding.weight
        bev_queries = emb[None].expand(b, *emb.shape)
        if can_bus is None:
            can_bus = emb.new_zeros(18)
        cb = t.can_bus_mlp(can_bus)
        bev_queries = bev_queries + cb.to(bev_queries.dtype)
        bev_pos = self.bev_positional().to(bev_queries.dtype)
        if prev_bev is not None and ego_shift is not None:
            prev_bev = shift_prev_bev(prev_bev, self.bev_h, self.bev_w,
                                      ego_shift, ego_rotation_deg)
        return t.encoder(bev_queries, value, lidar2img, img_hw,
                         spatial_shapes, prev_bev=prev_bev, bev_pos=bev_pos)

    def get_detections(self, bev, object_query, ref_points) -> dict:
        """bev (B, bev_h bev_w, C); object_query (B, nq, 2C) laid out
        [query_pos | query_feat]; ref_points (B, nq, 3) in sigmoid space.
        Returns the per-layer logits, boxes and past trajectories and the
        last layer's query states and reference points."""
        query_pos, query = object_query.chunk(2, -1)
        states, refs = self.transformer.decoder(
            query, bev, ref_points, (self.bev_h, self.bev_w), query_pos,
            reg_branches=lambda q, layer: self.reg_branches[layer](q))
        x0, y0, z0, x1, y1, z1 = self.pc_range
        logits_l, boxes_l, traj_l = [], [], []
        for li in range(states.shape[0]):
            q = states[li]
            ref = refs[li - 1] if li > 0 else ref_points
            reg = self.reg_branches[li](q)
            ref_inv = inverse_sigmoid(ref)
            cx = torch.sigmoid(reg[..., 0:1] + ref_inv[..., 0:1])
            cy = torch.sigmoid(reg[..., 1:2] + ref_inv[..., 1:2])
            cz = torch.sigmoid(reg[..., 4:5] + ref_inv[..., 2:3])
            boxes = torch.cat([cx * (x1 - x0) + x0, cy * (y1 - y0) + y0,
                               reg[..., 2:4], cz * (z1 - z0) + z0,
                               reg[..., 5:10]], -1)
            logits_l.append(self.cls_branches[li](q))
            boxes_l.append(boxes)
            traj_l.append(self.past_traj_reg_branches[li](q).reshape(
                *q.shape[:-1], self.traj_steps, 2))
        return {"all_cls_scores": torch.stack(logits_l),
                "all_bbox_preds": torch.stack(boxes_l),
                "all_past_traj_preds": torch.stack(traj_l),
                "query_feats": states[-1], "ref_pts": refs[-1]}
