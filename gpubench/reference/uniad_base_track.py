"""Plain PyTorch reference of UniAD's track stage at inference (Hu et al.,
CVPR 2023; ``projects/configs/stage1_track_map/base_track_map.py``), one
frame at a time with the state handed on.

Written out from the published semantics, as this repository's model
defines them: a caffe ResNet-101 with frozen BatchNorm and modulated
deformable convolutions (mmcv's DCNv2) in stages 3-4, FPN on stages 2-4
with one extra level; BEVFormer's encoder (temporal self-attention over the
previous BEV, shifted and rotated for the ego motion, and spatial
cross-attention into the six cameras at pillar points, averaged over the
cameras that see each query); the DETR decoder over the track queries with
reference points refined in sigmoid space; UniAD's runtime tracker (births
above ``score_thresh`` numbered in slot order, deaths after
``miss_tolerance`` frames under ``filter_score_thresh``), memory bank (a
FIFO of saved embeddings on a 3-frame cooldown, fused by attention) and
MOTR's query interaction; the top 100 slots by track score as detections.

Functional, in the weights' dtype (float32; float64 for a look at the
rounding of both sides): every layer reads its weights by state-dict key
from one flat dict, the same dict the port loads (:func:`weight_rules`
lists its keys, shapes and how the benchmark draws each). Every bilinear
gather is :func:`gpubench.reference.sampler.sample`, whose notes count the
gather's work (K5). The caller turns TF32 off (or on, for the control);
the benchmark judges with the reference in float64.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from gpubench.reference.sampler import sample

# Where a trained model's sampling taps land: offsets that spread about
# this many pixels (standard deviation) around their reference points.
SPREAD_PIXELS = 3.0
LN_EPS = 1e-6               # flax's LayerNorm
BN_EPS = 1e-5               # the frozen BatchNorm
HEADS = 8
FFN_DIM = 512
BRANCH_DIM = 256
LEVELS = 4                  # FPN levels the cross-attention samples
SCA_POINTS, TSA_POINTS, DEC_POINTS = 8, 4, 4
PILLAR_POINTS = 4
TRAJ_STEPS = 8              # past + future steps of the trajectory branch
CAN_BUS = 18
SAVE_PERIOD = 3
MAX_DETS = 100
DCN_STAGES = (False, False, True, True)


# ----------------------------------------------------------------------
# The weights: every key, its shape and its draw
# ----------------------------------------------------------------------

def _lecun(shape):
    fan_in = math.prod(shape[1:])
    return ("normal", fan_in ** -0.5)


def _linear(name, n_out, n_in, bias=True):
    out = [(f"{name}.weight", (n_out, n_in), _lecun((n_out, n_in)))]
    if bias:
        out.append((f"{name}.bias", (n_out,), ("const", 0.0)))
    return out


def _offsets(name, n_out, n_in):
    """A deformable attention's offset layer: taps spread about
    ``SPREAD_PIXELS`` from their reference points."""
    return [(f"{name}.weight", (n_out, n_in),
             ("normal", SPREAD_PIXELS * n_in ** -0.5)),
            (f"{name}.bias", (n_out,), ("normal", SPREAD_PIXELS / 2))]


def _layer_norm(name, c):
    return [(f"{name}.weight", (c,), ("const", 1.0)),
            (f"{name}.bias", (c,), ("const", 0.0))]


def _frozen_bn(name, c):
    return [(f"{name}.weight", (c,), ("const", 1.0)),
            (f"{name}.bias", (c,), ("const", 0.0)),
            (f"{name}.running_mean", (c,), ("const", 0.0)),
            (f"{name}.running_var", (c,), ("const", 1.0 - BN_EPS))]


def _conv(name, cout, cin, k, bias=False):
    shape = (cout, cin, k, k)
    out = [(f"{name}.weight", shape, _lecun(shape))]
    if bias:
        out.append((f"{name}.bias", (cout,), ("const", 0.0)))
    return out


def _mha(name, c):
    return ([(f"{name}.in_proj_weight", (3 * c, c), _lecun((3 * c, c))),
             (f"{name}.in_proj_bias", (3 * c,), ("const", 0.0))]
            + _linear(f"{name}.out_proj", c, c))


def _backbone(m):
    rules = _conv("img_backbone.conv1", 64, 3, 7) + _frozen_bn(
        "img_backbone.bn1", 64)
    cin = 64
    for si, (blocks, width) in enumerate(zip(m["backbone_blocks"],
                                             (64, 128, 256, 512))):
        for bi in range(blocks):
            p = f"img_backbone.layer{si + 1}.{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            rules += _conv(f"{p}.conv1", width, cin, 1)
            rules += _frozen_bn(f"{p}.bn1", width)
            rules += _conv(f"{p}.conv2", width, width, 3)
            if DCN_STAGES[si]:
                shape = (27, width, 3, 3)
                rules += [(f"{p}.conv2.conv_offset.weight", shape,
                           ("normal", 0.1 * math.prod(shape[1:]) ** -0.5)),
                          (f"{p}.conv2.conv_offset.bias", (27,),
                           ("normal", SPREAD_PIXELS / 2))]
            rules += _frozen_bn(f"{p}.bn2", width)
            rules += _conv(f"{p}.conv3", 4 * width, width, 1)
            rules += _frozen_bn(f"{p}.bn3", 4 * width)
            if stride != 1 or cin != 4 * width:
                rules += _conv(f"{p}.downsample.0", 4 * width, cin, 1)
                rules += _frozen_bn(f"{p}.downsample.1", 4 * width)
            cin = 4 * width
    return rules


def _neck(c):
    rules = []
    for i, w in enumerate((128, 256, 512)):
        rules += _conv(f"img_neck.lateral_convs.{i}.conv", c, 4 * w, 1, True)
    for i in range(4):
        rules += _conv(f"img_neck.fpn_convs.{i}.conv", c, c, 3, True)
    return rules


def _ffn_norms(p, c):
    return (_linear(f"{p}.ffns.0.layers.0.0", FFN_DIM, c)
            + _linear(f"{p}.ffns.0.layers.1", c, FFN_DIM)
            + sum((_layer_norm(f"{p}.norms.{i}", c) for i in range(3)), []))


def _branch(p, c, n_out, ln):
    rules, i, d = [], 0, c
    for _ in range(2):
        rules += _linear(f"{p}.{i}", BRANCH_DIM, d)
        i += 1
        if ln:
            rules += _layer_norm(f"{p}.{i}", BRANCH_DIM)
            i += 1
        i += 1                                            # the ReLU
        d = BRANCH_DIM
    return rules + _linear(f"{p}.{i}", n_out, BRANCH_DIM)


def _head(m):
    c, h = m["embed_dims"], "pts_bbox_head"
    t = f"{h}.transformer"
    rules = [(f"{h}.bev_embedding.weight", (m["bev_h"] * m["bev_w"], c),
              ("normal", 1.0)),
             (f"{t}.level_embeds", (LEVELS, c), ("normal", 1.0)),
             (f"{t}.cams_embeds", (m["num_cams"], c), ("normal", 1.0))]
    rules += _linear(f"{t}.can_bus_mlp.0", c // 2, CAN_BUS)
    rules += _linear(f"{t}.can_bus_mlp.2", c, c // 2)
    rules += _layer_norm(f"{t}.can_bus_mlp.norm", c)
    n_tsa = HEADS * TSA_POINTS
    n_sca = HEADS * LEVELS * SCA_POINTS
    for i in range(m["encoder_layers"]):
        p = f"{t}.encoder.layers.{i}"
        a = f"{p}.attentions.0"
        rules += (_offsets(f"{a}.sampling_offsets", 2 * n_tsa, 2 * c)
                  + _linear(f"{a}.attention_weights", n_tsa, 2 * c)
                  + _linear(f"{a}.value_proj", c, c)
                  + _linear(f"{a}.output_proj", c, c))
        a = f"{p}.attentions.1"
        rules += (_offsets(f"{a}.deformable_attention.sampling_offsets",
                           2 * n_sca, c)
                  + _linear(f"{a}.deformable_attention.attention_weights",
                            n_sca, c)
                  + _linear(f"{a}.deformable_attention.value_proj", c, c)
                  + _linear(f"{a}.output_proj", c, c))
        rules += _ffn_norms(p, c)
    n_dec = HEADS * DEC_POINTS
    for i in range(m["decoder_layers"]):
        p = f"{t}.decoder.layers.{i}"
        a = f"{p}.attentions.1"
        rules += (_mha(f"{p}.attentions.0.attn", c)
                  + _offsets(f"{a}.sampling_offsets", 2 * n_dec, c)
                  + _linear(f"{a}.attention_weights", n_dec, c)
                  + _linear(f"{a}.value_proj", c, c)
                  + _linear(f"{a}.output_proj", c, c))
        rules += _ffn_norms(p, c)
    for kind, n_out, ln in (("cls_branches", m["num_classes"], True),
                            ("reg_branches", 10, False),
                            ("past_traj_reg_branches", 2 * TRAJ_STEPS,
                             False)):
        for i in range(m["decoder_layers"]):
            rules += _branch(f"{h}.{kind}.{i}", c, n_out, ln)
    return rules


def _tracker(m):
    c = m["embed_dims"]
    rules = [("query_embedding.weight", (m["num_query"], 2 * c),
              ("normal", 1.0))]
    rules += _linear("reference_points", 3, c)
    b = "memory_bank"
    rules += (_linear(f"{b}.save_proj", c, c) + _mha(f"{b}.temporal_attn", c)
              + _linear(f"{b}.temporal_fc1", c, c)
              + _linear(f"{b}.temporal_fc2", c, c)
              + _layer_norm(f"{b}.temporal_norm1", c)
              + _layer_norm(f"{b}.temporal_norm2", c))
    q = "query_interact"
    rules += _mha(f"{q}.self_attn", c)
    for name in ("linear1", "linear2"):
        rules += _linear(f"{q}.{name}", c, c)
    rules += _layer_norm(f"{q}.norm1", c) + _layer_norm(f"{q}.norm2", c)
    rules += (_linear(f"{q}.linear_pos1", c, c)
              + _linear(f"{q}.linear_pos2", c, c)
              + _layer_norm(f"{q}.norm_pos", c))
    rules += (_linear(f"{q}.linear_feat1", c, c)
              + _linear(f"{q}.linear_feat2", c, c)
              + _layer_norm(f"{q}.norm_feat", c))
    return rules


def weight_rules(m: dict) -> list:
    """Every key of the model's state dict in the order the benchmark
    draws them, its shape and its draw (``gpubench.weights``): convolution,
    linear and attention weights LeCun normal, biases 0, LayerNorms and the
    frozen BatchNorms at identity, the embeddings (query, BEV, level,
    camera) standard normal; the deformable attentions' offset layers and
    the DCN offset convolutions spread their taps about ``SPREAD_PIXELS``
    (weights at 3 / sqrt(fan_in), resp. 0.1 / sqrt(fan_in) on the feature
    maps, biases normal at half the spread)."""
    return (_backbone(m) + _neck(m["embed_dims"]) + _head(m)
            + _tracker(m))


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------

def _lin(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def _bn(p, name, x):
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], False, 0.0, BN_EPS)


def _attention(p, name, q, k, v, mask=None):
    """Multi-head dot-product attention, batch first: q (B, N, C), k and
    v (B, M, C); ``mask`` broadcastable to (B, heads, N, M), True where a
    key counts (a row with none attends uniformly, as flax's does)."""
    c = q.shape[-1]
    d = c // HEADS
    w, b = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]

    def heads(x, i):
        y = F.linear(x, w[i * c:(i + 1) * c], b[i * c:(i + 1) * c])
        return y.unflatten(-1, (HEADS, d)).transpose(-3, -2)

    logits = heads(q, 0) @ heads(k, 1).transpose(-1, -2) / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    out = torch.softmax(logits, -1) @ heads(v, 2)
    return _lin(p, f"{name}.out_proj", out.transpose(-3, -2).flatten(-2))


def _ffn(p, name, x):
    h = F.relu(_lin(p, f"{name}.layers.0.0", x))
    return x + _lin(p, f"{name}.layers.1", h)


def _same_pad(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _dcn(p, name, x, stride):
    """Modulated deformable 3x3 convolution (DCNv2): a convolution at
    ``SAME`` padding predicts each output pixel's 9 (dy, dx) offsets,
    interleaved, and 9 mask logits; tap t of output pixel (i, j) reads the
    input at (i s + t // 3 - 1 + dy_t, j s + t % 3 - 1 + dx_t), zero
    outside, times its sigmoid mask; then the 3x3 kernel."""
    n, cin, h, w = x.shape
    (t0, t1), (l0, l1) = _same_pad(h, 3, stride), _same_pad(w, 3, stride)
    om = F.conv2d(F.pad(x, (l0, l1, t0, t1)), p[f"{name}.conv_offset.weight"],
                  p[f"{name}.conv_offset.bias"], stride)
    ho, wo = om.shape[2:]
    tap = torch.arange(9, device=x.device)
    ky = (tap // 3 - 1).to(x.dtype)
    kx = (tap % 3 - 1).to(x.dtype)
    iy = torch.arange(ho, device=x.device, dtype=x.dtype) * stride
    ix = torch.arange(wo, device=x.device, dtype=x.dtype) * stride
    ys = iy[None, :, None, None] + ky[None, None, None, :] + (
        om[:, 0:18:2].permute(0, 2, 3, 1))                 # n, ho, wo, 9
    xs = ix[None, None, :, None] + kx[None, None, None, :] + (
        om[:, 1:18:2].permute(0, 2, 3, 1))
    coords = torch.stack([xs, ys], 1).reshape(n, 2, ho * wo, 9)
    taps = sample(x, coords, "zero_pad")                   # n, cin, P, 9
    mask = torch.sigmoid(om[:, 18:27]).flatten(2).transpose(1, 2)  # n, P, 9
    weight = p[f"{name}.weight"].reshape(-1, cin, 9)
    out = torch.einsum("ncpt,npt,oct->nop", taps, mask, weight)
    return out.reshape(n, -1, ho, wo)


def _backbone_forward(p, m, x):
    x = F.relu(_bn(p, "img_backbone.bn1",
                   F.conv2d(x, p["img_backbone.conv1.weight"], None, 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = []
    for si, blocks in enumerate(m["backbone_blocks"]):
        for bi in range(blocks):
            q = f"img_backbone.layer{si + 1}.{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            # Caffe style: the first 1x1 convolution takes the stride.
            h = F.relu(_bn(p, f"{q}.bn1", F.conv2d(
                x, p[f"{q}.conv1.weight"], None, stride)))
            if DCN_STAGES[si]:
                h = _dcn(p, f"{q}.conv2", h, 1)
            else:
                h = F.conv2d(h, p[f"{q}.conv2.weight"], None, 1, 1)
            h = F.relu(_bn(p, f"{q}.bn2", h))
            h = _bn(p, f"{q}.bn3", F.conv2d(h, p[f"{q}.conv3.weight"]))
            if f"{q}.downsample.0.weight" in p:
                x = _bn(p, f"{q}.downsample.1", F.conv2d(
                    x, p[f"{q}.downsample.0.weight"], None, stride))
            x = F.relu(x + h)
        feats.append(x)
    return feats


def _nearest(x, size):
    """Nearest resize at half-pixel centres (the source pixel of target i
    is floor((i + 1/2) in / out))."""
    rows = ((torch.arange(size[0], device=x.device) + 0.5)
            * x.shape[2] / size[0]).floor().long()
    cols = ((torch.arange(size[1], device=x.device) + 0.5)
            * x.shape[3] / size[1]).floor().long()
    return x[:, :, rows][:, :, :, cols]


def _neck_forward(p, feats):
    lat = [F.conv2d(f, p[f"img_neck.lateral_convs.{i}.conv.weight"],
                    p[f"img_neck.lateral_convs.{i}.conv.bias"])
           for i, f in enumerate(feats[1:])]
    lat[1] = lat[1] + _nearest(lat[2], lat[1].shape[2:])
    lat[0] = lat[0] + _nearest(lat[1], lat[0].shape[2:])

    def fpn(i, x, stride=1):
        return F.conv2d(x, p[f"img_neck.fpn_convs.{i}.conv.weight"],
                        p[f"img_neck.fpn_convs.{i}.conv.bias"], stride, 1)
    outs = [fpn(i, lat[i]) for i in range(3)]
    return outs + [fpn(3, F.relu(outs[2]), 2)]


def _deformable(value, shapes, loc, weights):
    """Multi-scale deformable attention (mmcv's
    ``multi_scale_deformable_attn_pytorch``): value (B, keys, heads, d),
    the levels' keys in order; loc (B, nq, heads, L, P, 2) normalised;
    weights (B, nq, heads, L, P). A normalised location l reads pixel
    l (w, h) - 1/2, zero outside the level. Returns (B, nq, heads d)."""
    b, _, nh, d = value.shape
    nq, n_pts = loc.shape[1], loc.shape[4]
    taps, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
            b * nh, d, h, w)
        start += h * w
        scale = torch.tensor([w, h], dtype=loc.dtype, device=loc.device)
        px = (loc[:, :, :, lvl] * scale - 0.5).permute(0, 2, 4, 1, 3)
        taps.append(sample(v, px.reshape(b * nh, 2, nq, n_pts),
                           "zero_pad"))                   # bh, d, nq, P
    taps = torch.cat(taps, -1)                            # bh, d, nq, L P
    wgt = weights.permute(0, 2, 1, 3, 4).reshape(b * nh, 1, nq, -1)
    out = (taps * wgt).sum(-1)                            # bh, d, nq
    return out.reshape(b, nh * d, nq).transpose(1, 2)


def _offsets_weights(p, name, q, levels, points):
    b, nq = q.shape[:2]
    off = _lin(p, f"{name}.sampling_offsets", q).reshape(
        b, nq, HEADS, levels, points, 2)
    w = torch.softmax(_lin(p, f"{name}.attention_weights", q).reshape(
        b, nq, HEADS, levels * points), -1)
    return off, w.reshape(b, nq, HEADS, levels, points)


def _level_scale(shapes, like):
    return torch.tensor([[w, h] for h, w in shapes], dtype=like.dtype,
                        device=like.device)


def _temporal_self_attention(p, name, bev, prev, ref_2d, bev_shape, pos):
    """The current BEV attends to the stacked [previous, current] BEV: one
    branch a value, each branch's offsets and weights from [that value,
    query], the two outputs averaged; output projection and residual."""
    b, nq, c = bev.shape
    q = bev + pos
    values = torch.cat([prev, bev], 0)
    q2 = torch.cat([torch.cat([prev, q], -1), torch.cat([bev, q], -1)], 0)
    off, w = _offsets_weights(p, name, q2, 1, TSA_POINTS)
    v = _lin(p, f"{name}.value_proj", values).reshape(2 * b, nq, HEADS, -1)
    loc = (ref_2d.repeat(2, 1, 1, 1)[:, :, None, None]
           + off / _level_scale(bev_shape, off)[:, None])
    out = _deformable(v, bev_shape, loc, w)
    out = 0.5 * (out[:b] + out[b:])
    return _lin(p, f"{name}.output_proj", out) + bev


def _spatial_cross_attention(p, name, bev, value, ref_cam, seen_d, shapes,
                             pos):
    """Each camera's levels sampled around the query's pillar points
    projected into it; the P points spread over the D pillar points; the
    cameras that see the query averaged; output projection and residual.
    value (cams, B, keys, C); ref_cam (cams, B, nq, D, 2); seen_d (cams,
    B, nq, D)."""
    cams, b = value.shape[:2]
    nq, c = bev.shape[1:]
    d = ref_cam.shape[3]
    inner = f"{name}.deformable_attention"
    off, w = _offsets_weights(p, inner, bev + pos, LEVELS, SCA_POINTS)
    off = off / _level_scale(shapes, off)[:, None]
    off = off.reshape(b, nq, HEADS, LEVELS, d, SCA_POINTS // d, 2)
    outs = []
    for cam in range(cams):
        v = _lin(p, f"{inner}.value_proj", value[cam]).reshape(
            b, -1, HEADS, c // HEADS)
        loc = (ref_cam[cam][:, :, None, None, :, None, :] + off).reshape(
            b, nq, HEADS, LEVELS, SCA_POINTS, 2)
        outs.append(_deformable(v, shapes, loc, w))
    seen = seen_d.any(-1)                                 # cams, B, nq
    slots = (torch.stack(outs) * seen[..., None]).sum(0)
    slots = slots / seen.sum(0).clamp(min=1)[..., None].to(slots.dtype)
    return _lin(p, f"{name}.output_proj", slots) + bev


def _decoder_deformable(p, name, query, bev, ref_xy, bev_shape, pos):
    b, nq, c = query.shape
    off, w = _offsets_weights(p, name, query + pos, 1, DEC_POINTS)
    v = _lin(p, f"{name}.value_proj", bev).reshape(b, -1, HEADS, c // HEADS)
    loc = (ref_xy[:, :, None, None, None, :]
           + off / _level_scale(bev_shape, off)[:, None])
    out = _deformable(v, bev_shape, loc, w)
    return _lin(p, f"{name}.output_proj", out) + query


def _inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def _sine_embedding(pos, n):
    """(..., 2) normalised (x, y) -> (..., 2 n): the y embedding, then the
    x one, each sin and cos of 2 pi pos / 10000^(2 floor(i / 2) / n),
    interleaved."""
    k = torch.arange(n, device=pos.device, dtype=pos.dtype)
    freq = 10000.0 ** (2.0 * torch.div(k, 2, rounding_mode="floor") / n)
    parts = []
    for axis in (1, 0):
        a = pos[..., axis:axis + 1] * (2.0 * math.pi) / freq
        parts.append(torch.stack([a[..., 0::2].sin(), a[..., 1::2].cos()],
                                 -1).flatten(-2))
    return torch.cat(parts, -1)


def _centres(n, device, dtype):
    return (torch.arange(n, device=device, dtype=dtype) + 0.5) / n


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Tracks:
    """One slot a query; ``obj_idxes`` -1 on a free slot."""
    ref_pts: torch.Tensor
    query: torch.Tensor
    output_embedding: torch.Tensor
    obj_idxes: torch.Tensor
    scores: torch.Tensor
    track_scores: torch.Tensor
    pred_logits: torch.Tensor
    pred_boxes: torch.Tensor
    disappear_time: torch.Tensor
    mem_bank: torch.Tensor
    mem_valid: torch.Tensor
    save_period: torch.Tensor


@dataclasses.dataclass
class State:
    """What one frame hands the next."""
    prev_bev: torch.Tensor
    tracks: Tracks
    next_obj_id: torch.Tensor
    timestamp: torch.Tensor
    has_prev: torch.Tensor


def denormalize_bbox(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, log w, log l, cz, log h, sin, cos, vx, vy) -> (cx, cy, cz,
    w, l, h, yaw, vx, vy)."""
    return torch.cat([b[..., 0:2], b[..., 4:5], b[..., 2:4].exp(),
                      b[..., 5:6].exp(),
                      torch.atan2(b[..., 6:7], b[..., 7:8]), b[..., 8:10]],
                     -1)


class Reference:
    """The model's configuration (the configuration file's ``model``) and
    its weights (the flat state dict)."""

    def __init__(self, m: dict, params: dict):
        self.m, self.p = m, params
        self.c = m["embed_dims"]
        self.dtype = params["query_embedding.weight"].dtype

    # The query slots' learned start: the query and its reference point.
    def _fresh(self):
        q = self.p["query_embedding.weight"]
        return q, torch.sigmoid(_lin(self.p, "reference_points",
                                     q[:, :self.c]))

    def init_state(self) -> State:
        m, c = self.m, self.c
        q, ref = self._fresh()
        n, dev = q.shape[0], q.device

        def z(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        tracks = Tracks(
            ref_pts=ref, query=q, output_embedding=z(n, c),
            obj_idxes=torch.full((n,), -1, dtype=torch.int32, device=dev),
            scores=z(n), track_scores=z(n),
            pred_logits=z(n, m["num_classes"]), pred_boxes=z(n, 10),
            disappear_time=z(n, dtype=torch.int32),
            mem_bank=z(n, m["mem_len"], c),
            mem_valid=z(n, m["mem_len"], dtype=torch.bool),
            save_period=z(n, dtype=torch.int32))
        return State(prev_bev=z(1, m["bev_h"] * m["bev_w"], c),
                     tracks=tracks,
                     next_obj_id=torch.zeros((), dtype=torch.int32,
                                             device=dev),
                     timestamp=z(), has_prev=torch.zeros(
                         (), dtype=torch.bool, device=dev))

    # -- the BEV -------------------------------------------------------

    def _shift(self, prev, delta_xy, rotation_deg):
        """The previous BEV (B, h w, C) rotated by ``rotation_deg`` about
        the grid's centre, then moved by ``delta_xy`` grid fractions: each
        cell reads the previous BEV there, bilinearly, zero outside."""
        m = self.m
        bh, bw = m["bev_h"], m["bev_w"]
        b, _, c = prev.shape
        dev = prev.device
        dt = self.dtype
        y, x = torch.meshgrid(torch.arange(bh, device=dev, dtype=dt),
                              torch.arange(bw, device=dev, dtype=dt),
                              indexing="ij")
        x, y = x[None] - (bw - 1) / 2.0, y[None] - (bh - 1) / 2.0
        a = (rotation_deg.to(dt) * (math.pi / 180.0)).reshape(b, 1, 1)
        xs = torch.cos(a) * x - torch.sin(a) * y + (bw - 1) / 2.0
        ys = torch.sin(a) * x + torch.cos(a) * y + (bh - 1) / 2.0
        d = delta_xy.to(dt).reshape(b, 2, 1, 1)
        coords = torch.stack([xs, ys], 1) + d * torch.tensor(
            [bw, bh], dtype=dt, device=dev).reshape(1, 2, 1, 1)
        plane = prev.reshape(b, bh, bw, c).permute(0, 3, 1, 2)
        out = sample(plane, coords, "zero_pad")
        return out.permute(0, 2, 3, 1).reshape(b, bh * bw, c)

    def _pillars_in_cams(self, lidar2img, img_h, img_w, dev):
        """Pillar points over the BEV grid (``PILLAR_POINTS`` heights a
        cell) in each camera's normalised image coordinates (cams, B, nq,
        D, 2), and whether each lies in front of the camera and inside its
        image (cams, B, nq, D)."""
        m = self.m
        x0, y0, z0, x1, y1, z1 = m["pc_range"]
        bh, bw = m["bev_h"], m["bev_w"]
        dt = self.dtype
        gy, gx = torch.meshgrid(_centres(bh, dev, dt), _centres(bw, dev, dt),
                                indexing="ij")
        zs = _centres(PILLAR_POINTS, dev, dt)
        n = bh * bw
        pts = torch.stack([
            (x0 + gx.reshape(-1) * (x1 - x0)).expand(PILLAR_POINTS, n),
            (y0 + gy.reshape(-1) * (y1 - y0)).expand(PILLAR_POINTS, n),
            (z0 + zs * (z1 - z0))[:, None].expand(PILLAR_POINTS, n),
            torch.ones(PILLAR_POINTS, n, device=dev, dtype=dt)], -1)
        cam = torch.einsum("bcij,dnj->cbndi", lidar2img.to(dt), pts)
        depth = cam[..., 2]
        uv = cam[..., :2] / depth.clamp(min=1e-5)[..., None]
        uv = uv / torch.tensor([img_w, img_h], dtype=dt,
                               device=dev)
        seen = ((depth > 1e-5) & (uv[..., 0] > 0) & (uv[..., 0] < 1)
                & (uv[..., 1] > 0) & (uv[..., 1] < 1))
        return uv, seen

    def bev(self, images, lidar2img, prev, ego_shift, ego_rotation_deg):
        """images (cams, B, 3, H, W) -> the BEV (B, bev_h bev_w, C)."""
        p, m, c = self.p, self.m, self.c
        cams, b, _, img_h, img_w = images.shape
        dev = images.device
        feats = _neck_forward(p, _backbone_forward(
            p, m, images.flatten(0, 1).to(self.dtype)))
        shapes = [tuple(f.shape[2:]) for f in feats]
        t = "pts_bbox_head.transformer"
        value = torch.cat([
            f.reshape(cams, b, c, -1).transpose(2, 3)
            + p[f"{t}.cams_embeds"][:, None, None, :]
            + p[f"{t}.level_embeds"][lvl] for lvl, f in enumerate(feats)],
            2)                                            # cams, B, keys, C
        bh, bw = m["bev_h"], m["bev_w"]
        can_bus = torch.zeros(CAN_BUS, device=dev, dtype=self.dtype)
        cb = F.relu(_lin(p, f"{t}.can_bus_mlp.0", can_bus))
        cb = _ln(p, f"{t}.can_bus_mlp.norm",
                 F.relu(_lin(p, f"{t}.can_bus_mlp.2", cb)))
        bev = p["pts_bbox_head.bev_embedding.weight"][None].expand(
            b, -1, -1) + cb
        gy, gx = torch.meshgrid(_centres(bh, dev, self.dtype),
                                _centres(bw, dev, self.dtype), indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(1, bh * bw, 2)
        pos = _sine_embedding(grid, c // 2)
        ref_2d = grid[:, :, None, :].expand(b, -1, -1, -1)
        if ego_shift is not None:
            rot = (ego_rotation_deg if ego_rotation_deg is not None
                   else torch.zeros(b, device=dev))
            prev = self._shift(prev, ego_shift, rot)
        uv, seen = self._pillars_in_cams(lidar2img, img_h, img_w, dev)
        bev_shape = [(bh, bw)]
        for i in range(m["encoder_layers"]):
            q = f"{t}.encoder.layers.{i}"
            bev = _ln(p, f"{q}.norms.0", _temporal_self_attention(
                p, f"{q}.attentions.0", bev, prev, ref_2d, bev_shape, pos))
            bev = _ln(p, f"{q}.norms.1", _spatial_cross_attention(
                p, f"{q}.attentions.1", bev, value, uv, seen, shapes, pos))
            bev = _ln(p, f"{q}.norms.2", _ffn(p, f"{q}.ffns.0", bev))
        return bev

    # -- the decoder -----------------------------------------------------

    def _branch(self, kind, layer, x):
        """A decoder layer's head: (linear, [LayerNorm,] ReLU) twice, then
        a linear; the classification head has the LayerNorms."""
        name = f"pts_bbox_head.{kind}.{layer}"
        i = 0
        for _ in range(2):
            x = _lin(self.p, f"{name}.{i}", x)
            i += 1
            if kind == "cls_branches":
                x = _ln(self.p, f"{name}.{i}", x)
                i += 1
            x = F.relu(x)
            i += 1
        return _lin(self.p, f"{name}.{i}", x)

    def detect(self, bev, query, ref):
        """The decoder over query (nq, 2C) = [position | feature] with
        reference points ref (nq, 3) in sigmoid space: the last layer's
        logits, boxes (cx, cy, log w, log l, cz, log h, sin, cos, vx, vy),
        output embedding and refined reference points."""
        p, m, c = self.p, self.m, self.c
        x0, y0, z0, x1, y1, z1 = m["pc_range"]
        pos, x = query[None, :, :c], query[None, :, c:]
        ref = ref[None]
        bev_shape = [(m["bev_h"], m["bev_w"])]
        t = "pts_bbox_head.transformer.decoder.layers"
        for i in range(m["decoder_layers"]):
            q = f"{t}.{i}"
            qk = x + pos
            x = _ln(p, f"{q}.norms.0",
                    x + _attention(p, f"{q}.attentions.0.attn", qk, qk, x))
            x = _ln(p, f"{q}.norms.1", _decoder_deformable(
                p, f"{q}.attentions.1", x, bev, ref[..., :2], bev_shape,
                pos))
            x = _ln(p, f"{q}.norms.2", _ffn(p, f"{q}.ffns.0", x))
            reg = self._branch("reg_branches", i, x)
            inv = _inverse_sigmoid(ref)
            ref = torch.cat([torch.sigmoid(reg[..., 0:2] + inv[..., 0:2]),
                             torch.sigmoid(reg[..., 4:5] + inv[..., 2:3])], -1)
        logits = self._branch("cls_branches", m["decoder_layers"] - 1, x)
        # The boxes refine the reference points the last layer started
        # from (``inv``), in sigmoid space, then scale to the point-cloud
        # range.
        boxes = torch.cat([
            torch.sigmoid(reg[..., 0:1] + inv[..., 0:1]) * (x1 - x0) + x0,
            torch.sigmoid(reg[..., 1:2] + inv[..., 1:2]) * (y1 - y0) + y0,
            reg[..., 2:4],
            torch.sigmoid(reg[..., 4:5] + inv[..., 2:3]) * (z1 - z0) + z0,
            reg[..., 5:10]], -1)
        return logits[0], boxes[0], x[0], ref[0]

    # -- the tracker -----------------------------------------------------

    def _memory(self, tr: Tracks) -> Tracks:
        """Fuse each slot's saved history into its embedding (slots whose
        newest entry is valid), then push the fused embedding, projected,
        where the slot scores and its cooldown has run out."""
        p, b = self.p, "memory_bank"
        emb, bank, valid = tr.output_embedding, tr.mem_bank, tr.mem_valid
        att = _attention(p, f"{b}.temporal_attn", emb[:, None], bank, bank,
                         valid[:, None, None, :])[:, 0]
        fused = _ln(p, f"{b}.temporal_norm1", emb + att)
        ff = _lin(p, f"{b}.temporal_fc2",
                  F.relu(_lin(p, f"{b}.temporal_fc1", fused)))
        fused = _ln(p, f"{b}.temporal_norm2", fused + ff)
        fused = torch.where(valid[:, -1:], fused, emb)
        save = (tr.save_period == 0) & (tr.scores > 0.0)
        period = torch.where(save, torch.full_like(tr.save_period,
                                                   SAVE_PERIOD),
                             (tr.save_period - 1).clamp(min=0))
        pushed = torch.cat([bank[:, 1:],
                            _lin(p, f"{b}.save_proj", fused)[:, None]], 1)
        pushed_valid = torch.cat([valid[:, 1:],
                                  torch.ones_like(valid[:, :1])], 1)
        return dataclasses.replace(
            tr, output_embedding=fused,
            mem_bank=torch.where(save[:, None, None], pushed, bank),
            mem_valid=torch.where(save[:, None], pushed_valid, valid),
            save_period=period)

    def _interact(self, tr: Tracks) -> Tracks:
        """MOTR's query interaction on the assigned slots: attention among
        them (q = k = position + embedding, v = embedding), an FFN, then
        FFNs that update both halves of each assigned slot's query."""
        p, q, c = self.p, "query_interact", self.c
        live = tr.obj_idxes >= 0
        emb = tr.output_embedding
        pos, feat = tr.query[:, :c], tr.query[:, c:]
        qk = (pos + emb)[None]
        att = _attention(p, f"{q}.self_attn", qk, qk, emb[None],
                         live[None, None, None, :])[0]
        tgt = _ln(p, f"{q}.norm1", emb + att)
        tgt = _ln(p, f"{q}.norm2", tgt + _lin(p, f"{q}.linear2", F.relu(
            _lin(p, f"{q}.linear1", tgt))))

        def update(half, kind, norm):
            d = _lin(p, f"{q}.linear_{kind}2",
                     F.relu(_lin(p, f"{q}.linear_{kind}1", tgt)))
            return torch.where(live[:, None], _ln(p, f"{q}.{norm}",
                                                  half + d), half)
        return dataclasses.replace(tr, query=torch.cat(
            [update(pos, "pos", "norm_pos"),
             update(feat, "feat", "norm_feat")], -1))

    def _lifecycle(self, tr: Tracks, next_id):
        """Deaths after ``miss_tolerance`` frames in a row under
        ``filter_score_thresh``; births of free slots at ``score_thresh``
        or above, numbered in slot order."""
        m = self.m
        s = tr.track_scores
        assigned = tr.obj_idxes >= 0
        gone = torch.where(assigned & (s < m["filter_score_thresh"]),
                           tr.disappear_time + 1,
                           torch.zeros_like(tr.disappear_time))
        dead = gone >= m["miss_tolerance"]
        ids = torch.where(dead, torch.full_like(tr.obj_idxes, -1),
                          tr.obj_idxes)
        gone = torch.where(dead, torch.zeros_like(gone), gone)
        born = ~assigned & (s >= m["score_thresh"])
        rank = torch.cumsum(born.int(), 0) - 1
        ids = torch.where(born, (next_id + rank).int(), ids)
        return (dataclasses.replace(tr, obj_idxes=ids.int(),
                                    disappear_time=gone.int()),
                (next_id + born.sum()).int())

    def frame(self, images, lidar2img, state: State, timestamp,
              ego_shift=None, ego_rotation_deg=None):
        """One inference frame: (the state handed on, the detections)."""
        m, c = self.m, self.c
        x0, y0, _, x1, y1, _ = m["pc_range"]
        tr = state.tracks
        ts = torch.as_tensor(timestamp, dtype=state.timestamp.dtype,
                             device=state.timestamp.device)
        dt = torch.where(state.has_prev, ts - state.timestamp,
                         torch.zeros_like(ts))
        live = tr.obj_idxes >= 0
        # Live slots' reference points move with their boxes' velocity.
        wx = tr.ref_pts[:, 0] * (x1 - x0) + x0 + tr.pred_boxes[:, 8] * dt
        wy = tr.ref_pts[:, 1] * (y1 - y0) + y0 + tr.pred_boxes[:, 9] * dt
        moved = torch.stack([(wx - x0) / (x1 - x0), (wy - y0) / (y1 - y0),
                             tr.ref_pts[:, 2]], -1)
        prev = state.prev_bev * state.has_prev.to(self.dtype)
        bev = self.bev(images, lidar2img, prev, ego_shift, ego_rotation_deg)
        fresh_q, fresh_ref = self._fresh()
        query = torch.where(live[:, None], tr.query, fresh_q)
        ref = torch.where(live[:, None], moved, fresh_ref)
        logits, boxes, emb, new_ref = self.detect(bev, query, ref)
        scores = torch.sigmoid(logits).amax(-1)
        tr = dataclasses.replace(
            tr, query=torch.cat([query[:, :c], emb], -1), ref_pts=new_ref,
            output_embedding=emb, scores=scores, track_scores=scores,
            pred_logits=logits, pred_boxes=boxes)
        tr, next_id = self._lifecycle(tr, state.next_obj_id)
        tr = self._interact(self._memory(tr))
        k = min(MAX_DETS, scores.shape[0])
        top, idx = torch.sort(scores, descending=True, stable=True)
        idx = idx[:k]
        results = {"bboxes": denormalize_bbox(boxes[idx]), "scores": top[:k],
                   "labels": logits[idx].argmax(-1), "query_idx": idx,
                   "obj_idxes": tr.obj_idxes[idx]}
        return (State(prev_bev=bev, tracks=tr, next_obj_id=next_id,
                      timestamp=ts, has_prev=torch.ones_like(
                          state.has_prev)), results)


def build(model_cfg: dict, params: dict) -> Reference:
    return Reference(model_cfg, params)


def state_from(other, dtype=None) -> State:
    """A reference :class:`State` holding the tensors of another side's
    state (the port's), its floating ones in ``dtype`` where given, to
    follow it from a given frame."""
    def cast(t):
        if dtype is not None and t.is_floating_point():
            return t.to(dtype)
        return t
    tracks = Tracks(**{f: cast(getattr(other.tracks, f))
                       for f in Tracks.__dataclass_fields__})
    return State(prev_bev=cast(other.prev_bev), tracks=tracks,
                 next_obj_id=other.next_obj_id,
                 timestamp=cast(other.timestamp), has_prev=other.has_prev)


@torch.no_grad()
def frame(model: Reference, images, lidar2img, state: State, timestamp,
          ego_shift, ego_rotation_deg):
    """One inference frame: (the state handed on, the detections)."""
    return model.frame(images, lidar2img, state, timestamp, ego_shift,
                       ego_rotation_deg)
