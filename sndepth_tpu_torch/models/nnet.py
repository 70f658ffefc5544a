"""NNET: depth <-> normal mutual refinement.

Counterpart of ``sndepth_tpu/models/nnet.py`` (reference `NNET.forward`,
`models/baseline.py:274-583`): an EfficientNet-B5 encoder and the
uncertainty decoder give an initial normal map; a least-squares D2N module
turns depth into normals, an N2D module normals into depth, and a
Canny-edge-guided propagation refines both. Public functions keep the JAX
package's channel-last layout; the convolution stacks run NCHW inside.

The JAX package's documented divergences from the reference hold here too:
patches are taken over the spatial axes, the edge propagation really
iterates, and there is no fixed batch size.

Module names of the refiner (``refiner.noise_enc1.{0,2}``,
``noise_enc2``, ``norm_fusion``, ``depth_fusion``, ``edge_encoder``,
``edge_weight``, a convolution at every even index) follow the JAX
``_ConvStack`` names; the encoder's and the decoder's are the reference's
(:mod:`~sndepth_tpu_torch.models.efficientnet`,
:mod:`~sndepth_tpu_torch.models.normal_decoder`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.models.efficientnet import (BlockSpec,
                                                   EfficientNetEncoder,
                                                   same_pad)
from sndepth_tpu_torch.models.normal_decoder import NormalDecoder
from sndepth_tpu_torch.ops.edges import propagate
from sndepth_tpu_torch.ops.patches import extract_patches_tap_last

# ImageNet BGR mean the reference adds during preprocessing
# (`baseline.py:128,263-272`).
MEAN_BGR = (104.008, 116.669, 122.675)

K = 9          # patch size (`baseline.py:133`)
RATE = 4       # patch dilation (`baseline.py:134`)
THRESH = 0.95  # normal-agreement validity threshold (`baseline.py:135`)


def bgr_preprocess(rgb: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in the training-value range -> BGR + ImageNet mean
    (`baseline.py:263-272`)."""
    mean = torch.tensor(MEAN_BGR, dtype=rgb.dtype, device=rgb.device)
    return rgb.flip(-1) + mean


def _linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """``jnp.linspace`` in float32, as it computes it: start (1 - s) +
    stop s with s = i / (n - 1), and the last point exactly ``stop``."""
    if n == 1:
        return torch.full((1,), start, device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, device=device)])


def camera_grid(batch: int, height: int, width: int,
                device=None) -> torch.Tensor:
    """Normalised camera-ray grid (B, H, W, 3): x in [-0.6, 0.6], y in
    [-0.4, 0.4], z = 1 (`baseline.py:308-316`)."""
    x = _linspace(-0.6, 0.6, width, device)
    y = _linspace(-0.4, 0.4, height, device)
    xg = x[None, :].expand(height, width)
    yg = y[:, None].expand(height, width)
    grid = torch.stack([xg, yg, torch.ones_like(xg)], -1)
    return grid[None].expand(batch, height, width, 3)


def _solve3x3(ata: torch.Tensor, atb: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 solve by cofactors, (..., 3, 3) and
    (..., 3, 1) -> (..., 3, 1). Systems with det <= 1e-5 fall back to the
    identity system (x = b), as the reference does (`baseline.py:416-433`).
    """
    b = atb[..., 0]

    def m(i, j):
        return ata[..., i, j]

    c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)
    c01 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)
    c02 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)
    c10 = m(0, 2) * m(2, 1) - m(0, 1) * m(2, 2)
    c11 = m(0, 0) * m(2, 2) - m(0, 2) * m(2, 0)
    c12 = m(0, 1) * m(2, 0) - m(0, 0) * m(2, 1)
    c20 = m(0, 1) * m(1, 2) - m(0, 2) * m(1, 1)
    c21 = m(0, 2) * m(1, 0) - m(0, 0) * m(1, 2)
    c22 = m(0, 0) * m(1, 1) - m(0, 1) * m(1, 0)
    det = m(0, 0) * c00 + m(0, 1) * c01 + m(0, 2) * c02

    # x = adj(A) b / det; adj[i, j] = C[j, i].
    x = torch.stack([
        c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2],
        c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2],
        c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2],
    ], -1)
    ok = det > 1e-5
    safe = torch.where(ok, det, torch.ones_like(det))
    x = torch.where(ok[..., None], x / safe[..., None], b)
    return x[..., None]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def normal_equations(pre_norm: torch.Tensor, points: torch.Tensor
                     ) -> tuple[torch.Tensor, ...]:
    """D2N's least-squares system over k = 9, dilation 4 neighbourhoods:
    the taps whose normal agrees with the pixel's past ``THRESH`` give
    A^T A (B, H, W, 3, 3) and A^T 1 (B, H, W, 3, 1). Also returns the
    agreement (B, H, W, 81) and the point patches (B, H, W, 3, 81)."""
    norm_patches = extract_patches_tap_last(pre_norm, K, RATE)
    angle = torch.einsum("bhwct,bhwc->bhwt", norm_patches, pre_norm)
    valid = (angle > THRESH)[:, :, :, None, :]
    point_patches = extract_patches_tap_last(points, K, RATE)
    a = torch.where(valid, point_patches, torch.zeros_like(point_patches))
    ata = torch.einsum("bhwit,bhwjt->bhwij", a, a)
    atb = a.sum(-1)[..., None]
    return ata, atb, angle, point_patches


def d2n_least_squares(pre_norm: torch.Tensor, points: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth -> normal least-squares fit (`baseline.py:350-446`).

    pre_norm: (B, H, W, 3) unit normals; points: (B, H, W, 3) 3-D points.
    Returns (normals x 10, angle (B, H, W, 81), point patches (B, H, W, 3,
    81)). Where few taps agree the system is nearly singular and its
    float32 solve follows the last bits of its sums: two evaluations that
    sum in another order (CPU and card, or XLA) part there."""
    ata, atb, angle, point_patches = normal_equations(pre_norm, points)
    n = _solve3x3(ata, atb)[..., 0]
    return _unit(n) * 10.0, angle, point_patches


def n2d_depth(pre_norm: torch.Tensor, grid: torch.Tensor,
              angle: torch.Tensor, point_patches: torch.Tensor
              ) -> torch.Tensor:
    """Normal -> depth re-estimation (`baseline.py:495-524`); (B, H, W, 1)
    clamped to [0, 10]."""
    norm_patches = extract_patches_tap_last(pre_norm, K, RATE)
    grid_patches = extract_patches_tap_last(grid, K, RATE)
    depth_taps = point_patches[:, :, :, 2, :]
    lower_m = torch.einsum("bhwct,bhwc->bhwt", norm_patches, grid)
    cond = lower_m > 1e-5
    one = torch.ones_like(lower_m)
    lower = torch.where(cond, 1.0 / torch.where(cond, lower_m, one), one)
    valid_angle = torch.where(cond, angle, torch.zeros_like(angle))
    upper = (norm_patches * grid_patches).sum(3)
    est_depth = lower * upper * depth_taps
    weight = valid_angle / (valid_angle.sum(-1, keepdim=True) + 1e-5)
    depth = (est_depth * weight).sum(-1)
    return depth.clamp(0.0, 10.0)[..., None]


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) by ``jax.image.resize(...,
    "nearest")``: half-pixel centres, source index floor((i + 0.5) n / m)
    in float32 (torch's ``"nearest-exact"``, not ``"nearest"``)."""
    def index(n_in, n_out):
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor((i + 0.5) * n_in / n_out).long()
    return x.index_select(2, index(x.shape[2], h)).index_select(
        3, index(x.shape[3], w))


class ConvStack(nn.Sequential):
    """A run of "SAME" stride-1 convolutions given as (in, out, kernel,
    dilation, relu) rows, each followed by a ReLU where asked; the
    convolutions sit at even indices."""

    def __init__(self, plan: Sequence[tuple], dtype: torch.dtype):
        layers = []
        for c_in, c_out, k, dil, relu in plan:
            layers.append(nn.Conv2d(c_in, c_out, k, dilation=dil,
                                    padding=(k - 1) * dil // 2))
            layers.append(nn.ReLU() if relu else nn.Identity())
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        layers = list(self)
        for conv, act in zip(layers[0::2], layers[1::2]):
            h = act(F.conv2d(h, conv.weight.to(self.dtype),
                             conv.bias.to(self.dtype), 1, conv.padding,
                             conv.dilation))
        return h


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class NNETRefiner(nn.Module):
    """The D2N noise and fusion CNNs, the N2D fusion CNN, the edge-weight
    CNN and the propagation (`baseline.py:137-203`)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 propagation_rounds: int = 4):
        super().__init__()
        self.dtype = dtype
        self.propagation_rounds = propagation_rounds
        self.noise_enc1 = ConvStack(((3, 64, 3, 1, True),
                                     (64, 64, 3, 1, True)), dtype)
        self.noise_enc2 = ConvStack(
            ((64, 128, 3, 1, True), (128, 128, 3, 1, True),
             (128, 256, 3, 1, True), (256, 256, 3, 1, True),
             (256, 512, 1, 1, True), (512, 3, 3, 1, False)), dtype)
        self.norm_fusion = ConvStack(
            ((9, 128, 3, 2, True), (128, 128, 3, 2, True),
             (128, 128, 3, 1, True), (128, 128, 3, 1, True),
             (128, 3, 3, 1, False)), dtype)
        self.depth_fusion = ConvStack(
            ((5, 128, 3, 2, True),) + ((128, 128, 3, 2, True),) * 5
            + ((128, 1, 3, 1, False),), dtype)
        self.edge_encoder = ConvStack(
            ((4, 32, 3, 2, False),) + ((32, 32, 3, 2, False),) * 2
            + ((32, 32, 3, 1, False),) * 3, dtype)
        self.edge_weight = ConvStack(((32, 8, 3, 1, False),), dtype)

    def forward(self, pre_depth_log2: torch.Tensor,
                rgb_model_input: torch.Tensor, init_norm: torch.Tensor,
                edge_inputs: torch.Tensor, canny: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """pre_depth_log2 (B, H, W) log2-depth; rgb_model_input (B, H, W, 3)
        BGR + mean; init_norm (B, H, W, 3) decoder normals; edge_inputs
        (B, H, W, 4); canny (B, H, W, 1). Returns the normals (B, H, W, 3)
        and the depth (B, H, W, 1)."""
        b, h, w = pre_depth_log2.shape
        grid = camera_grid(b, h, w, pre_depth_log2.device)
        exp_depth = torch.exp2(pre_depth_log2.float())[..., None]
        points = grid * exp_depth

        # D2N
        norm_scale, angle, point_patches = d2n_least_squares(init_norm,
                                                             points)
        noise = self.noise_enc1(_nchw(norm_scale))
        noise = F.max_pool2d(same_pad(noise, 3, 2, value=float("-inf")), 3, 2)
        noise = self.noise_enc2(noise)
        noise_up = _nhwc(resize_nearest(noise.float(), h, w))
        norm_pred_noise = _unit(norm_scale * 0.1 + noise_up)
        rgb01 = rgb_model_input.float() / 255.0
        fuse_in = torch.cat([init_norm, norm_pred_noise, rgb01], -1)
        norm_final = _unit(_nhwc(self.norm_fusion(_nchw(fuse_in))))

        # N2D
        depth_stage1 = n2d_depth(init_norm, grid, angle, point_patches)
        depth_in = torch.cat([depth_stage1, exp_depth, rgb01], -1)
        depth_final = _nhwc(self.depth_fusion(_nchw(depth_in)))

        # Edge-guided propagation
        edge_w = self.edge_weight(self.edge_encoder(_nchw(edge_inputs)))
        edges_all = (_nhwc(edge_w) + canny).clamp(0.0, 1.0)
        dlr, drl, dud, ddu, nlr, nrl, nud, ndu = edges_all.split(1, -1)
        for _ in range(self.propagation_rounds):
            depth_final = propagate(depth_final, dlr, drl, dud, ddu)
        for _ in range(self.propagation_rounds):
            norm_final = _unit(propagate(norm_final, nlr, nrl, nud, ndu))
        return norm_final, depth_final


class NNET(nn.Module):
    """Encoder -> decoder -> refiner (`baseline.py:274-583`).

    ``forward(pre_depth_log2, rgb, edge_inputs, canny)``: ``rgb`` (B, H, W,
    3) in the training-value range; ``pre_depth_log2`` (B, H, W) log2-depth
    (`baseline.py:383`); ``edge_inputs`` and ``canny`` from
    :func:`sndepth_tpu_torch.ops.edges.edge_model_inputs`. Returns (normals
    (B, H, W, 3), depth (B, H, W, 1), the decoder's four (B, h, w, 4)
    maps). ``blocks``, ``stem_ch`` and ``head_ch`` size the encoder
    (EfficientNet-B5 by default)."""

    def __init__(self, architecture: str = "GN",
                 dtype: torch.dtype = torch.float32,
                 blocks: Sequence[BlockSpec] | None = None,
                 stem_ch: int = 48, head_ch: int = 2048):
        super().__init__()
        self.encoder = EfficientNetEncoder(blocks, stem_ch, head_ch, dtype)
        self.decoder = NormalDecoder(self.encoder.channels(), architecture,
                                     dtype)
        self.refiner = NNETRefiner(dtype)

    def forward(self, pre_depth_log2, rgb, edge_inputs, canny):
        model_in = bgr_preprocess(rgb)
        feats = self.encoder(_nchw(model_in / 255.0))
        norm_outs = self.decoder(feats)
        init_norm = norm_outs[-1][..., :3]
        norm_final, depth_final = self.refiner(
            pre_depth_log2, model_in, init_norm, edge_inputs, canny)
        return norm_final, depth_final, norm_outs


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator`` in module order, as the JAX
    modules' initialisers: LeCun-normal kernels (Xavier-uniform in the
    refiner's stacks), zero biases, unit norm scales, zero means and unit
    variances."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                if name.startswith("refiner."):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    bound = (6.0 / (fan_in + fan_out)) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                else:
                    m.weight.normal_(0.0, fan_in ** -0.5,
                                     generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
