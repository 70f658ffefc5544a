"""Surface-normal decoder with uncertainty heads (NCHW inside).

Counterpart of :class:`sndepth_tpu.models.normal_decoder.NormalDecoder`
(reference `submodules/decoder.py`, `submodules/submodules.py`): ``UpSample``
skip blocks of two convolution + norm + leaky-ReLU stages
(weight-standardised convolutions and GroupNorm in the ``"GN"``
architecture, the reference's default; convolutions and BatchNorm in
``"BN"``), a 4-channel head (normal xyz and kappa) at 1/8 of the encoder's
input, and three pointwise refinement MLPs at 1/4, 1/2 and 1/1, each output
normalised by :func:`norm_normalize`. In test mode the MLPs run densely. In
train mode each level refines a sample of its points
(:func:`sample_points`: the least confident, then uniform coverage of the
rest): evaluated densely and selected by the sample's mask
(``dense_refine``, the JAX default), or gathered, refined and scattered
back, which gives the same values.

Module names are the reference's, so that ``sndepth_tpu.utils.
convert_weights.convert_normal_decoder`` maps this module's state_dict into
JAX params: ``conv2``, ``up{1..4}._net.{0,1,3,4}``, ``out_conv_res8``,
``out_conv_res{4,2,1}.{0,2,4,6}`` (``Conv1d`` of kernel 1, applied densely
as 1x1 convolutions). Parameters stay float32; ``dtype`` is the type the
blocks and the MLPs' hidden layers run in, the heads run in float32, as in
the JAX module (float64 where ``dtype`` is).
The outputs are channel-last, (B, h, w, 4), as the JAX module returns them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.ops.norm import BatchNorm2d, GroupNorm
from sndepth_tpu_torch.ops.resize import resize_bilinear_align_corners


MIN_KAPPA = 0.01
# The share of a level's points that train mode refines, and the share of
# those taken by lowest confidence (the rest uniformly), as the JAX module's
# defaults.
SAMPLING_RATIO = 0.4
IMPORTANCE_RATIO = 0.7


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) by ``jax.image.resize(...,
    "nearest")``: half-pixel centres, source index floor((i + 0.5) n / m)
    in float32 (torch's ``"nearest-exact"``, not ``"nearest"``)."""
    def index(n_in, n_out):
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor((i + 0.5) * n_in / n_out).long()
    return x.index_select(2, index(x.shape[2], h)).index_select(
        3, index(x.shape[3], w))


def norm_normalize(out: torch.Tensor) -> torch.Tensor:
    """L2-normalise xyz; kappa -> elu(kappa) + 1 + 0.01
    (`submodules.py:64-70`). out: (B, 4, H, W)."""
    xyz, kappa = out[:, :3], out[:, 3:]
    norm = torch.sqrt((xyz * xyz).sum(1, keepdim=True)) + 1e-10
    kappa = F.elu(kappa) + 1.0 + MIN_KAPPA
    return torch.cat([xyz / norm, kappa], 1)


def sample_points(init_normal: torch.Tensor,
                  gt_norm_mask: torch.Tensor | None,
                  generator: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uncertainty-guided point sampling (`submodules.py:75-140`), the JAX
    function's "exact" backend. init_normal (B, H, W, 4); gt_norm_mask
    (B, H0, W0, 1) or None. Returns (rows, cols), int64 (B, N) with N =
    int(SAMPLING_RATIO H W): the int(IMPORTANCE_RATIO N) least confident
    points (lowest kappa; points the nearest-resized mask leaves out count
    as -1e4 and come last), then the rest of N drawn uniformly without
    replacement from the remaining points with ``generator``.

    The importance set is ``jax.lax.top_k``'s: a stable descending sort,
    which puts equal keys in index order. The JAX package draws the
    coverage set with ``jax.random.permutation``; this draws it with
    ``torch.randperm``, to the same contract but not the same points."""
    b, h, w, _ = init_normal.shape
    n = int(SAMPLING_RATIO * h * w)
    n_imp = int(IMPORTANCE_RATIO * n)
    n_cov = n - n_imp
    uncertainty = -init_normal[..., 3].reshape(b, h * w)
    if gt_norm_mask is not None:
        mask = resize_nearest(gt_norm_mask.float().permute(0, 3, 1, 2), h, w)
        invalid = mask.reshape(b, h * w) < 0.5
        uncertainty = torch.where(invalid, -1e4, uncertainty)
    order = torch.sort(uncertainty, dim=1, descending=True,
                       stable=True).indices
    samples = order[:, :n_imp]
    if n_cov > 0:
        rest = order[:, n_imp:]
        picks = torch.stack([torch.randperm(
            rest.shape[1], generator=generator,
            device=generator.device)[:n_cov] for _ in range(b)])
        samples = torch.cat([samples, rest.gather(
            1, picks.to(rest.device))], 1)
    return samples // w, samples % w


def gather_points(feat: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C); rows, cols (B, N) -> (B, N, C): the reference's
    ``grid_sample`` at exactly integer coordinates (`decoder.py:92-93`)."""
    bidx = torch.arange(feat.shape[0], device=feat.device)[:, None]
    return feat[bidx, rows, cols]


def scatter_points(base: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base`` (B, H, W, C) with ``values`` (B, N, C) written at the
    points (`decoder.py:100-101`); out of place."""
    bidx = torch.arange(base.shape[0], device=base.device)[:, None]
    return base.index_put((bidx.expand_as(rows), rows, cols), values)


def selection_mask(rows: torch.Tensor, cols: torch.Tensor, h: int,
                   w: int) -> torch.Tensor:
    """(B, N) sampled coordinates -> (B, h, w) float32 {0, 1} mask."""
    mask = torch.zeros(rows.shape[0], h * w, device=rows.device)
    return mask.scatter(1, rows * w + cols, 1.0).reshape(-1, h, w)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
         weight: torch.Tensor | None = None) -> torch.Tensor:
    """``layer`` (stride 1, odd kernel, symmetric padding) in ``dtype``."""
    w = layer.weight if weight is None else weight
    return F.conv2d(x.to(dtype), w.to(dtype), layer.bias.to(dtype), 1,
                    layer.padding, layer.dilation)


class WSConv2d(nn.Conv2d):
    """3x3 convolution with weight standardisation (`submodules.py:46-60`):
    each output channel's kernel, over its full extent, minus its mean and
    over its Bessel-corrected standard deviation plus 1e-5, formed at apply
    time."""

    def standardized(self) -> torch.Tensor:
        w = self.weight
        centred = w - w.mean((1, 2, 3), keepdim=True)
        n = w[0].numel()
        var = centred.var((1, 2, 3), unbiased=False, keepdim=True)
        std = torch.sqrt(var * n / (n - 1))
        return centred / (std + 1e-5)


class UpSampleBlock(nn.Module):
    """Bilinear (align-corners) upsample to the skip's size, concatenate,
    then two convolution + norm + leaky-ReLU stages (`submodules.py:10-42`).
    """

    def __init__(self, in_ch: int, features: int, architecture: str = "GN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if architecture not in ("GN", "BN"):
            raise ValueError(f"architecture {architecture!r}: GN or BN")
        self.architecture = architecture
        self.dtype = dtype
        if architecture == "GN":
            # GroupNorm at flax's epsilon, 1e-6.
            layers = [WSConv2d(in_ch, features, 3, padding=1),
                      GroupNorm(8, features, dtype=dtype), nn.LeakyReLU(0.01),
                      WSConv2d(features, features, 3, padding=1),
                      GroupNorm(8, features, dtype=dtype), nn.LeakyReLU(0.01)]
        else:
            # flax's BatchNorm epsilon, 1e-5 (the encoder's is 1e-3).
            layers = [nn.Conv2d(in_ch, features, 3, padding=1),
                      BatchNorm2d(features, dtype=dtype), nn.LeakyReLU(0.01),
                      nn.Conv2d(features, features, 3, padding=1),
                      BatchNorm2d(features, dtype=dtype), nn.LeakyReLU(0.01)]
        self._net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = resize_bilinear_align_corners(x, skip.shape[2], skip.shape[3])
        h = torch.cat([up, skip.to(up.dtype)], 1)
        for i in (0, 3):
            layer = self._net[i]
            w = (layer.standardized() if isinstance(layer, WSConv2d)
                 else None)
            h = conv(layer, h, self.dtype, w)
            h = F.leaky_relu(self._net[i + 1](h), 0.01)
        return h


def _head_dtype(dtype: torch.dtype) -> torch.dtype:
    """The heads' type: float32, or float64 where the net computes in it
    (the tests' float64 evaluations)."""
    return torch.promote_types(dtype, torch.float32)


def point_mlp(mlp: nn.Sequential, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The shared pointwise refinement head (`decoder.py:36-57`) applied
    densely: three kernel-1 layers with ReLU in ``dtype``, the last layer
    (4 outputs) in float32."""
    h = x.to(dtype)
    layers = [mlp[i] for i in (0, 2, 4, 6)]
    for layer in layers[:3]:
        h = F.relu(F.conv2d(h, layer.weight[..., None].to(dtype),
                            layer.bias.to(dtype)))
    last = layers[3]
    h = h.to(_head_dtype(dtype))
    return F.conv2d(h, last.weight[..., None].to(h.dtype),
                    last.bias.to(h.dtype))


class NormalDecoder(nn.Module):
    """``decoder(features)`` -> the (B, h_s, w_s, 4) normal + kappa maps at
    1/8, 1/4, 1/2 and 1/1 of the encoder's input, float32, channel-last.

    ``decoder(features, mode="train", gt_norm_mask=..., generator=...)``
    returns the JAX module's triple instead: those maps, the refined points
    of each level and their selection. Level 0 is the coarse map in both
    lists (its selection None). With ``dense_refine`` a level's refined
    points are the dense MLP output (B, h, w, 4) and its selection the
    (B, h, w) mask of the sample; without it, the points (B, N, 4) and their
    (rows, cols). ``gt_norm_mask`` (B, H, W, 1) keeps the sampler off
    invalid pixels.

    ``channels`` are the widths of the encoder features ``stage0``,
    ``stage1``, ``stage2``, ``stage4`` and ``head`` (EfficientNet-B5's by
    default)."""

    def __init__(self, channels: dict | None = None, architecture: str = "GN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = channels or {"stage0": 24, "stage1": 40, "stage2": 64,
                          "stage4": 176, "head": 2048}
        self.dtype = dtype
        self.conv2 = nn.Conv2d(ch["head"], 2048, 1)
        self.up1 = UpSampleBlock(2048 + ch["stage4"], 1024, architecture,
                                 dtype)
        self.up2 = UpSampleBlock(1024 + ch["stage2"], 512, architecture, dtype)
        self.up3 = UpSampleBlock(512 + ch["stage1"], 256, architecture, dtype)
        self.up4 = UpSampleBlock(256 + ch["stage0"], 128, architecture, dtype)
        self.out_conv_res8 = nn.Conv2d(512, 4, 3, padding=1)
        for r, width in ((4, 512), (2, 256), (1, 128)):
            setattr(self, f"out_conv_res{r}", nn.Sequential(
                nn.Conv1d(width + 4, 128, 1), nn.ReLU(),
                nn.Conv1d(128, 128, 1), nn.ReLU(),
                nn.Conv1d(128, 128, 1), nn.ReLU(),
                nn.Conv1d(128, 4, 1)))

    def forward(self, features: dict, mode: str = "test",
                gt_norm_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                dense_refine: bool = True):
        dt = self.dtype
        x_d0 = conv(self.conv2, features["head"], dt)
        x_d1 = self.up1(x_d0, features["stage4"])
        x_d2 = self.up2(x_d1, features["stage2"])
        x_d3 = self.up3(x_d2, features["stage1"])
        x_d4 = self.up4(x_d3, features["stage0"])
        head = _head_dtype(dt)
        out = norm_normalize(conv(self.out_conv_res8, x_d2, head))
        outs = [out]
        points, selections = [_nhwc(out)], [None]
        for feat, mlp in ((x_d2, self.out_conv_res4),
                          (x_d3, self.out_conv_res2),
                          (x_d4, self.out_conv_res1)):
            h, w = 2 * out.shape[2], 2 * out.shape[3]
            up = resize_bilinear_align_corners(out, h, w)
            feat_up = resize_bilinear_align_corners(feat, h, w)
            dense_in = torch.cat([feat_up.to(head), up], 1)
            if mode != "train":
                out = norm_normalize(point_mlp(mlp, dense_in, dt))
                outs.append(out)
                continue
            rows, cols = sample_points(_nhwc(up.detach()), gt_norm_mask,
                                       generator)
            if dense_refine:
                pred = norm_normalize(point_mlp(mlp, dense_in, dt))
                sel = selection_mask(rows, cols, h, w)
                out = torch.where(sel[:, None] > 0.5, pred, up)
                points.append(_nhwc(pred))
                selections.append(sel)
            else:
                pts_in = torch.cat([
                    gather_points(_nhwc(feat_up), rows, cols).to(head),
                    gather_points(_nhwc(up), rows, cols)], -1)
                # The N points as an (N, 1) image, for the kernel-1 MLP.
                pred = norm_normalize(point_mlp(
                    mlp, pts_in.permute(0, 2, 1)[..., None], dt))
                pred = pred[..., 0].permute(0, 2, 1)
                out = _nchw(scatter_points(_nhwc(up), rows, cols, pred))
                points.append(pred)
                selections.append((rows, cols))
            outs.append(out)
        outs = [_nhwc(o) for o in outs]
        if mode == "train":
            return outs, points, selections
        return outs


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)
