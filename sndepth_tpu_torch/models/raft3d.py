"""RAFT-3D: dense SE(3) scene flow.

Counterpart of ``sndepth_tpu/models/raft3d.py``, with the reference's module
names so that a reference state_dict loads as it is:

* ``fnet``: feature encoder, a residual net with instance norm, 128
  channels at 1/8 resolution;
* ``cnet``: context net, a ResNet-50 bottleneck trunk with a two-level FPN
  tail, 512 channels at 1/8 resolution, BatchNorm always on its running
  statistics, under ``model.train()`` too (the JAX train step passes them
  in immutably: only the scales and biases train);
* a streaming correlation lookup over an average-pooled pyramid of the
  second frame's features (:func:`corr_lookup_dot`), and the all-pairs
  volume form it must equal (:func:`build_corr_pyramid`,
  :func:`corr_lookup`);
* ``update_block``: dual-dilation ConvGRU with heads for the attention
  embedding, the upsampling mask, the target revision and its confidence;
  the ``bilaplacian`` variant feeds the previous embedding to the GRU and
  smooths the new one with an edge-weighted grid solve;
* the dense Gauss-Newton SE(3) update (:func:`gauss_newton_step`), whose
  normal equations and their gradients come from the kernels of
  :mod:`sndepth_tpu_torch.kernels.gn_build`, and the convex upsampling.

Layouts. Images, feature maps and everything a convolution touches are NCHW,
as in the rest of the package. SE3 fields ``(B, H, W, 7)``, pixel
coordinates ``(B, H, W, 2 or 3)``, depths ``(B, H, W)``, and what the update
block hands to the Gauss-Newton step and the upsampling (embedding, mask,
revision, confidence) are channel-last, the layout of the JAX functions:
every function says which it takes. Parameters stay float32; ``dtype`` is
the type the encoders and the GRU run in. Correlation, Gauss-Newton and SE3
math are float32 whatever ``dtype`` is.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from sndepth_tpu_torch.kernels.gn_build import (EMB, gn_build_hg,
                                                gn_build_hg_reference)
from sndepth_tpu_torch.models.grid_smoother import GridSmoother
from sndepth_tpu_torch.ops import projective as pops
from sndepth_tpu_torch.ops import se3
from sndepth_tpu_torch.ops.layers import init_weights  # noqa: F401 (API)
from sndepth_tpu_torch.ops.patches import extract_patches
from sndepth_tpu_torch.ops.resize import resize_bilinear_align_corners
from sndepth_tpu_torch.ops.warp import bilinear_sampler_zero_pad

GRAD_CLIP = 0.01


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)
        g = torch.where(g.abs() > GRAD_CLIP, zero, g)
        return torch.where(torch.isnan(g), zero, g)


def grad_clip(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward zeroes gradient entries that are NaN or
    larger than ``GRAD_CLIP`` in magnitude."""
    return _GradClip.apply(x)


def _conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Apply ``layer`` in ``dtype`` with its float32 parameters cast."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    layer.padding, layer.dilation)


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Instance norm without affine parameters, eps 1e-5, statistics in
    float32."""
    return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm on its running statistics, computed in float32."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps).to(x.dtype)


# ----------------------------------------------------------------------
# Feature encoder (instance-norm residual net, 1/8 resolution)
# ----------------------------------------------------------------------

class _ResBlock(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        # Explicit symmetric padding on the stride-2 convs, as torch pads.
        self.conv1 = nn.Conv2d(c_in, features, 3, stride, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)
        if stride != 1 or c_in != features:
            # Index 1 of the reference's Sequential is its norm, which has
            # no parameters.
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, features, 1, stride))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_instance_norm(_conv(self.conv1, x, self.dtype)))
        h = F.relu(_instance_norm(_conv(self.conv2, h, self.dtype)))
        if self.downsample is not None:
            x = _instance_norm(_conv(self.downsample[0], x, self.dtype))
        return F.relu(x + h)


class BasicEncoder(nn.Module):
    """RAFT feature encoder: stages of 64 / 96 / 128 channels, two blocks
    each. (B, 3, H, W) -> (B, output_dim, H/8, W/8), in ``dtype``."""

    def __init__(self, output_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        c_in = 64
        for i, (features, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                _ResBlock(c_in, features, stride, dtype),
                _ResBlock(features, features, 1, dtype)))
            c_in = features
        self.conv2 = nn.Conv2d(c_in, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_instance_norm(_conv(self.conv1, x, self.dtype)))
        h = self.layer3(self.layer2(self.layer1(h)))
        return _conv(self.conv2, h, self.dtype)


# ----------------------------------------------------------------------
# Context net: ResNet-50 trunk + FPN fusion
# ----------------------------------------------------------------------

class _Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(c_in, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, 4 * features, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * features)
        if stride != 1 or c_in != 4 * features:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, 4 * features, 1, stride, bias=False),
                nn.BatchNorm2d(4 * features))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_batch_norm(self.bn1, _conv(self.conv1, x, self.dtype)))
        h = F.relu(_batch_norm(self.bn2, _conv(self.conv2, h, self.dtype)))
        h = _batch_norm(self.bn3, _conv(self.conv3, h, self.dtype))
        if self.downsample is not None:
            x = _batch_norm(self.downsample[1],
                            _conv(self.downsample[0], x, self.dtype))
        return F.relu(x + h)


class FPNContext(nn.Module):
    """ResNet-50 [3, 4, 6, 3] with a two-level FPN tail. (B, 3, H, W) ->
    (B, output_dim, H/8, W/8), in ``dtype``; BatchNorm on running
    statistics."""

    def __init__(self, output_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        c_in = 64
        for i, (features, blocks) in enumerate(
                ((64, 3), (128, 4), (256, 6), (512, 3))):
            layer = []
            for j in range(blocks):
                stride = 2 if (j == 0 and i > 0) else 1
                layer.append(_Bottleneck(c_in, features, stride, dtype))
                c_in = 4 * features
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.uconv1 = nn.Conv2d(2048, 512, 3, 1, 1)
        self.uconv2 = nn.Conv2d(1024, 512, 3, 1, 1)
        self.uconv3 = nn.Conv2d(512, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(_batch_norm(self.bn1, _conv(self.conv1, x, self.dtype)))
        h = F.max_pool2d(h, 3, 2, 1)
        c3 = self.layer2(self.layer1(h))            # 512 ch, 1/8
        c5 = self.layer4(self.layer3(c3))           # 2048 ch, 1/32
        z = F.relu(_conv(self.uconv1, c5, self.dtype))
        z = resize_bilinear_align_corners(z, c3.shape[2], c3.shape[3])
        h = F.relu(_conv(self.uconv2, torch.cat([c3, z], 1), self.dtype))
        return F.relu(_conv(self.uconv3, h, self.dtype))


# ----------------------------------------------------------------------
# Correlation pyramid
# ----------------------------------------------------------------------

def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> list[torch.Tensor]:
    """All-pairs correlation and its 2x average-pooled pyramid.

    fmap1 / fmap2: (B, C, H, W). Level i: (B, H1, W1, H2 / 2^i, W2 / 2^i);
    odd sizes lose their last row or column as under ``F.avg_pool2d``, and
    the levels stop when a side is under 2."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.float().flatten(2) / 4.0
    f2 = fmap2.float().flatten(2) / 4.0
    corr = torch.einsum("bcn,bcm->bnm", f1, f2).reshape(b, h, w, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        h2, w2 = pyramid[-1].shape[3:]
        if h2 < 2 or w2 < 2:
            break
        pooled = F.avg_pool2d(pyramid[-1].reshape(b * h * w, 1, h2, w2), 2, 2)
        pyramid.append(pooled.reshape(b, h, w, h2 // 2, w2 // 2))
    return pyramid


def pool_fmap_pyramid(fmap2: torch.Tensor,
                      num_levels: int = 4) -> list[torch.Tensor]:
    """Average-pooled pyramid of fmap2 (B, C, H, W) for the streaming
    lookup. Correlation is linear in fmap2, so pooling the feature map
    equals pooling the volume. Odd sizes truncate as under
    ``F.avg_pool2d``; the levels stop when a side is under 2."""
    out = [fmap2]
    for _ in range(num_levels - 1):
        h, w = out[-1].shape[2:]
        if h < 2 or w < 2:
            break
        out.append(F.avg_pool2d(out[-1], 2, 2))
    return out


def corr_lookup_dot(fmap1: torch.Tensor, f2_pyramid: list[torch.Tensor],
                    coords: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Streaming correlation lookup that never forms the (N, N) volume.

    fmap1: (B, C, H1, W1); f2_pyramid: levels (B, C, H2 / 2^i, W2 / 2^i);
    coords: (B, H1, W1, 2), channels (x, y) in level-0 pixels of frame 2.
    Returns (B, levels * (2r+1)^2, H1, W1), level-major, each window
    row-major.

    For each query and level it gathers the (2r+2)^2 feature vectors of a
    zero-padded fmap2 around the query's integer base, takes their products
    with the query's feature, and blends the scalar field bilinearly into
    the (2r+1)^2 window. The padding is the zero-pad rule of the volume
    lookup: a tap outside the image reads 0, and a query whose whole window
    misses the image reads 0 everywhere."""
    b, c, h1, w1 = fmap1.shape
    n = h1 * w1
    win = 2 * radius + 1
    q = fmap1.float().flatten(2).transpose(1, 2) / 16.0            # B,n,C
    # The clamp below lets integer bases range over [-r-2, dim+r] and a
    # slab spans [base-r, base+r+1]: a pad of 2r+2 keeps every read inside
    # the padded array.
    pad = 2 * radius + 2
    tap = torch.arange(-radius, radius + 2, device=fmap1.device)
    batch = torch.arange(b, device=fmap1.device)[:, None]

    out = []
    for i, f2l in enumerate(f2_pyramid):
        h2, w2 = f2l.shape[2:]
        w2p = w2 + 2 * pad
        vf = F.pad(f2l.float(), (pad, pad, pad, pad)).flatten(2).transpose(
            1, 2).contiguous()                                     # B,NR,C
        cc = coords.reshape(b, n, 2) / (2 ** i)
        x, y = cc[..., 0], cc[..., 1]
        x0, y0 = torch.floor(x), torch.floor(y)
        fx = (x - x0)[..., None, None]
        fy = (y - y0)[..., None, None]
        # The clamp only moves queries whose whole tap window misses the
        # image: a base of -r-2 puts the furthest tap at -1 and a base of
        # dim+r the nearest tap at dim, so the window still lies in the
        # padding and reads exactly 0. (A NaN coordinate gets base 0; its
        # blend weights keep the output NaN.)
        x0i = torch.nan_to_num(x0).clamp(-radius - 2, w2 + radius).long()
        y0i = torch.nan_to_num(y0).clamp(-radius - 2, h2 + radius).long()
        rows = (y0i[..., None] + tap + pad) * w2p                  # B,n,win+1
        cols = x0i[..., None] + tap + pad
        index = (rows[..., :, None] + cols[..., None, :]).reshape(b, -1)
        patches = vf[batch, index].reshape(b, n, (win + 1) ** 2, c)
        s = torch.einsum("bnkc,bnc->bnk", patches, q).reshape(
            b, n, win + 1, win + 1)
        val = ((1 - fy) * (1 - fx) * s[:, :, :win, :win]
               + (1 - fy) * fx * s[:, :, :win, 1:]
               + fy * (1 - fx) * s[:, :, 1:, :win]
               + fy * fx * s[:, :, 1:, 1:])
        out.append(val.reshape(b, n, win * win))
    return torch.cat(out, -1).transpose(1, 2).reshape(b, -1, h1, w1)


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor,
                radius: int = 3) -> torch.Tensor:
    """Windowed bilinear lookup into the volume pyramid of
    :func:`build_corr_pyramid`, zero-padded. coords: (B, H1, W1, 2) in
    level-0 pixels of frame 2. Returns (B, levels * (2r+1)^2, H1, W1) as
    :func:`corr_lookup_dot` does."""
    b, h1, w1, _ = coords.shape
    win = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                     device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    offsets = torch.stack([dx, dy], 0)                             # 2,win,win

    out = []
    for i, vol in enumerate(pyramid):
        h2, w2 = vol.shape[3:]
        centre = (coords / (2 ** i)).reshape(b * h1 * w1, 2, 1, 1)
        # Fold (B, H1, W1) into the batch axis and reuse the sampler.
        sampled = bilinear_sampler_zero_pad(
            vol.reshape(b * h1 * w1, 1, h2, w2), centre + offsets[None])
        out.append(sampled.reshape(b, h1, w1, win * win))
    return torch.cat(out, -1).permute(0, 3, 1, 2)


# ----------------------------------------------------------------------
# Update block
# ----------------------------------------------------------------------

class ConvGRU(nn.Module):
    """Dual-dilation ConvGRU; the extra inputs arrive pre-split into z / r
    / q thirds along the channels and are summed. NCHW."""

    def __init__(self, hidden_dim: int = 128, dilation: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for gate in "zrq":
            setattr(self, f"conv{gate}1",
                    nn.Conv2d(hidden_dim, hidden_dim, 3, 1, 1))
            setattr(self, f"conv{gate}2",
                    nn.Conv2d(hidden_dim, hidden_dim, 3, 1, dilation,
                              dilation))

    def _dual(self, gate: str, x: torch.Tensor) -> torch.Tensor:
        return (_conv(getattr(self, f"conv{gate}1"), x, self.dtype)
                + _conv(getattr(self, f"conv{gate}2"), x, self.dtype))

    def forward(self, h: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
        iz = ir = iq = 0.0
        for inp in inputs:
            a, b, c = inp.chunk(3, dim=1)
            iz, ir, iq = iz + a, ir + b, iq + c
        z = torch.sigmoid(self._dual("z", h) + iz)
        r = torch.sigmoid(self._dual("r", h) + ir)
        q = torch.tanh(self._dual("q", r * h) + iq)
        return (1.0 - z) * h + z * q


def _head(out_ch: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(128, 256, 3, 1, 1), nn.ReLU(),
                         nn.Conv2d(256, out_ch, 1))


class BasicUpdateBlock(nn.Module):
    """GRU and heads. With ``bilaplacian`` the previous 16-channel embedding
    feeds the GRU and the new one is smoothed by an edge-weighted grid
    solve.

    Takes ``net`` (B, 128, H, W), ``inp`` (B, 384, H, W) and ``corr``
    (B, corr_ch, H, W) as NCHW; ``flow`` (B, H, W, 2), ``twist``
    (B, H, W, 6), ``dz`` (B, H, W, 1) and ``ae_in`` (B, H, W, 16)
    channel-last. Returns ``net`` NCHW and, channel-last and float32, the
    mask (B, H, W, 576), the embedding (B, H, W, 32 or 16), the revision
    and the confidence (B, H, W, 3)."""

    def __init__(self, hidden_dim: int = 128, bilaplacian: bool = False,
                 corr_channels: int = 4 * 49,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bilaplacian = bilaplacian
        self.corr_enc = nn.Sequential(
            nn.Conv2d(corr_channels, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 3 * 128, 1))
        self.flow_enc = nn.Sequential(
            nn.Conv2d(9, 128, 7, 1, 3), nn.ReLU(),
            nn.Conv2d(128, 3 * 128, 1))
        self.gru = ConvGRU(hidden_dim, dilation=3 if bilaplacian else 4,
                           dtype=dtype)
        self.ae = _head(16 if bilaplacian else 32)
        self.mask = _head(64 * 9)
        self.delta = _head(3)
        self.weight = _head(3)
        if bilaplacian:
            self.ae_enc = nn.Conv2d(16, 3 * 128, 3, 1, 1)
            self.ae_wts = _head(2)
            self.smoother = GridSmoother()

    def _apply_head(self, head: nn.Sequential, net: torch.Tensor) -> torch.Tensor:
        h = F.relu(_conv(head[0], net, self.dtype))
        # The output conv runs in float32 on a float32 cast.
        h = grad_clip(_conv(head[2], h.float(), torch.float32))
        return h.permute(0, 2, 3, 1)

    def forward(self, net, inp, corr, flow, twist, dz, ae_in=None):
        motion = torch.cat([flow, 10.0 * dz, 10.0 * twist], -1)
        motion = motion.clamp(-50.0, 50.0).permute(0, 3, 1, 2)

        cor = F.relu(_conv(self.corr_enc[0], corr, self.dtype))
        cor = F.relu(_conv(self.corr_enc[2], cor, self.dtype))
        cor = _conv(self.corr_enc[4], cor, self.dtype)
        mot = F.relu(_conv(self.flow_enc[0], motion, self.dtype))
        mot = _conv(self.flow_enc[2], mot, self.dtype)

        gru_inputs = [inp, cor, mot]
        if self.bilaplacian:
            if ae_in is None:
                raise ValueError("the bilaplacian block needs ae_in")
            gru_inputs.append(_conv(self.ae_enc, ae_in.permute(0, 3, 1, 2),
                                    self.dtype))
        net = self.gru(net, *gru_inputs)

        ae = self._apply_head(self.ae, net)
        mask = self._apply_head(self.mask, net)
        delta = self._apply_head(self.delta, net)
        weight = torch.sigmoid(self._apply_head(self.weight, net))
        if self.bilaplacian:
            edges = 5.0 * F.softplus(self._apply_head(self.ae_wts, net))
            ae = self.smoother(ae, edges)
        return net, mask, ae, delta, weight


# ----------------------------------------------------------------------
# Dense Gauss-Newton SE(3) update
# ----------------------------------------------------------------------

def cholesky_solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Batched SPD 6x6 solve by a fully unrolled Cholesky factorisation and
    two triangular substitutions, elementwise over the leading axes.
    H (..., 6, 6), g (..., 6) -> (..., 6). The pivots are floored at 1e-12
    under the root."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = (torch.sqrt(s.clamp_min(1e-12)) if i == j
                       else s / L[j][j])
    y = []
    for i in range(6):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def _make_grid_positions(h: int, w: int, device: torch.device):
    rows = torch.arange(h, dtype=torch.float32, device=device)
    cols = torch.arange(w, dtype=torch.float32, device=device)
    return rows.repeat_interleave(w), cols.repeat(h)


_cached_grid_positions = functools.lru_cache(maxsize=8)(_make_grid_positions)


def _grid_positions(h: int, w: int, device: torch.device):
    """Row and column of every pixel of an h x w grid, flattened row-major,
    as the float32 vectors the build takes. The same for every iteration
    of a frame and every frame of a size, so made once; made anew while
    ``torch.export`` traces (its tensors then are the tracer's, not
    values)."""
    if torch.compiler.is_compiling():
        return _make_grid_positions(h, w, device)
    return _cached_grid_positions(h, w, device)


def gauss_newton_step(Ts: torch.Tensor, ae: torch.Tensor,
                      target: torch.Tensor, weight: torch.Tensor,
                      depth: torch.Tensor, intrinsics: torch.Tensor,
                      radius: int = 32, lm: float = 1e-4,
                      ep: float = 10.0) -> torch.Tensor:
    """One dense embedding-weighted Gauss-Newton update of the SE3 field.

    Per pixel i the 6x6 normal equations accumulate, over every pixel j
    within ``radius`` grid units, the reprojection residual of T_i applied
    to the point X_j against target_j, weighted per channel by the
    confidence w_j and by the attention sigmoid(-|ae_i / 8 - ae_j / 8|^2).

    All channel-last: Ts (B, H, W, 7); ae (B, H, W, E); target, weight
    (B, H, W, 3); depth (B, H, W); intrinsics (B, 4). A 32-wide embedding
    goes through :func:`sndepth_tpu_torch.kernels.gn_build.gn_build_hg`
    (the kernel on a CUDA tensor, at every size); any other width takes the
    plain build on either device."""
    b, h, w, _ = Ts.shape
    n = h * w
    pts = pops.inv_project(depth, intrinsics).float()
    x = (ae.float() / 8.0).reshape(b, n, -1)
    sq = (x * x).sum(-1)
    gy, gx = _grid_positions(h, w, Ts.device)
    T_flat = Ts.reshape(b, n, 7).float()
    rot = se3.rotation_matrix(T_flat)
    trans = T_flat[..., :3]
    build = gn_build_hg if x.shape[-1] == EMB else gn_build_hg_reference
    H, g = build(rot, trans, x, sq, gy, gx, pts.reshape(b, n, 3),
                 target.float().reshape(b, n, 3),
                 weight.float().reshape(b, n, 3),
                 intrinsics[:, :4].float(), radius)
    eye = torch.eye(6, dtype=torch.float32, device=Ts.device)
    H = H + lm * H * eye + ep * eye
    dx = cholesky_solve6(H, g).reshape(b, h, w, 6)
    return se3.mul(se3.exp(dx), Ts.float())


# ----------------------------------------------------------------------
# Convex upsampling
# ----------------------------------------------------------------------

def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT convex-combination 8x upsampling, channel-last: data
    (B, H, W, C), mask (B, H, W, 9 * 8 * 8) with channel = tap * 64 + u * 8
    + v. Returns (B, 8H, 8W, C)."""
    b, h, w, c = data.shape
    m = mask.reshape(b, h, w, 9, 8, 8).softmax(3)
    patches = extract_patches(data, 3, 1)                          # B,H,W,9,C
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", m, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, c)


def upsample_se3(Ts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Upsample an SE3 field (B, H, W, 7) through log and exp."""
    return se3.exp(cvx_upsample(se3.log(Ts), mask))


# ----------------------------------------------------------------------
# Full model
# ----------------------------------------------------------------------

class RAFT3D(nn.Module):
    """forward(image1, image2, depth1, depth2, intrinsics, iters) -> the
    upsampled SE3 field (B, H, W, 7), or with ``train_mode`` the
    per-iteration outputs. Images (B, 3, H, W), depths (B, H, W),
    intrinsics (B, 4) = [fx fy cx cy]; H and W multiples of 8."""

    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 3, gn_radius: int = 32,
                 bilaplacian: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.gn_radius = gn_radius
        self.bilaplacian = bilaplacian
        self.dtype = dtype
        self.fnet = BasicEncoder(128, dtype)
        self.cnet = FPNContext(4 * hidden_dim, dtype)
        self.update_block = BasicUpdateBlock(
            hidden_dim, bilaplacian,
            corr_levels * (2 * corr_radius + 1) ** 2, dtype)

    def features(self, image1, image2, depth1, depth2, intrinsics):
        """Everything an iteration needs that does not change over the
        iterations, and the initial GRU state: ``(const, net)``."""
        hdim = self.hidden_dim
        b, _, ht, wd = image1.shape
        h8, w8 = ht // 8, wd // 8
        fmap1 = self.fnet(image1).float()
        fmap2 = self.fnet(image2).float()
        net_inp = self.cnet(image1)
        net = torch.tanh(net_inp[:, :hdim]).float()
        inp = F.relu(net_inp[:, hdim:]).float()
        f2_pyramid = pool_fmap_pyramid(fmap2, self.corr_levels)
        if len(f2_pyramid) < self.corr_levels:
            # The update block's first conv is as wide as all the levels.
            raise ValueError(
                f"a {ht}x{wd} image gives {len(f2_pyramid)} correlation "
                f"levels, the model needs {self.corr_levels}: each side "
                f"must be at least {8 * 2 ** (self.corr_levels - 1)}")
        x, y = pops.pixel_axes(h8, w8, fmap1)
        const = {
            "fmap1": fmap1,
            "f2_pyramid": f2_pyramid,
            "inp": inp,
            "coords0": torch.stack([x, y], -1).expand(b, h8, w8, 2),
            "depth1_r8": depth1[:, 3::8, 3::8],
            "depth2_r8": depth2[:, 3::8, 3::8],
            "intrinsics_r8": intrinsics / 8.0,
            "depth1": depth1,
            "intrinsics": intrinsics,
        }
        return const, net

    def iteration(self, carry, const, train_mode: bool = False):
        """One refinement iteration: ``(Ts, net, ae_prev)`` -> the new
        carry and, in ``train_mode``, the iteration's (2-D flow of the
        upsampled field, upsampled revised flow, upsampled field), else
        the upsampling mask."""
        Ts, net, ae_prev = carry
        Ts = Ts.detach()
        depth1_r8, intrinsics_r8 = const["depth1_r8"], const["intrinsics_r8"]

        coords1_xyz, _ = pops.projective_transform(Ts, depth1_r8,
                                                   intrinsics_r8)
        coords1 = coords1_xyz[..., :2]
        zinv_proj = coords1_xyz[..., 2:]
        zinv, _ = pops.depth_sampler(1.0 / const["depth2_r8"], coords1)

        corr = corr_lookup_dot(const["fmap1"], const["f2_pyramid"], coords1,
                               self.corr_radius)
        flow = coords1 - const["coords0"]
        dz = zinv[..., None] - zinv_proj
        twist = se3.log(Ts)

        net, mask, ae, delta, weight = self.update_block(
            net, const["inp"], corr, flow, twist, dz,
            ae_in=ae_prev if self.bilaplacian else None)

        target = coords1_xyz + delta
        Ts = gauss_newton_step(Ts, ae, target, weight, depth1_r8,
                               intrinsics_r8, self.gn_radius)
        Ts = se3.normalize(Ts)

        if not train_mode:
            return (Ts, net, ae), mask
        flow2d_rev = cvx_upsample(8.0 * (target[..., :2] - const["coords0"]),
                                  mask)
        Ts_up = upsample_se3(Ts, mask)
        flow2d_est, _, _ = pops.induced_flow(Ts_up, const["depth1"],
                                             const["intrinsics"])
        return (Ts, net, ae), (flow2d_est, flow2d_rev, Ts_up)

    def initial_carry(self, net: torch.Tensor):
        b, _, h8, w8 = net.shape
        Ts = se3.identity((b, h8, w8), device=net.device)
        ae = torch.zeros(b, h8, w8, 16 if self.bilaplacian else 32,
                         device=net.device)
        return Ts, net, ae

    def forward(self, image1, image2, depth1, depth2, intrinsics,
                iters: int = 12, train_mode: bool = False):
        const, net = self.features(image1, image2, depth1, depth2,
                                   intrinsics)
        carry = self.initial_carry(net)
        outs = []
        for _ in range(iters):
            carry, ys = self.iteration(carry, const, train_mode)
            outs.append(ys)
        if train_mode:
            # (iters, B, ...) each: flow of the field, revised flow, field.
            return tuple(torch.stack(o) for o in zip(*outs))
        return upsample_se3(carry[0], ys)
