"""Plain PyTorch reference of the GeoNet train step (stage 1, and stage 2
with ``train_flow``), float32, with no kernel of the port.

GeoNet (Yin and Shi, CVPR 2018, github.com/yzcjtr/GeoNet): DispNetS over the
stacked [target, sources] views, PoseNet over their channel concatenation,
a 4-scale rigid-warp photometric loss (alpha DSSIM + (1 - alpha) L1, both
directions) with edge-aware disparity smoothness; in stage 2 a residual
FlowNet, the full-flow photometric loss under forward-backward consistency
masks, flow smoothness and the consistency loss; Adam (lr 2e-4, betas 0.9 /
0.999, eps 1e-8 outside the square root). The module and parameter names
are the reference's (``conv{i}.0``, ``upconv{i}.0``, ``iconv{i}.0``,
``predict_disp{i}.0``, ``pred_poses``, ``flow{i}``), so one state dict loads
here and into the port.

Every convolution runs in float32 with TF32 off (the caller turns it off).
``precision="fp8"`` trains the convolutions in float8, each tensor with its
own scale: operands in e4m3 forward, the output's gradient in e5m2 into
both backward products. That is the control, a step below the bfloat16
the configuration states.

Each place where the port launches a hand-written kernel notes its work
(:mod:`gpubench.work`): the photo kernel (K1 pair, K3 one direction, K4
weighted pair), the smoothness sums (K2), the DSSIM map and its adjoint
(K7) and the sampler (K5, K5b, K6).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from gpubench import work
from gpubench.reference.sampler import sample

FLOW_IN_CHANNELS = 12
# The port's device kernels of each noted call (``kernels/csrc/*.cu``).
PHOTO = ("photo_pair_kernel",)
SMOOTH = ("smooth_kernel",)
DSSIM = ("dssim_fwd_kernel", "dssim_bwd_kernel")


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``x`` through a float8 type with a per-tensor scale that maps its
    largest magnitude to the type's largest."""
    scale = largest / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _OperandFP8(torch.autograd.Function):
    """A convolution operand in float8 e4m3; its gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradFP8(torch.autograd.Function):
    """The identity, whose backward hands the convolution its output's
    gradient in float8 e5m2, as float8 training does."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _conv(layer, x, precision, transpose=False):
    w = layer.weight
    if precision == "fp8":
        x, w = _OperandFP8.apply(x), _OperandFP8.apply(w)
    if transpose:
        y = F.conv_transpose2d(x, w, layer.bias, layer.stride,
                               layer.padding, layer.output_padding)
    else:
        y = F.conv2d(x, w, layer.bias, layer.stride, layer.padding)
    return _GradFP8.apply(y) if precision == "fp8" else y


def _crop_like(x, ref):
    return x[..., :ref.shape[2], :ref.shape[3]]


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class EncoderDecoder(nn.Module):
    """The 7-level stride-2 encoder (kernels 7, 5, 3, ...) and the
    transposed-convolution decoder with skips, shared by DispNetS and
    FlowNet."""

    def __init__(self, c_in, head_channels, precision="float32"):
        super().__init__()
        self.precision = precision
        ep = (32, 64, 128, 256, 512, 512, 512)
        dp = (512, 512, 256, 128, 64, 32, 16)
        self.dec_planes = dp
        for i, (planes, k) in enumerate(zip(ep, (7, 5, 3, 3, 3, 3, 3))):
            p = (k - 1) // 2
            setattr(self, f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(c_in, planes, k, 2, p), nn.ReLU(),
                nn.Conv2d(planes, planes, k, 1, p), nn.ReLU()))
            c_in = planes
        up_in = (ep[6],) + dp[:6]
        hc = head_channels
        skip = (ep[5], ep[4], ep[3], ep[2], ep[1] + hc, ep[0] + hc, hc)
        for i in range(7):
            t = 7 - i
            setattr(self, f"upconv{t}", nn.Sequential(
                nn.ConvTranspose2d(up_in[i], dp[i], 3, 2, 1, 1), nn.ReLU()))
            setattr(self, f"iconv{t}", nn.Sequential(
                nn.Conv2d(dp[i] + skip[i], dp[i], 3, 1, 1), nn.ReLU()))

    def _up(self, t, x, ref):
        layer = getattr(self, f"upconv{t}")[0]
        return _crop_like(F.relu(_conv(layer, x, self.precision, True)), ref)

    def _iconv(self, t, *xs):
        layer = getattr(self, f"iconv{t}")[0]
        return F.relu(_conv(layer, torch.cat(xs, 1), self.precision))

    def _decode(self, x, head):
        feats, h = [], x
        for i in range(7):
            block = getattr(self, f"conv{i + 1}")
            h = F.relu(_conv(block[0], h, self.precision))
            h = F.relu(_conv(block[2], h, self.precision))
            feats.append(h)
        c1, c2, c3, c4, c5, c6, c7 = feats
        i7 = self._iconv(7, self._up(7, c7, c6), c6)
        i6 = self._iconv(6, self._up(6, i7, c5), c5)
        i5 = self._iconv(5, self._up(5, i6, c4), c4)
        i4 = self._iconv(4, self._up(4, i5, c3), c3)
        p4 = head(4, i4)
        i3 = self._iconv(3, self._up(3, i4, c2), c2,
                         _crop_like(_up2(p4), c2))
        p3 = head(3, i3)
        i2 = self._iconv(2, self._up(2, i3, c1), c1,
                         _crop_like(_up2(p3), c1))
        p2 = head(2, i2)
        i1 = self._iconv(1, self._up(1, i2, x), _crop_like(_up2(p2), x))
        p1 = head(1, i1)
        return p1, p2, p3, p4


class DispNetS(EncoderDecoder):
    """(B, 3, H, W) in [-1, 1] -> four disparities 10 sigmoid(d) + 0.01,
    finest first."""

    def __init__(self, precision="float32"):
        super().__init__(3, 1, precision)
        for t in (4, 3, 2, 1):
            setattr(self, f"predict_disp{t}", nn.Sequential(
                nn.Conv2d(self.dec_planes[7 - t], 1, 3, 1, 1), nn.Sigmoid()))

    def forward(self, x):
        def head(t, h):
            d = _conv(getattr(self, f"predict_disp{t}")[0], h, self.precision)
            return 10.0 * torch.sigmoid(d) + 0.01
        return self._decode(x, head)


class FlowNet(EncoderDecoder):
    """Residual flow over 12 stacked channels; four 1x1 heads in float32,
    scaled by 0.1."""

    def __init__(self, precision="float32", scale=0.1):
        super().__init__(FLOW_IN_CHANNELS, 2, precision)
        self.scale = scale
        for t in (4, 3, 2, 1):
            setattr(self, f"flow{t}", nn.Conv2d(self.dec_planes[7 - t], 2, 1))

    def forward(self, x):
        def head(t, h):
            layer = getattr(self, f"flow{t}")
            return self.scale * F.conv2d(h, layer.weight, layer.bias)
        return self._decode(x, head)


class PoseNet(nn.Module):
    """Seven stride-2 convolutions over [target, sources], a 1x1 pose head
    in float32, a spatial mean and a 0.01 scale: (B, ns, 6)."""

    PLAN = ((16, 7), (32, 5), (64, 3), (128, 3), (256, 3), (256, 3),
            (256, 3))

    def __init__(self, num_source=2, precision="float32"):
        super().__init__()
        self.num_source, self.precision = num_source, precision
        c_in = 3 * (1 + num_source)
        for i, (features, k) in enumerate(self.PLAN):
            setattr(self, f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(c_in, features, k, 2, (k - 1) // 2), nn.ReLU()))
            c_in = features
        self.pred_poses = nn.Conv2d(c_in, 6 * num_source, 1)

    def forward(self, x):
        for i in range(len(self.PLAN)):
            x = F.relu(_conv(getattr(self, f"conv{i + 1}")[0], x,
                             self.precision))
        x = F.conv2d(x, self.pred_poses.weight, self.pred_poses.bias)
        pose = x.mean((2, 3))
        return 0.01 * pose.reshape(pose.shape[0], self.num_source, 6)


# --- camera geometry (reference `utils/utils_edited.py`) ------------------

def meshgrid(h, w, device, homogeneous=True):
    x = torch.arange(w, dtype=torch.float32, device=device)
    y = torch.arange(h, dtype=torch.float32, device=device)
    xg, yg = x[None, :].expand(h, w), y[:, None].expand(h, w)
    planes = [xg, yg] + ([torch.ones_like(xg)] if homogeneous else [])
    return torch.stack(planes, 0)


def euler2mat(z, y, x):
    """R = Rx @ Ry @ Rz, batched."""
    cz, sz, cy, sy, cx, sx = (torch.cos(z), torch.sin(z), torch.cos(y),
                              torch.sin(y), torch.cos(x), torch.sin(x))
    one, zero = torch.ones_like(z), torch.zeros_like(z)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    return rx @ ry @ rz


def pose_mat(vec, inverse):
    """[tx ty tz rx ry rz] -> (B, 4, 4); ``inverse`` gives [R^T, -R^T t]."""
    rot = euler2mat(vec[:, 5], vec[:, 4], vec[:, 3])
    t = vec[:, :3, None]
    if inverse:
        rot = rot.transpose(-1, -2)
        t = -rot @ t
    bottom = vec.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(vec.shape[0], 1, 4)
    return torch.cat([torch.cat([rot, t], 2), bottom], 1)


def rigid_flow(pose, depth, k, reverse):
    """Flow (B, 2, H, W) of the pose (B, 6) over depth (B, H, W) with
    intrinsics (B, 3, 3): project K [R|t] K^-1 depth pixels, z + 1e-10."""
    b, h, w = depth.shape
    pix = meshgrid(h, w, depth.device)[None].expand(b, 3, h, w)
    fx, fy, cx, cy = k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]
    xs = ((pix[:, 0] - cx[:, None, None]) / fx[:, None, None]) * depth
    ys = ((pix[:, 1] - cy[:, None, None]) / fy[:, None, None]) * depth
    cam = torch.stack([xs, ys, depth, torch.ones_like(depth)], 1)
    k4 = torch.zeros(b, 4, 4, device=k.device, dtype=k.dtype)
    k4[:, :3, :3] = k
    k4[:, 3, 3] = 1.0
    proj = k4 @ pose_mat(pose, reverse)
    p = torch.einsum("bij,bjhw->bihw", proj[:, :3], cam)
    uv = torch.stack([p[:, 0] / (p[:, 2] + 1e-10),
                      p[:, 1] / (p[:, 2] + 1e-10)], 1)
    return uv - pix[:, :2]


def scale_intrinsics(k, s):
    out = k.clone()
    out[:, :2, :] = k[:, :2, :] / (2 ** s)
    out[:, 2, :] = k[:, 2, :]
    return out


# --- photometric and smoothness terms ---------------------------------------

def dssim(x, y):
    """clip((1 - SSIM) / 2, 0, 1) over 3x3 zero-padded means (divisor 9),
    C1 = 0.01^2, C2 = 0.03^2; at a clip tie the gradient splits 0.5 / 0.5
    (``torch.minimum`` / ``maximum``)."""
    if work.active():
        work.note("K7", *work.dssim_fwd_call(x.numel()), names=DSSIM)
        sides = int(x.requires_grad) + int(y.requires_grad)
        if torch.is_grad_enabled() and sides:
            work.note("K7", *work.dssim_bwd_call(x.numel(), sides),
                      names=DSSIM)
    pool = lambda t: F.avg_pool2d(t, 3, 1, 1, count_include_pad=True)
    mu_x, mu_y = pool(x), pool(y)
    sx = pool(x * x) - mu_x * mu_x
    sy = pool(y * y) - mu_y * mu_y
    sxy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + 0.01 ** 2) * (2 * sxy + 0.03 ** 2)
    d = (mu_x * mu_x + mu_y * mu_y + 0.01 ** 2) * (sx + sy + 0.03 ** 2)
    s = (1.0 - n / d) * 0.5
    zero = s.new_zeros(())
    return torch.minimum(torch.maximum(s, zero), zero + 1.0)


def similarity(alpha, x, y):
    return alpha * dssim(x, y) + (1.0 - alpha) * torch.abs(x - y)


def _err(alpha, x, img, crd):
    """err(x, warp(img, crd)) per pixel and channel, without notes: inside
    the photo kernel."""
    warped = sample(img, crd, "edge_zero", note=False)
    with work.paused():
        return similarity(alpha, x, warped)


def photo_pair(tgt, srcs, cf, cb, alpha, wf=None, wb=None):
    """sum_s [err(tgt, warp(srcs_s, cf_s)) + err(srcs_s, warp(tgt, cb_s))],
    with weight planes ``wf`` / ``wb`` on the per-pixel channel sums: the
    port's K1 (K4 with weights)."""
    b, ns, c, h, w = srcs.shape
    if work.active():
        extra = [] if wf is None else [wf, wb]
        n_bytes, flops = work.photo_call(
            2 * b * ns * h * w, work.nbytes(tgt, srcs, cf, cb, *extra),
            work.nbytes(cf, cb), 0 if wf is None else 2)
        work.note("K4" if wf is not None else "K1", n_bytes, flops,
                  names=PHOTO)
    tgt_t = tgt[:, None].expand(b, ns, c, h, w).reshape(b * ns, c, h, w)
    src_f = srcs.reshape(b * ns, c, h, w)
    total = 0.0
    for x, img, crd, wgt in ((tgt_t, src_f, cf, wf), (src_f, tgt_t, cb, wb)):
        err = _err(alpha, x, img, crd.reshape(b * ns, 2, h, w))
        if wgt is not None:
            err = err * wgt.reshape(b * ns, 1, h, w)
        total = total + err.sum()
    return total


def photo_single(tgt, src, coords, alpha):
    """sum err(tgt, warp(src, coords)): the port's K3."""
    if work.active():
        b, c, h, w = tgt.shape
        with torch.no_grad():
            cells = work.touched_cells(coords, h, w, "edge_zero")
        work.note("K3", *work.photo_call(
            b * h * w, work.nbytes(tgt, coords) + 4.0 * c * cells,
            work.nbytes(coords)), names=PHOTO)
    return _err(alpha, tgt, src, coords).sum()


def smooth(depth, image):
    """Mean edge-aware smoothness of every depth plane (N, D, H, W) under
    its image (N, 3, H, W); gradients in ``depth`` only."""
    if work.active():
        work.note("K2", *work.smooth_call(depth.numel(), image.numel()),
                  names=SMOOTH)
    image = image.detach()
    gx = lambda t: t[..., :, :-1] - t[..., :, 1:]
    gy = lambda t: t[..., :-1, :] - t[..., 1:, :]
    wx = torch.exp(-torch.mean(torch.abs(gx(image)), 1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(gy(image)), 1, keepdim=True))
    return (torch.abs(gx(depth)) * wx).mean() + (torch.abs(gy(depth))
                                                  * wy).mean()


def flow_warp(img, flow):
    h, w = flow.shape[2:]
    return sample(img, meshgrid(h, w, flow.device, False)[None] + flow,
                  "edge_zero")


# --- the step ---------------------------------------------------------------

def preprocess(batch: dict, device) -> dict:
    """uint8 NHWC numpy -> float32 [-1, 1] NCHW tensors."""
    def unit(a):
        t = torch.as_tensor(a, device=device).float() * (1.0 / 255.0)
        return (t * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous()
    return {"tgt": unit(batch["tgt"]), "src": unit(batch["src"]),
            "intrinsics": torch.as_tensor(batch["intrinsics"],
                                          device=device).float()}


class GeoNetReference(nn.Module):
    """The nets under the port's checkpoint keys (``disp_net``,
    ``pose_net``, ``flow_net``) and the loss of one batch."""

    def __init__(self, cfg: dict, precision: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.disp_net = DispNetS(precision)
        self.pose_net = PoseNet(cfg["sequence_length"] - 1, precision)
        self.flow_net = (FlowNet(precision, cfg["flow_scale_factor"])
                         if cfg["train_flow"] else None)

    def loss(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        tgt, srcs = batch["tgt"], batch["src"]
        b = tgt.shape[0]
        ns = cfg["sequence_length"] - 1
        nv, scales, alpha = 1 + ns, cfg["num_scales"], cfg["simi_alpha"]
        views = torch.stack([tgt] + [srcs[:, 3 * s:3 * s + 3]
                                     for s in range(ns)], 1)
        flat = views.reshape(b * nv, *views.shape[2:])
        disps = self.disp_net(flat)
        poses = self.pose_net(torch.cat([tgt, srcs], 1)).reshape(b * ns, 6)
        pyr = [flat]
        for _ in range(scales - 1):
            pyr.append(F.avg_pool2d(pyr[-1], 2, 2))

        rigid = smooth_total = 0.0
        tgt_p, src_p, fwd_r, bwd_r = [], [], [], []
        warp0 = err0 = None
        for s in range(scales):
            hs, ws = pyr[s].shape[2:]
            v = pyr[s].reshape(b, nv, 3, hs, ws)
            k = scale_intrinsics(batch["intrinsics"], s)
            k = k[:, None].expand(b, ns, 3, 3).reshape(b * ns, 3, 3)
            depth = 1.0 / disps[s].reshape(b, nv, hs, ws)
            d_tgt = depth[:, :1].expand(b, ns, hs, ws).reshape(b * ns, hs, ws)
            d_src = depth[:, 1:].reshape(b * ns, hs, ws)
            fwd = rigid_flow(poses, d_tgt, k, False)
            bwd = rigid_flow(poses, d_src, k, True)
            grid = meshgrid(hs, ws, fwd.device, False)[None]
            denom = float(b * ns * 3 * hs * ws)
            if not cfg["train_flow"] or s > 0:
                pair = photo_pair(v[:, 0], v[:, 1:],
                                  (grid + fwd).reshape(b, ns, 2, hs, ws),
                                  (grid + bwd).reshape(b, ns, 2, hs, ws),
                                  alpha)
            if cfg["train_flow"]:
                t_s = v[:, :1].expand(b, ns, 3, hs, ws).reshape(
                    b * ns, 3, hs, ws)
                s_s = v[:, 1:].reshape(b * ns, 3, hs, ws)
                tgt_p.append(t_s)
                src_p.append(s_s)
                fwd_r.append(fwd)
                bwd_r.append(bwd)
                if s == 0:
                    warp0 = flow_warp(s_s, fwd)
                    err0 = similarity(alpha, t_s, warp0)
                    pair = err0.sum() + photo_single(s_s, t_s, grid + bwd,
                                                     alpha)
            rigid = rigid + (cfg["loss_weight_rigid_warp"] * ns / 2.0
                             * pair / denom)
            smooth_total = smooth_total + (
                cfg["loss_weight_disparity_smooth"] / 2 ** s
                * smooth(depth.reshape(b * nv, 1, hs, ws), pyr[s]))
        total = rigid + smooth_total
        if cfg["train_flow"]:
            total = total + self._flow_losses(tgt_p, src_p, fwd_r, bwd_r,
                                              warp0, err0)
        return total

    def _flow_losses(self, tgt_p, src_p, fwd_r, bwd_r, warp0, err0):
        cfg = self.cfg
        ns, alpha = cfg["sequence_length"] - 1, cfg["simi_alpha"]
        n = tgt_p[0].shape[0]

        def mag(e):
            return torch.linalg.vector_norm(e + 1e-10, dim=1, keepdim=True)
        bwarp0 = flow_warp(tgt_p[0], bwd_r[0])
        berr0 = similarity(alpha, src_p[0], bwarp0)
        fwd_in = torch.cat([tgt_p[0], src_p[0], warp0, fwd_r[0], mag(err0)],
                           1)
        bwd_in = torch.cat([src_p[0], tgt_p[0], bwarp0, bwd_r[0],
                            mag(berr0)], 1)
        res = self.flow_net(torch.stack([fwd_in, bwd_in], 1).reshape(
            2 * n, *fwd_in.shape[1:]))
        total = 0.0
        for s in range(cfg["num_scales"]):
            hs, ws = tgt_p[s].shape[2:]
            r = res[s].reshape(n, 2, 2, hs, ws)
            fwd = r[:, 0] + fwd_r[s]
            bwd = r[:, 1] + bwd_r[s]

            def consistency(flow, other):
                diff = torch.abs(flow_warp(other, flow) + flow)
                bound = torch.clamp_min(
                    cfg["geometric_consistency_beta"] * torch.abs(flow)
                    * 2 ** s, cfg["geometric_consistency_alpha"]).detach()
                mask = (diff * 2 ** s < bound).float().mean(1, keepdim=True)
                return diff, mask
            f_diff, f_mask = consistency(fwd, bwd)
            b_diff, b_mask = consistency(bwd, fwd)
            f_norm = f_mask.mean().clamp_min(1e-6)
            b_norm = b_mask.mean().clamp_min(1e-6)
            nelem = 3.0 * f_mask.numel()
            grid = meshgrid(hs, ws, fwd.device, False)[None]
            pair = photo_pair(tgt_p[s], src_p[s][:, None],
                              (grid + fwd)[:, None], (grid + bwd)[:, None],
                              alpha, f_mask / (f_norm * nelem),
                              b_mask / (b_norm * nelem))
            total = total + cfg["loss_weight_full_warp"] * ns / 2.0 * pair
            total = total + cfg["loss_weight_full_smooth"] / 2 ** (s + 1) * (
                smooth(fwd, tgt_p[s]) + smooth(bwd, src_p[s]))
            total = total + cfg["loss_weight_geometrical_consistency"] / 2.0 * (
                (f_diff.mean(1, keepdim=True) * f_mask).mean() / f_norm
                + (b_diff.mean(1, keepdim=True) * b_mask).mean() / b_norm)
        return total


class ReferenceTrainer:
    """The reference's train steps: the loss over the batch (in chunks of
    rows where every term is a mean over rows, stage 1), autograd, and
    Adam written out."""

    def __init__(self, cfg: dict, state_dict: dict, device,
                 precision: str = "float32", chunk: int | None = None):
        self.cfg, self.device = cfg, device
        self.model = GeoNetReference(cfg, precision).to(device)
        missing = self.model.load_state_dict(state_dict, strict=True)
        del missing
        self.params = dict(self.model.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.t = 0
        self.chunk = chunk if not cfg["train_flow"] else None

    def step(self, raw: dict) -> tuple[float, dict]:
        """One step on a raw batch; returns (loss, each leaf's gradient)."""
        batch = preprocess(raw, self.device)
        b = batch["tgt"].shape[0]
        size = self.chunk or b
        for p in self.params.values():
            p.grad = None
        loss_sum = 0.0
        for start in range(0, b, size):
            part = {k: v[start:start + size] for k, v in batch.items()}
            part_loss = self.model.loss(part) * (part["tgt"].shape[0] / b)
            part_loss.backward()
            loss_sum += float(part_loss.detach())
        self._adam()
        return loss_sum, {k: p.grad for k, p in self.params.items()}

    @torch.no_grad()
    def _adam(self):
        cfg = self.cfg
        b1, b2, lr = cfg["adam_beta1"], cfg["adam_beta2"], cfg["learning_rate"]
        self.t += 1
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + 1e-8))
