"""Edge-aware smoothness sums with the analytic depth gradient (K2).

Replaces the Pallas TPU kernel ``sndepth_tpu/kernels/smooth_loss.py``
(:func:`smooth_loss_sums` -> ``_run`` -> ``_kernel``) with a Triton kernel
for Hopper. GeoNet's disparity-smoothness term
(reference `models/loss_functions.py:8-24`) is

    gdx = d[:, :, :-1] - d[:, :, 1:],   wx = exp(-mean_c |img_x gradient|)
    gdy = d[:, :-1] - d[:, 1:],         wy = exp(-mean_c |img_y gradient|)
    sx = sum |gdx| * wx,                sy = sum |gdy| * wy

and, since the downstream cotangents are scalars, the depth gradients in
the same pass: d sx / d d[i, j] = sign(gdx[i, j]) wx[i, j] - sign(gdx[i,
j-1]) wx[i, j-1], and likewise for y. The image gets no gradient.

What bounds it on the card: DRAM bandwidth. One pass reads the depth and
image planes (16 bytes a pixel) and writes the two gradient planes (8
bytes) for ~40 flops; the neighbours j+-1, i+-1 come from L1/L2. The
design is one fused elementwise pass over 16x64 tiles with masked loads for
the ragged edges, and one partial sum per program instead of atomics, so
the result does not depend on scheduling. Nothing is reused across pixels
enough to be worth staging in shared memory by hand, which is why this one
is Triton rather than CUDA.

Layouts: depth (N, 1, H, W), image (N, C, H, W), float32, contiguous.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sndepth_tpu_torch.ops.pyramid import gradient_x, gradient_y

_BH, _BW = 16, 64
_kernel = None


def _check(depth, image) -> None:
    if depth.dim() != 4 or depth.shape[1] != 1 or image.dim() != 4:
        raise ValueError("expected depth (N, 1, H, W) and image (N, C, H, W)")
    n, c, h, w = image.shape
    if tuple(depth.shape) != (n, 1, h, w):
        raise ValueError(f"depth {tuple(depth.shape)} does not match image "
                         f"{tuple(image.shape)}")
    if h < 2 or w < 2:
        raise ValueError("H and W must be at least 2")
    for name, t in (("depth", depth), ("image", image)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if depth.device != image.device:
        raise ValueError("depth and image must be on one device")


def smooth_sums_reference(depth, image):
    """Plain PyTorch version: (sx, sy, d sx/d depth, d sy/d depth)."""
    d = depth[:, 0]
    wx = torch.exp(-torch.mean(torch.abs(gradient_x(image)), 1))
    wy = torch.exp(-torch.mean(torch.abs(gradient_y(image)), 1))
    gdx = gradient_x(d)
    gdy = gradient_y(d)
    px = torch.sign(gdx) * wx
    py = torch.sign(gdy) * wy
    ddx = F.pad(px, (0, 1)) - F.pad(px, (1, 0))
    ddy = F.pad(py, (0, 0, 0, 1)) - F.pad(py, (0, 0, 1, 0))
    return ((torch.abs(gdx) * wx).sum(), (torch.abs(gdy) * wy).sum(),
            ddx[:, None], ddy[:, None])


def _triton_kernel():
    # Triton resolves the names in a kernel through the module's globals, so
    # the imports bind there; they happen here, at first launch, because the
    # machines without a card have no triton.
    global _kernel, triton, tl
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def smooth_kernel(d_ptr, img_ptr, sx_ptr, sy_ptr, ddx_ptr, ddy_ptr, H, W,
                      C: tl.constexpr, BH: tl.constexpr, BW: tl.constexpr):
        pw = tl.program_id(0)
        ph = tl.program_id(1)
        n = tl.program_id(2).to(tl.int64)
        rows = ph * BH + tl.arange(0, BH)[:, None]
        cols = pw * BW + tl.arange(0, BW)[None, :]
        hw = H * W
        off = rows * W + cols
        inb = (rows < H) & (cols < W)
        has_r = (rows < H) & (cols < W - 1)      # gdx[i, j] exists
        has_l = inb & (cols >= 1)                # gdx[i, j-1] exists
        has_d = (rows < H - 1) & (cols < W)      # gdy[i, j] exists
        has_u = inb & (rows >= 1)                # gdy[i-1, j] exists

        dp = d_ptr + n * hw
        d_c = tl.load(dp + off, mask=inb, other=0.0)
        d_r = tl.load(dp + off + 1, mask=has_r, other=0.0)
        d_l = tl.load(dp + off - 1, mask=has_l, other=0.0)
        d_d = tl.load(dp + off + W, mask=has_d, other=0.0)
        d_u = tl.load(dp + off - W, mask=has_u, other=0.0)

        ga_r = tl.zeros((BH, BW), tl.float32)
        ga_l = tl.zeros((BH, BW), tl.float32)
        ga_d = tl.zeros((BH, BW), tl.float32)
        ga_u = tl.zeros((BH, BW), tl.float32)
        for c in tl.static_range(C):
            ip = img_ptr + (n * C + c) * hw
            i_c = tl.load(ip + off, mask=inb, other=0.0)
            ga_r += tl.abs(i_c - tl.load(ip + off + 1, mask=has_r, other=0.0))
            ga_l += tl.abs(tl.load(ip + off - 1, mask=has_l, other=0.0) - i_c)
            ga_d += tl.abs(i_c - tl.load(ip + off + W, mask=has_d, other=0.0))
            ga_u += tl.abs(tl.load(ip + off - W, mask=has_u, other=0.0) - i_c)
        wx_r = tl.where(has_r, tl.exp(-(ga_r / C)), 0.0)
        wx_l = tl.where(has_l, tl.exp(-(ga_l / C)), 0.0)
        wy_d = tl.where(has_d, tl.exp(-(ga_d / C)), 0.0)
        wy_u = tl.where(has_u, tl.exp(-(ga_u / C)), 0.0)

        gdx = d_c - d_r
        gdx_l = d_l - d_c
        gdy = d_c - d_d
        gdy_u = d_u - d_c
        pid = (n * tl.num_programs(1) + ph) * tl.num_programs(0) + pw
        tl.store(sx_ptr + pid, tl.sum(tl.sum(tl.abs(gdx) * wx_r, 1), 0))
        tl.store(sy_ptr + pid, tl.sum(tl.sum(tl.abs(gdy) * wy_d, 1), 0))

        sx_r = tl.where(gdx > 0, 1.0, tl.where(gdx < 0, -1.0, 0.0))
        sx_l = tl.where(gdx_l > 0, 1.0, tl.where(gdx_l < 0, -1.0, 0.0))
        sy_d = tl.where(gdy > 0, 1.0, tl.where(gdy < 0, -1.0, 0.0))
        sy_u = tl.where(gdy_u > 0, 1.0, tl.where(gdy_u < 0, -1.0, 0.0))
        tl.store(ddx_ptr + n * hw + off, sx_r * wx_r - sx_l * wx_l, mask=inb)
        tl.store(ddy_ptr + n * hw + off, sy_d * wy_d - sy_u * wy_u, mask=inb)

    _kernel = smooth_kernel
    return _kernel


def _launch(depth, image):
    n, c, h, w = image.shape
    kernel = _triton_kernel()
    grid = (-(-w // _BW), -(-h // _BH), n)
    nprog = grid[0] * grid[1] * grid[2]
    sx = torch.empty(nprog, dtype=torch.float32, device=depth.device)
    sy = torch.empty_like(sx)
    ddx = torch.empty_like(depth)
    ddy = torch.empty_like(depth)
    with torch.cuda.device(depth.device):
        kernel[grid](depth, image, sx, sy, ddx, ddy, h, w, C=c, BH=_BH,
                     BW=_BW, num_warps=4)
    smooth_sums.launches += 1
    return sx.sum(), sy.sum(), ddx, ddy


def smooth_sums(depth, image):
    """(sx, sy, d sx/d depth, d sy/d depth). A CUDA tensor launches the
    Triton kernel, and any failure raises; a CPU tensor takes the plain
    version."""
    _check(depth, image)
    if depth.device.type == "cuda":
        return _launch(depth, image)
    if depth.device.type == "cpu":
        return smooth_sums_reference(depth, image)
    raise ValueError(f"no smoothness kernel for device {depth.device}")


smooth_sums.launches = 0


class _SmoothSums(torch.autograd.Function):
    """The backward scales the saved gradient planes by the two incoming
    scalars; the image gets no gradient."""

    @staticmethod
    def forward(ctx, depth, image):
        sx, sy, ddx, ddy = smooth_sums(depth, image)
        ctx.save_for_backward(ddx, ddy)
        return sx, sy

    @staticmethod
    def backward(ctx, gx, gy):
        ddx, ddy = ctx.saved_tensors
        return gx * ddx + gy * ddy, None


def smooth_loss_sums(depth: torch.Tensor,
                     image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum |gdx| wx, sum |gdy| wy); differentiable in ``depth`` only."""
    return _SmoothSums.apply(depth, image)


def smooth_loss_fused(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Mean edge-aware smoothness: the sums over their element counts
    N*H*(W-1) and N*(H-1)*W."""
    n, _, h, w = depth.shape
    sx, sy = smooth_loss_sums(depth, image)
    return sx / (n * h * (w - 1)) + sy / (n * (h - 1) * w)
