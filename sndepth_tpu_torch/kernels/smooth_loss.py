"""Edge-aware smoothness sums with the analytic depth gradient (K2).

Replaces the Pallas TPU kernel ``sndepth_tpu/kernels/smooth_loss.py``
(:func:`smooth_loss_sums` -> ``_run`` -> ``_kernel``) with the CUDA C++
kernel ``csrc/smooth_loss.cu`` for Hopper (sm_90a). GeoNet's
disparity-smoothness term (reference `models/loss_functions.py:8-24`) is

    gdx = d[:, :, :-1] - d[:, :, 1:],   wx = exp(-mean_c |img_x gradient|)
    gdy = d[:, :-1] - d[:, 1:],         wy = exp(-mean_c |img_y gradient|)
    sx = sum |gdx| * wx,                sy = sum |gdy| * wy

and, since the downstream cotangents are scalars, the depth gradients in
the same pass: d sx / d d[i, j] = sign(gdx[i, j]) wx[i, j] - sign(gdx[i,
j-1]) wx[i, j-1], and likewise for y. The image gets no gradient.

The depth may have D = 1 or 2 planes a sample, which share the sample's
image: D = 2 is a flow, whose two channels the reference smooths one at a
time under the same image (`loss_functions.py:26-32`). The sums then run
over both planes, and the kernel reads the image and forms its edge weights
once for both.

What bounds it on the card: DRAM bandwidth, ~40 operations a pixel and
plane against 24 bytes at D = 1 (the depth and three image channels in,
the two gradient planes out). A warp walks a strip of columns down the
rows, loading several rows at once, keeps the row above in registers and
takes its neighbours by shuffle; the per-block sums are added in a fixed
order in the same launch (``csrc/smooth_loss.cu``).

Layouts: depth (N, D, H, W), image (N, C, H, W), float32, contiguous; the
kernel is built for C = 3, the plain version takes any C.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sndepth_tpu_torch.ops.pyramid import gradient_x, gradient_y

_SOURCE = "smooth_loss.cu"
_lib = None
# The kernel's ticket word for each (device, stream): the last block of a
# call takes the last ticket and sets the word back to 0. Calls on one
# stream run in turn, so one word a stream lets calls on different streams
# overlap.
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _check(depth, image) -> None:
    if depth.dim() != 4 or image.dim() != 4:
        raise ValueError("expected depth (N, D, H, W) and image (N, C, H, W)")
    n, _, h, w = image.shape
    d = depth.shape[1]
    if d not in (1, 2):
        raise ValueError(f"depth must have 1 or 2 planes a sample, got {d}")
    if tuple(depth.shape) != (n, d, h, w):
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
    """Plain PyTorch version: (sx, sy, d sx/d depth, d sy/d depth), the sums
    over every depth plane, each under the sample's image."""
    wx = torch.exp(-torch.mean(torch.abs(gradient_x(image)), 1, keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(gradient_y(image)), 1, keepdim=True))
    gdx = gradient_x(depth)
    gdy = gradient_y(depth)
    px = torch.sign(gdx) * wx
    py = torch.sign(gdy) * wy
    ddx = F.pad(px, (0, 1)) - F.pad(px, (1, 0))
    ddy = F.pad(py, (0, 0, 0, 1)) - F.pad(py, (0, 0, 1, 0))
    return ((torch.abs(gdx) * wx).sum(), (torch.abs(gdy) * wy).sum(), ddx,
            ddy)


def _library() -> ctypes.CDLL:
    """The built kernel library, with the launcher's C signatures set."""
    global _lib
    if _lib is None:
        from sndepth_tpu_torch.kernels.build import load_library
        lib = load_library(_SOURCE)
        lib.smooth_out_floats.restype = ctypes.c_longlong
        lib.smooth_out_floats.argtypes = [ctypes.c_int] * 4
        lib.smooth_launch.restype = ctypes.c_int
        lib.smooth_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _launch(depth, image):
    n, c, h, w = image.shape
    d = depth.shape[1]
    if c != 3:
        raise ValueError(f"the smoothness kernel takes 3 image channels, "
                         f"got {c}")
    lib = _library()
    ddx = torch.empty_like(depth)
    ddy = torch.empty_like(depth)
    size = lib.smooth_out_floats(n, d, h, w)
    out = torch.empty(size, dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = (depth.device.index, stream)
        if key not in _tickets:
            _tickets[key] = torch.zeros(1, dtype=torch.int32,
                                        device=depth.device)
        rc = lib.smooth_launch(
            depth.data_ptr(), image.data_ptr(), out.data_ptr(), size,
            ddx.data_ptr(), ddy.data_ptr(), _tickets[key].data_ptr(), n, d,
            c, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"smoothness launch failed: CUDA error {rc}")
    smooth_sums.launches += 1
    return out[0], out[1], ddx, ddy


def smooth_sums(depth, image):
    """(sx, sy, d sx/d depth, d sy/d depth). A CUDA tensor launches the
    kernel, and any failure raises; a CPU tensor takes the plain version."""
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
    """(sum |gdx| wx, sum |gdy| wy) over every depth plane; differentiable
    in ``depth`` only."""
    return _SmoothSums.apply(depth, image)


def smooth_loss_fused(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Mean edge-aware smoothness: the sums over their element counts
    N*D*H*(W-1) and N*D*(H-1)*W, so that D = 2 gives the mean of the two
    planes' losses."""
    n, d, h, w = depth.shape
    sx, sy = smooth_loss_sums(depth, image)
    return sx / (n * d * h * (w - 1)) + sy / (n * d * (h - 1) * w)
