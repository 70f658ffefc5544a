"""DSSIM map and its adjoint (K7).

Replaces the Pallas TPU kernels of ``sndepth_tpu/kernels/dssim.py``
(:func:`dssim_pallas`: ``_dssim_forward`` -> ``_dssim_kernel`` and
``_dssim_backward`` -> ``_dssim_bwd_kernel``) with the CUDA C++ kernels
``csrc/dssim.cu`` for Hopper (sm_90a):

    DSSIM(x, y) = clip((1 - SSIM(x, y)) / 2, 0, 1)

per pixel and channel, with 3x3 stride-1 average pools zero-padded by 1
with divisor 9, C1 = 0.01^2 and C2 = 0.03^2 (reference
`utils/utils_edited.py:121-141`). The backward takes a cotangent plane g
and writes dX = P(A_x) + 2 x P(B) + y P(Cxy) and the symmetric dY in one
pass (``csrc/ssim.cuh``); a side that wants no gradient is not written.

The clip is ``minimum(maximum(s, 0), 1)``: torch's binary max/min split the
gradient 0.5/0.5 at a tie, as JAX's ``clip`` does, while ``torch.clamp``
passes the whole gradient. DSSIM hits exactly 0 wherever the two windows
are equal, so the tie rule shows in real gradients; the kernel applies the
same 0.5 factor.

What bounds it on the card: DRAM bytes. The forward moves 12 bytes a
pixel and channel (x, y in, the map out) for ~100 operations, the backward
12 in and 4 or 8 out for ~170. Warps walk strips of columns down segments
of rows in registers, neighbours by shuffle, with recomputed halos (1
pixel forward, 2 pixels backward), so the five pools, the SSIM terms and
the four adjoint coefficient planes never reach DRAM, where the plain
version round-trips each of them.

Layout: x, y, g (B, C, H, W), float32, contiguous.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2
_SOURCE = "dssim.cu"
_lib = None


def _check(x, y, g=None) -> None:
    if x.dim() != 4:
        raise ValueError("expected x (B, C, H, W)")
    for name, t in (("x", x), ("y", y), ("g", g)):
        if t is None:
            continue
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"{name} {tuple(t.shape)} does not match x "
                             f"{tuple(x.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")


def avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean over an NCHW tensor, zero-padded, divisor 9."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def dssim_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch DSSIM map, differentiable by autograd."""
    mu_x = avg_pool3(x)
    mu_y = avg_pool3(y)
    sigma_x = avg_pool3(x * x) - mu_x * mu_x
    sigma_y = avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = avg_pool3(x * y) - mu_x * mu_y
    ssim_n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    s = (1.0 - ssim_n / ssim_d) * 0.5
    zero = s.new_zeros(())
    return torch.minimum(torch.maximum(s, zero), zero + 1.0)


def dssim_backward_reference(x, y, g, need_dx: bool, need_dy: bool):
    """Plain PyTorch version of the backward kernel: (dX, dY) of
    ``sum(DSSIM(x, y) * g)`` by autograd through :func:`dssim_reference`;
    a side that is not needed is ``None``."""
    with torch.enable_grad():
        x_ = x.detach().requires_grad_(need_dx)
        y_ = y.detach().requires_grad_(need_dy)
        wanted = [t for t, need in ((x_, need_dx), (y_, need_dy)) if need]
        grads = list(torch.autograd.grad(dssim_reference(x_, y_), wanted, g))
    return (grads.pop(0) if need_dx else None,
            grads.pop(0) if need_dy else None)


def _library() -> ctypes.CDLL:
    """The built kernel library, with the launchers' C signatures set."""
    global _lib
    if _lib is None:
        from sndepth_tpu_torch.kernels.build import load_library
        lib = load_library(_SOURCE)
        lib.dssim_fwd_launch.restype = ctypes.c_int
        lib.dssim_fwd_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.dssim_bwd_launch.restype = ctypes.c_int
        lib.dssim_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _launch_forward(x, y):
    b, c, h, w = x.shape
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.dssim_fwd_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), b * c, h, w,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dssim forward launch failed: CUDA error {rc}")
    dssim_forward.launches += 1
    return out


def _launch_backward(x, y, g, need_dx: bool, need_dy: bool):
    b, c, h, w = x.shape
    lib = _library()
    dx = torch.empty_like(x) if need_dx else None
    dy = torch.empty_like(y) if need_dy else None
    with torch.cuda.device(x.device):
        rc = lib.dssim_bwd_launch(
            x.data_ptr(), y.data_ptr(), g.data_ptr(),
            dx.data_ptr() if need_dx else None,
            dy.data_ptr() if need_dy else None, b * c, h, w,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dssim backward launch failed: CUDA error {rc}")
    dssim_backward.launches += 1
    return dx, dy


def dssim_forward(x, y):
    """The DSSIM map. A CUDA tensor launches the kernel, and any failure
    raises; a CPU tensor takes the plain version."""
    _check(x, y)
    if x.device.type == "cuda":
        return _launch_forward(x, y)
    if x.device.type == "cpu":
        with torch.no_grad():
            return dssim_reference(x, y)
    raise ValueError(f"no dssim kernel for device {x.device}")


def dssim_backward(x, y, g, need_dx: bool = True, need_dy: bool = True):
    """(dX, dY) for the cotangent ``g``; a side that is not needed is
    ``None``. Dispatches by device as :func:`dssim_forward`."""
    _check(x, y, g)
    if not (need_dx or need_dy):
        return None, None
    if x.device.type == "cuda":
        return _launch_backward(x, y, g, need_dx, need_dy)
    if x.device.type == "cpu":
        return dssim_backward_reference(x, y, g, need_dx, need_dy)
    raise ValueError(f"no dssim kernel for device {x.device}")


dssim_forward.launches = 0
dssim_backward.launches = 0


class _Dssim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return dssim_forward(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return dssim_backward(x, y, g.contiguous(), *ctx.needs_input_grad)


def dssim_map(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel structural dissimilarity in [0, 1] through the kernels;
    differentiable in both arguments."""
    return _Dssim.apply(x, y)
