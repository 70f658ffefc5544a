"""Bilinear warp gather (K5) and its image-gradient splat (K6).

Replace the Pallas TPU kernels of ``sndepth_tpu/kernels/warp.py``:
:func:`bilinear_sampler` (``_forward`` -> ``_fwd_kernel``, tap arithmetic
``_tap_setup``) and ``_scatter_d_imgs`` -> ``_splat`` (``_splat_kernel``),
with the CUDA C++ kernels ``csrc/warp.cu`` for Hopper (sm_90a).

The gather samples ``imgs`` at pixel ``coords`` in one of two modes:

``edge_zero``
    the GeoNet sampler. The corners ``floor(x)``, ``floor(x) + 1`` are
    clamped to the image *before* the weights are formed (``wx0 = x1c - x``,
    ``wx1 = x - x0c``), so a coordinate more than a pixel outside the image,
    or exactly on the last row or column, samples 0. ``floor`` and the clamp
    carry no gradient, so each weight's coordinate derivative is -1 or +1
    everywhere.
``zero_pad``
    standard zero-padded sampling: fractional weights times the validity of
    each corner, so an integer coordinate on the last row or column returns
    that pixel with weight 1; an invalid corner contributes no derivative.

Under differentiation in the coordinates the gather also writes the tangent
planes ``Tx = d out / dx`` and ``Ty = d out / dy`` from the same four loads,
so the coordinate gradient is the elementwise contraction ``sum_c g * Tx``,
``sum_c g * Ty``. The image gradient is the splat: the scatter-add of
``w_tap * g`` into the source plane, with the same taps.

What bounds them on the card: DRAM bytes. A gather with tangents reads 8
bytes of coordinates a pixel and writes 12 C (4 C without tangents); the
source plane comes through L2 because neighbouring pixels hit neighbouring
taps. The splat reads 8 + 4 C and adds into 4 C bytes a pixel through
atomics. The design is therefore one thread per target pixel with
coalesced coordinate loads and stores and nothing staged in shared memory.
The splat's float atomics add in an order that changes from run to run, so
its last bits do too.

Layouts: imgs (B, C, Hs, Ws), coords (B, 2, Ht, Wt) with channels (x, y) in
source pixels, out / Tx / Ty / g (B, C, Ht, Wt); float32, contiguous.
"""

from __future__ import annotations

import ctypes

import torch

MODES = {"edge_zero": 0, "zero_pad": 1}
_SOURCE = "warp.cu"
_lib = None


def _check(imgs, coords, mode: str, g=None) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if imgs is not None and imgs.dim() != 4:
        raise ValueError("expected imgs (B, C, Hs, Ws)")
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError("expected coords (B, 2, Ht, Wt)")
    named = [("imgs", imgs), ("coords", coords), ("g", g)]
    for name, t in named:
        if t is None:
            continue
        if t.shape[0] != coords.shape[0]:
            raise ValueError(f"{name} batch {t.shape[0]} does not match "
                             f"coords batch {coords.shape[0]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != coords.device:
            raise ValueError("all inputs must be on one device")
    if g is not None and (g.dim() != 4
                          or tuple(g.shape[2:]) != tuple(coords.shape[2:])):
        raise ValueError(f"g {tuple(g.shape)} does not match coords "
                         f"{tuple(coords.shape)}")


def _taps(coords: torch.Tensor, hs: int, ws: int, mode: str):
    """Tap indices, weights and weight-derivative magnitudes of ``coords``
    (the arithmetic of ``csrc/sampler.cuh``). Indices are (B, Ht*Wt) int64
    and always in range; weights and magnitudes are (B, 1, Ht, Wt)."""
    b = coords.shape[0]
    x, y = coords[:, 0:1], coords[:, 1:2]
    xf, yf = torch.floor(x), torch.floor(y)
    x0, x1 = xf.clamp(0.0, ws - 1.0), (xf + 1.0).clamp(0.0, ws - 1.0)
    y0, y1 = yf.clamp(0.0, hs - 1.0), (yf + 1.0).clamp(0.0, hs - 1.0)
    if mode == "edge_zero":
        wx0, wx1, wy0, wy1 = x1 - x, x - x0, y1 - y, y - y0
        one = torch.ones_like(x)
        dmask = (one, one, one, one)
    else:
        fx, fy = x - xf, y - yf
        dmask = tuple(((c >= 0.0) & (c <= size - 1.0)).to(x.dtype)
                      for c, size in ((xf, ws), (xf + 1.0, ws),
                                      (yf, hs), (yf + 1.0, hs)))
        wx0, wx1 = (1.0 - fx) * dmask[0], fx * dmask[1]
        wy0, wy1 = (1.0 - fy) * dmask[2], fy * dmask[3]

    def index(c, size):
        # The second clamp keeps a NaN coordinate's index in range; its
        # weight is NaN, so the sample is NaN.
        return c.long().clamp(0, size - 1).reshape(b, -1)

    x0i, x1i, y0i, y1i = index(x0, ws), index(x1, ws), index(y0, hs), index(y1, hs)
    idx = (y0i * ws + x0i, y1i * ws + x0i, y0i * ws + x1i, y1i * ws + x1i)
    return idx, (wx0, wx1, wy0, wy1), dmask


def _gather_taps(imgs: torch.Tensor, idx, ht: int, wt: int):
    b, c = imgs.shape[:2]
    flat = imgs.reshape(b, c, -1)
    return tuple(torch.gather(flat, 2, i[:, None].expand(b, c, ht * wt))
                 .reshape(b, c, ht, wt) for i in idx)


def sampler_reference(imgs: torch.Tensor, coords: torch.Tensor,
                      mode: str) -> torch.Tensor:
    """Plain PyTorch sampler, differentiable in both arguments by autograd:
    (B, C, Hs, Ws) sampled at (B, 2, Ht, Wt) -> (B, C, Ht, Wt)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    hs, ws = imgs.shape[2:]
    ht, wt = coords.shape[2:]
    idx, (wx0, wx1, wy0, wy1), _ = _taps(coords, hs, ws, mode)
    i00, i01, i10, i11 = _gather_taps(imgs, idx, ht, wt)
    return ((wx0 * wy0) * i00 + (wx0 * wy1) * i01
            + (wx1 * wy0) * i10 + (wx1 * wy1) * i11)


def warp_gather_reference(imgs, coords, mode: str, need_grad: bool):
    """Plain PyTorch version of the gather kernel: (out, Tx, Ty), the
    tangents ``None`` unless ``need_grad``. Nothing here is differentiable:
    the tangents are formed explicitly, as the kernel forms them."""
    hs, ws = imgs.shape[2:]
    ht, wt = coords.shape[2:]
    with torch.no_grad():
        idx, (wx0, wx1, wy0, wy1), (dx0, dx1, dy0, dy1) = _taps(
            coords, hs, ws, mode)
        i00, i01, i10, i11 = _gather_taps(imgs, idx, ht, wt)
        out = ((wx0 * wy0) * i00 + (wx0 * wy1) * i01
               + (wx1 * wy0) * i10 + (wx1 * wy1) * i11)
        if not need_grad:
            return out, None, None
        tx = wy0 * (dx1 * i10 - dx0 * i00) + wy1 * (dx1 * i11 - dx0 * i01)
        ty = wx0 * (dy1 * i01 - dy0 * i00) + wx1 * (dy1 * i11 - dy0 * i10)
    return out, tx, ty


def warp_splat_reference(coords, g, hs: int, ws: int, mode: str):
    """Plain PyTorch version of the splat kernel: ``index_add_`` of the
    weighted cotangent g (B, C, Ht, Wt) into zeroed (B, C, Hs, Ws) planes."""
    b, c = g.shape[:2]
    with torch.no_grad():
        idx, (wx0, wx1, wy0, wy1), _ = _taps(coords, hs, ws, mode)
        base = (torch.arange(b, device=g.device) * (hs * ws))[:, None]
        out = None
        for i, w in zip(idx, (wx0 * wy0, wx0 * wy1, wx1 * wy0, wx1 * wy1)):
            # One plane per tap, then the planes summed: the weights of taps
            # that clamp onto one pixel are exact negatives of each other, so
            # their planes cancel exactly, where terms added one by one into
            # a single plane would leave a float32 residue.
            tap = g.new_zeros(b * hs * ws, c).index_add_(
                0, (i + base).reshape(-1),
                (w * g).permute(0, 2, 3, 1).reshape(-1, c))
            out = tap if out is None else out + tap
    return out.reshape(b, hs, ws, c).permute(0, 3, 1, 2).contiguous()


def _library() -> ctypes.CDLL:
    """The built kernel library, with the launchers' C signatures set."""
    global _lib
    if _lib is None:
        from sndepth_tpu_torch.kernels.build import load_library
        lib = load_library(_SOURCE)
        lib.warp_gather_launch.restype = ctypes.c_int
        lib.warp_gather_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.warp_splat_launch.restype = ctypes.c_int
        lib.warp_splat_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _launch_gather(imgs, coords, mode: str, need_grad: bool):
    b, c, hs, ws = imgs.shape
    ht, wt = coords.shape[2:]
    lib = _library()
    out = torch.empty(b, c, ht, wt, dtype=torch.float32, device=imgs.device)
    tx = torch.empty_like(out) if need_grad else None
    ty = torch.empty_like(out) if need_grad else None
    with torch.cuda.device(imgs.device):
        rc = lib.warp_gather_launch(
            imgs.data_ptr(), coords.data_ptr(), out.data_ptr(),
            tx.data_ptr() if need_grad else None,
            ty.data_ptr() if need_grad else None,
            b, c, hs, ws, ht, wt, MODES[mode],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"warp gather launch failed: CUDA error {rc}")
    warp_gather.launches += 1
    return out, tx, ty


def _launch_splat(coords, g, hs: int, ws: int, mode: str):
    b, c, ht, wt = g.shape
    lib = _library()
    d_imgs = torch.zeros(b, c, hs, ws, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.warp_splat_launch(
            coords.data_ptr(), g.data_ptr(), d_imgs.data_ptr(),
            b, c, hs, ws, ht, wt, MODES[mode],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"warp splat launch failed: CUDA error {rc}")
    warp_splat.launches += 1
    return d_imgs


def warp_gather(imgs, coords, mode: str, need_grad: bool = False):
    """(out, Tx, Ty) of the gather; Tx, Ty are ``None`` unless
    ``need_grad``. A CUDA tensor launches the kernel, and any failure
    raises; a CPU tensor takes the plain version."""
    _check(imgs, coords, mode)
    if imgs.device.type == "cuda":
        return _launch_gather(imgs, coords, mode, need_grad)
    if imgs.device.type == "cpu":
        return warp_gather_reference(imgs, coords, mode, need_grad)
    raise ValueError(f"no warp kernel for device {imgs.device}")


def warp_splat(coords, g, hs: int, ws: int, mode: str):
    """The image gradient (B, C, hs, ws) of the gather for the cotangent
    ``g``. Dispatches by device as :func:`warp_gather`."""
    _check(None, coords, mode, g)
    if g.device.type == "cuda":
        return _launch_splat(coords, g, hs, ws, mode)
    if g.device.type == "cpu":
        return warp_splat_reference(coords, g, hs, ws, mode)
    raise ValueError(f"no warp kernel for device {g.device}")


warp_gather.launches = 0
warp_splat.launches = 0


class _BilinearSample(torch.autograd.Function):
    """Forward: the gather, with tangents when the coordinates want a
    gradient. Backward: the contraction of the cotangent with the saved
    tangents for the coordinates, and the splat for the images only when
    they want a gradient."""

    @staticmethod
    def forward(ctx, imgs, coords, mode):
        out, tx, ty = warp_gather(imgs, coords, mode, ctx.needs_input_grad[1])
        ctx.mode = mode
        ctx.src_hw = tuple(imgs.shape[2:])
        ctx.save_for_backward(coords, tx, ty)
        return out

    @staticmethod
    def backward(ctx, g):
        coords, tx, ty = ctx.saved_tensors
        g = g.contiguous()
        d_imgs = d_coords = None
        if ctx.needs_input_grad[0]:
            d_imgs = warp_splat(coords, g, *ctx.src_hw, ctx.mode)
        if ctx.needs_input_grad[1]:
            d_coords = torch.stack([(g * tx).sum(1), (g * ty).sum(1)], 1)
        return d_imgs, d_coords, None


def bilinear_sample(imgs: torch.Tensor, coords: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """Sample ``imgs`` at ``coords`` through the gather kernel (see the
    module docstring for modes and layouts); differentiable in both."""
    return _BilinearSample.apply(imgs, coords, mode)
