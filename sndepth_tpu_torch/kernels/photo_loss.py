"""Fused warp + photometric loss with its coordinate gradient (K1, K3, K4).

Replaces the Pallas TPU kernels of ``sndepth_tpu/kernels/photo_loss.py``
with the CUDA C++ kernel ``csrc/photo_pair.cu`` for Hopper (sm_90a), one
kernel in three modes:

K1 :func:`warp_photo_pair_loss` (``_pair_run`` -> ``_pair_kernel``)

    sum_s [ err(tgt,     warp(srcs[s], cf[s]))
          + err(srcs[s], warp(tgt,     cb[s])) ]

K4 :func:`warp_photo_pair_loss_weighted` (the same ``pallas_call`` with its
   ``weights`` input): K1 with each pixel's error, summed over channels,
   times a weight plane ``wf`` (first term) or ``wb`` (second term). The
   weights are constants and get no gradient.

K3 :func:`warp_photo_loss` (``_run`` -> ``_kernel``): the first term alone
   for one source, ``sum err(tgt, warp(src, coords))``.

err = alpha * DSSIM + (1 - alpha) * |x - y| summed over pixels and
channels, with the edge_zero sampler of :mod:`sndepth_tpu_torch.ops.warp`.
The same pass forms the gradient of the sum with respect to the
coordinates. The images get no gradient: at every call site they are input
frames.

What bounds it on the card: not DRAM but the data-dependent gathers and
how many of them are in flight; PERF.md's kernel table has the bytes and
operations per launch and the time beside that bound. The design keeps
every intermediate plane (warped image, SSIM terms, adjoint coefficients)
in shared memory and the tangents in registers, one block per 16x30 tile
with recomputed halos, so the only DRAM traffic is the inputs, the
gradient planes and one partial sum per block.
The TPU kernel's 8x128 tiling, SMEM tile metadata, band paths and row pools
were VMEM devices and have no counterpart here.

Layouts: tgt (B, 3, H, W), srcs (B, ns, 3, H, W), cf/cb (B, ns, 2, H, W)
with channels (x, y) in source pixels, wf/wb (B, ns, H, W); for K3 tgt, src
(B, 3, H, W) and coords (B, 2, H, W); all float32 and contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from sndepth_tpu_torch.ops.ssim import image_similarity_reference
from sndepth_tpu_torch.ops.warp import bilinear_sampler_reference
from sndepth_tpu_torch.utils import tracing

_SOURCE = "photo_pair.cu"
_lib = None


def _check(tgt, srcs, cf, cb=None, wf=None, wb=None) -> None:
    if srcs.dim() != 5 or tgt.dim() != 4:
        raise ValueError("expected tgt (B, C, H, W) and srcs (B, ns, C, H, W)")
    b, ns, c, h, w = srcs.shape
    if tuple(tgt.shape) != (b, c, h, w):
        raise ValueError(f"tgt {tuple(tgt.shape)} does not match srcs "
                         f"{tuple(srcs.shape)}")
    named = [("tgt", tgt), ("srcs", srcs)]
    for name, t, shape in (("cf", cf, (b, ns, 2, h, w)),
                           ("cb", cb, (b, ns, 2, h, w)),
                           ("wf", wf, (b, ns, h, w)),
                           ("wb", wb, (b, ns, h, w))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, want {shape}")
        named.append((name, t))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tgt.device:
            raise ValueError("all inputs must be on one device")
    if c != 3:
        raise ValueError(f"the kernel takes 3 channels, got {c}")
    if (wf is None) != (wb is None):
        raise ValueError("wf and wb come together")


def photo_pair_sums_reference(tgt, srcs, cf, cb, alpha: float,
                              wf=None, wb=None):
    """Plain PyTorch version of K1 and, with weights, K4: (loss sum,
    d loss/d cf, d loss/d cb), from the plain split ops (sampler, DSSIM,
    L1) and autograd. ``cb=None`` computes the first direction only (K3)
    and returns ``None`` for the second gradient."""
    b, ns, c, h, w = srcs.shape
    with torch.enable_grad():
        tgt_t = tgt.detach()[:, None].expand(b, ns, c, h, w).reshape(
            b * ns, c, h, w)
        src_f = srcs.detach().reshape(b * ns, c, h, w)
        coords, loss = [], 0.0
        for x, img, crd, wgt in ((tgt_t, src_f, cf, wf),
                                 (src_f, tgt_t, cb, wb)):
            if crd is None:
                continue
            crd = crd.detach().requires_grad_(True)
            coords.append(crd)
            warped = bilinear_sampler_reference(
                img, crd.reshape(b * ns, 2, h, w))
            err = image_similarity_reference(alpha, x, warped)
            if wgt is not None:
                err = err * wgt.detach().reshape(b * ns, 1, h, w)
            loss = loss + err.sum()
        grads = torch.autograd.grad(loss, coords)
    return (loss.detach(), grads[0], grads[1] if len(grads) > 1 else None)


def photo_sums_reference(tgt, src, coords, alpha: float):
    """Plain PyTorch version of K3: (loss sum, d loss/d coords)."""
    loss, d_c, _ = photo_pair_sums_reference(
        tgt, src[:, None], coords[:, None], None, alpha)
    return loss, d_c[:, 0]


def _library() -> ctypes.CDLL:
    """The built kernel library, with the launcher's C signature set."""
    global _lib
    if _lib is None:
        from sndepth_tpu_torch.kernels.build import load_library
        lib = load_library(_SOURCE)
        lib.photo_pair_launch.restype = ctypes.c_int
        lib.photo_pair_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        _lib = lib
    return _lib


def _launch(tgt, srcs, cf, cb, alpha: float, wf=None, wb=None):
    """Launch the kernel over both directions, or over the first only when
    ``cb`` is ``None``; returns (loss sum, d cf, d cb or None)."""
    b, ns, c, h, w = srcs.shape
    ndir = 1 if cb is None else 2
    lib = _library()
    th, tw = lib.photo_pair_tile_h(), lib.photo_pair_tile_w()
    nblocks = -(-w // tw) * -(-h // th) * b * ndir * ns
    loss_part = torch.empty(nblocks, dtype=torch.float32, device=tgt.device)
    d_cf = torch.empty_like(cf)
    d_cb = None if cb is None else torch.empty_like(cb)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.photo_pair_launch(
            ptr(tgt), ptr(srcs), ptr(cf), ptr(cb), ptr(wf), ptr(wb),
            ptr(loss_part), ptr(d_cf), ptr(d_cb),
            b, ns, ndir, c, h, w, float(alpha), float(1.0 - alpha), stream)
    if rc != 0:
        raise RuntimeError(f"photo_pair kernel launch failed: CUDA error {rc}")
    return loss_part.sum(), d_cf, d_cb


def _dispatch(kernel: str, tgt, srcs, cf, cb, alpha, wf=None, wb=None):
    """A CUDA tensor launches the kernel, counting one launch of
    ``kernel``, and any failure raises; a CPU tensor takes the plain
    version."""
    if tgt.device.type == "cuda":
        out = _launch(tgt, srcs, cf, cb, alpha, wf, wb)
        tracing.count(kernel)
        return out
    if tgt.device.type == "cpu":
        return photo_pair_sums_reference(tgt, srcs, cf, cb, alpha, wf, wb)
    raise ValueError(f"no photo_pair kernel for device {tgt.device}")


@tracing.span("kernel#K1")
def photo_pair_sums(tgt, srcs, cf, cb, alpha: float):
    """K1: (loss sum, d loss/d cf, d loss/d cb)."""
    _check(tgt, srcs, cf, cb)
    return _dispatch("K1", tgt, srcs, cf, cb, alpha)


@tracing.span("kernel#K4")
def photo_pair_weighted_sums(tgt, srcs, cf, cb, wf, wb, alpha: float):
    """K4: (weighted loss sum, d loss/d cf, d loss/d cb)."""
    _check(tgt, srcs, cf, cb, wf, wb)
    return _dispatch("K4", tgt, srcs, cf, cb, alpha, wf, wb)


@tracing.span("kernel#K3")
def photo_sums(tgt, src, coords, alpha: float):
    """K3: (loss sum, d loss/d coords) of one direction for one source;
    tgt, src (B, 3, H, W), coords (B, 2, H, W)."""
    if src.dim() != 4 or coords.dim() != 4:
        raise ValueError("expected src (B, C, H, W) and coords (B, 2, H, W)")
    srcs, cf = src[:, None], coords[:, None]
    _check(tgt, srcs, cf)
    loss, d_cf, _ = _dispatch("K3", tgt, srcs, cf, None, alpha)
    return loss, d_cf[:, 0]


class _PairLoss(torch.autograd.Function):
    """The backward is the incoming scalar times the gradient planes that
    the forward already formed; images and weights get no gradient."""

    @staticmethod
    def forward(ctx, tgt, srcs, cf, cb, wf, wb, alpha):
        if wf is None:
            loss, d_cf, d_cb = photo_pair_sums(tgt, srcs, cf, cb, alpha)
        else:
            loss, d_cf, d_cb = photo_pair_weighted_sums(tgt, srcs, cf, cb,
                                                        wf, wb, alpha)
        ctx.save_for_backward(d_cf, d_cb)
        return loss

    @staticmethod
    def backward(ctx, g):
        d_cf, d_cb = ctx.saved_tensors
        return None, None, g * d_cf, g * d_cb, None, None, None


class _SingleLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tgt, src, coords, alpha):
        loss, d_c = photo_sums(tgt, src, coords, alpha)
        ctx.save_for_backward(d_c)
        return loss

    @staticmethod
    def backward(ctx, g):
        d_c, = ctx.saved_tensors
        return None, None, g * d_c, None


def warp_photo_pair_loss(tgt: torch.Tensor, srcs: torch.Tensor,
                         cf: torch.Tensor, cb: torch.Tensor,
                         alpha: float) -> torch.Tensor:
    """Both rigid-warp loss directions over all sources, summed (see the
    module docstring for layouts); differentiable in ``cf`` and ``cb``."""
    return _PairLoss.apply(tgt, srcs, cf, cb, None, None, alpha)


def warp_photo_pair_loss_weighted(tgt: torch.Tensor, srcs: torch.Tensor,
                                  cf: torch.Tensor, cb: torch.Tensor,
                                  wf: torch.Tensor, wb: torch.Tensor,
                                  alpha: float) -> torch.Tensor:
    """:func:`warp_photo_pair_loss` with per-pixel weight planes ``wf``,
    ``wb`` (B, ns, H, W) on the two directions' errors; differentiable in
    ``cf`` and ``cb`` only."""
    return _PairLoss.apply(tgt, srcs, cf, cb, wf.detach(), wb.detach(), alpha)


def warp_photo_loss(tgt: torch.Tensor, src: torch.Tensor,
                    coords: torch.Tensor, alpha: float) -> torch.Tensor:
    """sum(alpha * DSSIM(tgt, warp(src, coords)) + (1 - alpha) * |tgt -
    warp|); differentiable in ``coords``."""
    return _SingleLoss.apply(tgt, src, coords, alpha)
