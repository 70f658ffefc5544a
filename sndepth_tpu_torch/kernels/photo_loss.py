"""Fused rigid-warp photometric pair loss with its coordinate gradient (K1).

Replaces the Pallas TPU kernel ``sndepth_tpu/kernels/photo_loss.py``
(:func:`warp_photo_pair_loss` -> ``_pair_run`` -> ``_pair_kernel``) with
the CUDA C++ kernel ``csrc/photo_pair.cu`` for Hopper (sm_90a). It computes

    sum_s [ err(tgt,     warp(srcs[s], cf[s]))
          + err(srcs[s], warp(tgt,     cb[s])) ]

with err = alpha * DSSIM + (1 - alpha) * |x - y| summed over pixels and
channels, the edge_zero sampler of :mod:`sndepth_tpu_torch.ops.warp`, and
in the same pass the gradient of that sum with respect to ``cf`` and
``cb``. The images get no gradient: at the stage-1 call site they are input
frames.

What bounds it on the card: not DRAM. A pixel and direction reads ~28
bytes (coords, comparison pixel, its share of the gathered source) and
writes 8, against ~600 flops of pools and adjoint algebra; the cost is the
latency of the data-dependent gathers and the shared-memory passes between
block barriers. The design keeps every intermediate plane (warped image,
tangents, SSIM terms, adjoint coefficients) in shared memory, one block per
16x32 tile with recomputed halos, so the only DRAM traffic is the inputs,
the two gradient planes and one partial sum per block. The TPU kernel's
8x128 tiling, SMEM tile metadata, band paths and row pools were VMEM
devices and have no counterpart here.

Layouts: tgt (B, 3, H, W), srcs (B, ns, 3, H, W), cf/cb (B, ns, 2, H, W)
with channels (x, y) in source pixels; all float32 and contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from sndepth_tpu_torch.ops.ssim import image_similarity
from sndepth_tpu_torch.ops.warp import bilinear_sampler

_SOURCE = "photo_pair.cu"
_lib = None


def _check(tgt, srcs, cf, cb) -> None:
    if srcs.dim() != 5 or tgt.dim() != 4:
        raise ValueError("expected tgt (B, C, H, W) and srcs (B, ns, C, H, W)")
    b, ns, c, h, w = srcs.shape
    if tuple(tgt.shape) != (b, c, h, w):
        raise ValueError(f"tgt {tuple(tgt.shape)} does not match srcs "
                         f"{tuple(srcs.shape)}")
    for name, t in (("cf", cf), ("cb", cb)):
        if tuple(t.shape) != (b, ns, 2, h, w):
            raise ValueError(f"{name} {tuple(t.shape)}, want "
                             f"{(b, ns, 2, h, w)}")
    for name, t in (("tgt", tgt), ("srcs", srcs), ("cf", cf), ("cb", cb)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tgt.device:
            raise ValueError("all inputs must be on one device")
    if c != 3:
        raise ValueError(f"the kernel takes 3 channels, got {c}")


def photo_pair_sums_reference(tgt, srcs, cf, cb, alpha: float):
    """Plain PyTorch version: (loss sum, d loss/d cf, d loss/d cb), from the
    split ops (sampler, DSSIM, L1) and autograd."""
    b, ns, c, h, w = srcs.shape
    with torch.enable_grad():
        cf_ = cf.detach().requires_grad_(True)
        cb_ = cb.detach().requires_grad_(True)
        tgt_t = tgt.detach()[:, None].expand(b, ns, c, h, w).reshape(
            b * ns, c, h, w)
        src_f = srcs.detach().reshape(b * ns, c, h, w)
        fwd = bilinear_sampler(src_f, cf_.reshape(b * ns, 2, h, w))
        bwd = bilinear_sampler(tgt_t, cb_.reshape(b * ns, 2, h, w))
        loss = (image_similarity(alpha, tgt_t, fwd).sum()
                + image_similarity(alpha, src_f, bwd).sum())
        d_cf, d_cb = torch.autograd.grad(loss, (cf_, cb_))
    return loss.detach(), d_cf, d_cb


def _library() -> ctypes.CDLL:
    """The built kernel library, with the launcher's C signature set."""
    global _lib
    if _lib is None:
        from sndepth_tpu_torch.kernels.build import load_library
        lib = load_library(_SOURCE)
        lib.photo_pair_launch.restype = ctypes.c_int
        lib.photo_pair_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        _lib = lib
    return _lib


def _launch(tgt, srcs, cf, cb, alpha: float):
    b, ns, c, h, w = srcs.shape
    lib = _library()
    th, tw = lib.photo_pair_tile_h(), lib.photo_pair_tile_w()
    nblocks = -(-w // tw) * -(-h // th) * b * 2 * ns
    loss_part = torch.empty(nblocks, dtype=torch.float32, device=tgt.device)
    d_cf = torch.empty_like(cf)
    d_cb = torch.empty_like(cb)
    with torch.cuda.device(tgt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.photo_pair_launch(
            tgt.data_ptr(), srcs.data_ptr(), cf.data_ptr(), cb.data_ptr(),
            loss_part.data_ptr(), d_cf.data_ptr(), d_cb.data_ptr(),
            b, ns, c, h, w, float(alpha), float(1.0 - alpha), stream)
    if rc != 0:
        raise RuntimeError(f"photo_pair kernel launch failed: CUDA error {rc}")
    photo_pair_sums.launches += 1
    return loss_part.sum(), d_cf, d_cb


def photo_pair_sums(tgt, srcs, cf, cb, alpha: float):
    """(loss sum, d loss/d cf, d loss/d cb). A CUDA tensor launches the
    kernel, and any failure raises; a CPU tensor takes the plain version."""
    _check(tgt, srcs, cf, cb)
    if tgt.device.type == "cuda":
        return _launch(tgt, srcs, cf, cb, alpha)
    if tgt.device.type == "cpu":
        return photo_pair_sums_reference(tgt, srcs, cf, cb, alpha)
    raise ValueError(f"no photo_pair kernel for device {tgt.device}")


photo_pair_sums.launches = 0


class _PairLoss(torch.autograd.Function):
    """The backward is the incoming scalar times the gradient planes that
    the forward already formed; the images get no gradient."""

    @staticmethod
    def forward(ctx, tgt, srcs, cf, cb, alpha):
        loss, d_cf, d_cb = photo_pair_sums(tgt, srcs, cf, cb, alpha)
        ctx.save_for_backward(d_cf, d_cb)
        return loss

    @staticmethod
    def backward(ctx, g):
        d_cf, d_cb = ctx.saved_tensors
        return None, None, g * d_cf, g * d_cb, None


def warp_photo_pair_loss(tgt: torch.Tensor, srcs: torch.Tensor,
                         cf: torch.Tensor, cb: torch.Tensor,
                         alpha: float) -> torch.Tensor:
    """Both rigid-warp loss directions over all sources, summed (see the
    module docstring for layouts); differentiable in ``cf`` and ``cb``."""
    return _PairLoss.apply(tgt, srcs, cf, cb, alpha)
