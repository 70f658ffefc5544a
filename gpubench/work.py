"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel call could take, and a log of the calls a reference makes.

Every count is of the work, not of how the port does it: each input read
once, each output written once, and the operations the algorithm needs.
Where the samples of a gather fall partly outside the image, only the image
cells that in-range taps touch are counted as read. The per-call operation
counts are frozen from ``chip_smoke.py``'s (photo 419 a pixel, direction and
source; DSSIM 100 and its adjoint 170 a pixel and channel; smoothness 40 a
depth element; gather 20 + 7 C, coordinate gradient 20 + 22 C, splat
20 + 8 C a sample).

The plain references call :func:`note` at each place where the port would
launch a hand-written kernel, with the names its device kernels carry;
inside :func:`recording` the calls land in a list, elsewhere :func:`note`
does nothing.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
PEAK_FLOPS_PER_S = {"float32": FP32_FLOPS_PER_S, "tf32": TF32_FLOPS_PER_S,
                    "bfloat16": BF16_FLOPS_PER_S}

PHOTO_FLOPS = 419
DSSIM_FWD_FLOPS = 100
DSSIM_BWD_FLOPS = 170
SMOOTH_FLOPS = 40


def gather_flops(c: int) -> int:
    return 20 + 7 * c


def coord_grad_flops(c: int) -> int:
    return 20 + 22 * c


def splat_flops(c: int) -> int:
    return 20 + 8 * c


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time a call could take: its bytes at the memory rate
    against its operations at the float32 rate (every hand-written kernel
    computes in float32)."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def touched_cells(coords: torch.Tensor, hs: int, ws: int, mode: str) -> int:
    """Distinct image cells, summed over the batch, that the taps of
    ``coords`` (B, 2, Ht, Wt) read with a weight that can be nonzero:
    ``edge_zero`` clamps every tap into the image, ``zero_pad`` drops the
    taps that fall outside it."""
    b = coords.shape[0]
    x = coords[:, 0].reshape(b, -1).double()
    y = coords[:, 1].reshape(b, -1).double()
    xf, yf = torch.floor(x), torch.floor(y)
    cells = []
    for dx in (0.0, 1.0):
        for dy in (0.0, 1.0):
            tx, ty = xf + dx, yf + dy
            if mode == "edge_zero":
                tx, ty = tx.clamp(0, ws - 1), ty.clamp(0, hs - 1)
                ok = torch.isfinite(tx) & torch.isfinite(ty)
            else:
                ok = (tx >= 0) & (tx <= ws - 1) & (ty >= 0) & (ty <= hs - 1)
            flat = (ty.clamp(0, hs - 1) * ws + tx.clamp(0, ws - 1)).long()
            batch = torch.arange(b, device=coords.device)[:, None].expand_as(
                flat)
            cells.append((batch * (hs * ws) + flat)[ok])
    return int(torch.unique(torch.cat(cells)).numel())


def gather_call(c: int, hs: int, ws: int, coords_shape, cells: int | None
                ) -> tuple[float, float]:
    """(bytes, operations) of the gather K5 on a (B, C, Hs, Ws) float32
    image at (B, 2, Ht, Wt) coordinates; ``cells`` is how many image cells
    the taps touch (``None``: every cell of every image)."""
    b, _, ht, wt = coords_shape
    npix = b * ht * wt
    cells = b * hs * ws if cells is None else cells
    return (4.0 * (cells * c + 2 * npix + c * npix),
            float(npix * gather_flops(c)))


def coord_grad_call(c: int, hs: int, ws: int, coords_shape,
                    cells: int | None) -> tuple[float, float]:
    """(bytes, operations) of K5b: the image cells touched, the coordinates
    and the cotangent read, the coordinates' gradient written."""
    b, _, ht, wt = coords_shape
    npix = b * ht * wt
    cells = b * hs * ws if cells is None else cells
    return (4.0 * (cells * c + 2 * npix + c * npix + 2 * npix),
            float(npix * coord_grad_flops(c)))


def splat_call(c: int, hs: int, ws: int, coords_shape
               ) -> tuple[float, float]:
    """(bytes, operations) of K6: coordinates and cotangent read, the
    image's gradient (B, C, Hs, Ws) written."""
    b, _, ht, wt = coords_shape
    npix = b * ht * wt
    return (4.0 * (2 * npix + c * npix + b * c * hs * ws),
            float(npix * splat_flops(c)))


def photo_call(n_pixels: int, in_bytes: float, out_bytes: float,
               extra_flops: int = 0) -> tuple[float, float]:
    """(bytes, operations) of the photo kernel (K1, K3, K4) over
    ``n_pixels`` pixel-direction-sources."""
    return (in_bytes + out_bytes,
            float((PHOTO_FLOPS + extra_flops) * n_pixels))


def dssim_fwd_call(numel: int) -> tuple[float, float]:
    """x and y read, the map written (B, C, H, W) float32."""
    return 4.0 * 3 * numel, float(DSSIM_FWD_FLOPS * numel)


def dssim_bwd_call(numel: int, sides: int) -> tuple[float, float]:
    """x, y and the cotangent read, ``sides`` gradients written."""
    return 4.0 * (3 + sides) * numel, float(DSSIM_BWD_FLOPS * numel)


def smooth_call(depth_numel: int, image_numel: int) -> tuple[float, float]:
    """Depth and image read, the two gradient planes written."""
    return (4.0 * (3 * depth_numel + image_numel),
            float(SMOOTH_FLOPS * depth_numel))


_LOG: contextvars.ContextVar = contextvars.ContextVar("gpubench_work_log",
                                                      default=None)


@contextlib.contextmanager
def recording():
    """Collect the :func:`note` calls made inside as a list of
    ``(kernel, bytes, operations, names)``."""
    log: list = []
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


@contextlib.contextmanager
def paused():
    """No :func:`note` lands inside: the work of a kernel's inner parts is
    noted by the kernel's own note."""
    token = _LOG.set(None)
    try:
        yield
    finally:
        _LOG.reset(token)


def active() -> bool:
    return _LOG.get() is not None


def note(kernel: str, n_bytes: float, flops: float, *,
         names: tuple) -> None:
    """One call of a hand-written kernel: its id, its bytes and operations,
    and ``names``, substrings of the device kernel names whose time in a
    trace is this kernel's (so that a new kernel needs no table here)."""
    log = _LOG.get()
    if log is not None:
        log.append((kernel, float(n_bytes), float(flops), tuple(names)))


def bound_by_kernel(log: list, per: int = 1) -> dict:
    """Seconds of bound by kernel over a log, divided by ``per`` (the steps
    or frames the log covers)."""
    out: dict[str, float] = {}
    for kernel, n_bytes, flops, _ in log:
        out[kernel] = out.get(kernel, 0.0) + bound_s(n_bytes, flops) / per
    return out


def names_by_kernel(log: list) -> dict:
    """Each logged kernel's device kernel names."""
    out: dict[str, set] = {}
    for kernel, _, _, names in log:
        out.setdefault(kernel, set()).update(names)
    return {k: tuple(sorted(v)) for k, v in out.items()}


