"""Bilinear warp gather (K5), its coordinate gradient (K5b) and its
image-gradient splat (K6).

Replace the Pallas TPU kernels of ``sndepth_tpu/kernels/warp.py``:
:func:`bilinear_sampler` (``_forward`` -> ``_fwd_kernel``, tap arithmetic
``_tap_setup``, and the tangent contraction of its VJP) and
``_scatter_d_imgs`` -> ``_splat`` (``_splat_kernel``), with the CUDA C++
kernels ``csrc/warp.cu`` for Hopper (sm_90a).

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

The gather writes the samples only. The coordinate gradient is a kernel of
its own that reads the four taps again and contracts their tangents
``d out / dx``, ``d out / dy`` with the cotangent over the channels, in
ascending order; the image gradient is the splat, the scatter-add of
``w_tap * g`` into the source plane with the same taps. So the autograd
function keeps ``(imgs, coords)`` for its backward and no tangent planes.

What bounds them on the card: DRAM bytes. The gather reads 8 bytes of
coordinates a pixel and writes 4 C; the coordinate gradient reads 8 + 4 C
and writes 8; the source plane comes through L2 because neighbouring pixels
hit neighbouring taps. Both take four consecutive pixels a thread on a
large problem (B Ht Wt from 2^20, where scattered taps want many loads in
flight) and two on a smaller one (more threads fill the card), with
vector loads and stores, where the plane size allows it. Threads run over
all planes at once, so small planes share a block; where C is large, a
thread loads the taps of 8 (channel, pixel) samples at once, and where the
pixels are few the gather splits the channels into groups, one a thread;
zero_pad reads no tap of a warp whose samples all lie wholly outside the
image (``csrc/warp.cu`` has the whole design;
:func:`sampler_launch_config` says what a call launches). The splat reads
8 + 4 C bytes a pixel and writes 4 C a source cell. Where a (b, c) source
plane fits the card's shared memory (58K cells on an H100), one block
builds it whole there and stores it, in up to 32 copies summed in a fixed
order where they fit (a small plane's cells then each sum shorter chains
of taps); a larger plane takes the tile
path, which accumulates a tile's taps in shared memory where their bounding
box fits (:func:`splat_shared_share` says which tiles do) and adds into
zeroed planes in device memory. Its float atomics add in an order that
changes from run to run, so its last bits do too.

Layouts: imgs (B, C, Hs, Ws), coords (B, 2, Ht, Wt) with channels (x, y) in
source pixels, out / g (B, C, Ht, Wt), d coords (B, 2, Ht, Wt); float32,
contiguous.
"""

from __future__ import annotations

import ctypes

import torch

MODES = {"edge_zero": 0, "zero_pad": 1}
_SOURCE = "warp.cu"
_lib = None


def _check(imgs, coords, mode: str, g=None) -> None:
    """Raise on what the kernels do not take. It runs before every launch,
    so it reads each attribute once."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    cs = coords.shape
    if len(cs) != 4 or cs[1] != 2:
        raise ValueError("expected coords (B, 2, Ht, Wt)")
    device = coords.device
    for name, t in (("imgs", imgs), ("coords", coords), ("g", g)):
        if t is None:
            continue
        shape = t.shape
        if len(shape) != 4:
            raise ValueError(f"expected {name} (B, C, H, W)")
        if shape[0] != cs[0]:
            raise ValueError(f"{name} batch {shape[0]} does not match "
                             f"coords batch {cs[0]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError("all inputs must be on one device")
    if g is not None and g.shape[2:] != cs[2:]:
        raise ValueError(f"g {tuple(g.shape)} does not match coords "
                         f"{tuple(cs)}")


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


def _tangents(imgs, coords, mode: str):
    """The samples and their tangents ``d out / dx``, ``d out / dy``
    (each (B, C, Ht, Wt)), formed explicitly as the kernels form them."""
    hs, ws = imgs.shape[2:]
    ht, wt = coords.shape[2:]
    idx, (wx0, wx1, wy0, wy1), (dx0, dx1, dy0, dy1) = _taps(
        coords, hs, ws, mode)
    i00, i01, i10, i11 = _gather_taps(imgs, idx, ht, wt)
    out = ((wx0 * wy0) * i00 + (wx0 * wy1) * i01
           + (wx1 * wy0) * i10 + (wx1 * wy1) * i11)
    tx = wy0 * (dx1 * i10 - dx0 * i00) + wy1 * (dx1 * i11 - dx0 * i01)
    ty = wx0 * (dy1 * i01 - dy0 * i00) + wx1 * (dy1 * i11 - dy0 * i10)
    return out, tx, ty


def warp_gather_reference(imgs, coords, mode: str):
    """Plain PyTorch version of the gather kernel (not differentiable)."""
    with torch.no_grad():
        return _tangents(imgs, coords, mode)[0]


def warp_coord_grad_reference(imgs, coords, g, mode: str):
    """Plain PyTorch version of the coordinate-gradient kernel: the
    cotangent g (B, C, Ht, Wt) contracted with the tangents over the
    channels -> (B, 2, Ht, Wt), channels (d x, d y)."""
    with torch.no_grad():
        _, tx, ty = _tangents(imgs, coords, mode)
        return torch.stack([(g * tx).sum(1), (g * ty).sum(1)], 1)


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


# The splat's target tile (rows, columns) and the shared-memory budget of
# its tap box, in floats: kTileH, kTileW and kBoxFloats of csrc/warp.cu.
SPLAT_TILE = (8, 32)
SPLAT_BOX_FLOATS = 4096


def splat_shared_share(coords, hs: int, ws: int, c: int, mode: str) -> float:
    """The share of the tile path's tiles whose tap box times ``c`` fits
    its shared-memory budget; the other tiles add straight into device
    memory. The boxes are those of every sample's four taps: the kernel
    leaves out samples that add nothing, so its share can only be higher."""
    b, _, ht, wt = coords.shape
    th, tw = SPLAT_TILE
    idx, _, _ = _taps(coords, hs, ws, mode)
    p00, p01, p10 = (i.reshape(b, ht, wt) for i in idx[:3])
    corners = (p00 % ws, p00 // ws, p10 % ws, p01 // ws)   # x0, y0, x1, y1
    # Pad the target to whole tiles with values that leave a box unchanged.
    ph, pw = -ht % th, -wt % tw
    big = hs * ws
    boxes = []
    for k, v in enumerate(corners):
        pad = big if k < 2 else -1
        v = torch.nn.functional.pad(v, (0, pw, 0, ph), value=pad)
        v = v.reshape(b, (ht + ph) // th, th, (wt + pw) // tw, tw)
        boxes.append(v.amin((2, 4)) if k < 2 else v.amax((2, 4)))
    x0, y0, x1, y1 = boxes
    cells = (x1 - x0 + 1) * (y1 - y0 + 1)
    return float((cells * c <= SPLAT_BOX_FLOATS).float().mean())


def _library() -> ctypes.CDLL:
    """The built kernel library, with the launchers' C signatures set."""
    global _lib
    if _lib is None:
        from sndepth_tpu_torch.kernels.build import load_library
        lib = load_library(_SOURCE)
        for name, pointers, ints in (("warp_gather_launch", 3, 7),
                                     ("warp_coord_grad_launch", 4, 7),
                                     ("warp_splat_launch", 3, 8)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                           + [ctypes.c_void_p])
        lib.warp_sampler_config.restype = ctypes.c_int
        lib.warp_sampler_config.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _run(launch, what: str, device: int, *args) -> None:
    """Call ``launch(*args, stream)`` on the current stream of card
    ``device`` and raise on a CUDA error. The card is made current only
    when it is not already: entering ``torch.cuda.device`` costs more host
    time than the smallest launches take on the card."""
    if torch._C._cuda_getDevice() != device:
        with torch.cuda.device(device):
            return _run(launch, what, device, *args)
    rc = launch(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"warp {what} launch failed: CUDA error {rc}")


def sampler_launch_config(imgs, coords, g=None) -> dict:
    """What the gather (``g`` None) or the coordinate gradient launches for
    these CUDA tensors, as ``csrc/warp.cu`` chooses it: ``v`` target pixels
    a thread, ``chunk`` channels whose taps a thread loads at once,
    ``groups`` channel groups, and ``planes_per_block``, the target planes
    a block's pixels span (more than 1 where the planes are small). The
    output is taken as aligned, as torch allocates it."""
    b, c = imgs.shape[:2]
    ht, wt = coords.shape[2:]
    cfg = (ctypes.c_int * 4)()
    rc = _library().warp_sampler_config(
        int(g is not None), coords.data_ptr(),
        None if g is None else g.data_ptr(), None, b, c, ht, wt, cfg)
    if rc != 0:
        raise RuntimeError(f"warp sampler config failed: CUDA error {rc}")
    return {"v": cfg[0], "chunk": cfg[1], "groups": cfg[2],
            "planes_per_block": cfg[3] / (ht * wt)}


def sampler_launches(b: int, npix: int) -> int:
    """The kernel launches of one gather or coordinate-gradient call on
    ``b`` planes of ``npix`` target pixels: one for each batch of planes of
    fewer than 2^31 pixels, as ``csrc/warp.cu``'s ``launch_k`` makes them
    (one for every call of this repository)."""
    return -(-b // ((2**31 - 1) // npix))


def _launch_gather(imgs, coords, mode: str):
    b, c, hs, ws = imgs.shape
    ht, wt = coords.shape[2:]
    lib = _library()
    out = imgs.new_empty((b, c, ht, wt))
    _run(lib.warp_gather_launch, "gather", imgs.get_device(), imgs.data_ptr(),
         coords.data_ptr(), out.data_ptr(), b, c, hs, ws, ht, wt, MODES[mode])
    warp_gather.launches += sampler_launches(b, ht * wt)
    return out


def _launch_coord_grad(imgs, coords, g, mode: str):
    b, c, hs, ws = imgs.shape
    ht, wt = coords.shape[2:]
    lib = _library()
    d_coords = coords.new_empty((b, 2, ht, wt))
    _run(lib.warp_coord_grad_launch, "coordinate gradient", imgs.get_device(),
         imgs.data_ptr(), coords.data_ptr(), g.data_ptr(), d_coords.data_ptr(),
         b, c, hs, ws, ht, wt, MODES[mode])
    warp_coord_grad.launches += sampler_launches(b, ht * wt)
    return d_coords


def _launch_splat(coords, g, hs: int, ws: int, mode: str,
                  plane_cells: int = 2**31 - 1):
    """The splat's launch: the plane path for planes of at most
    ``plane_cells`` cells that fit the card's shared memory, else the tile
    path (``plane_cells=0`` forces it, to hold it against the plain version
    at any size)."""
    b, c, ht, wt = g.shape
    lib = _library()
    # The kernel writes every cell (the tile path zeroes them first).
    d_imgs = g.new_empty((b, c, hs, ws))
    _run(lib.warp_splat_launch, "splat", g.get_device(), coords.data_ptr(),
         g.data_ptr(), d_imgs.data_ptr(), b, c, hs, ws, ht, wt, MODES[mode],
         plane_cells)
    warp_splat.launches += 1
    return d_imgs


# The gather as an operator of its own, ``torch.ops.sndepth.warp_gather``:
# the plain version is its CPU kernel, the CUDA kernel its CUDA kernel, and
# its fake version gives the output's shape, so that ``torch.export`` traces
# a model through it (the ctypes launch reads pointers a fake tensor does
# not have) and an exported program launches the kernel on the card.
# Defined through ``torch.library.Library``, whose dispatch costs the host
# less a call than the ``custom_op`` decorator's Python wrapper.
_OPS = torch.library.Library("sndepth", "FRAGMENT")
_OPS.define("warp_gather(Tensor imgs, Tensor coords, str mode) -> Tensor")
_OPS.impl("warp_gather", warp_gather_reference, "CPU")
_OPS.impl("warp_gather", _launch_gather, "CUDA")


@torch.library.register_fake("sndepth::warp_gather")
def _(imgs, coords, mode):
    return imgs.new_empty((*imgs.shape[:2], *coords.shape[2:]))


_gather_op = torch.ops.sndepth.warp_gather.default


def warp_gather(imgs, coords, mode: str):
    """The samples (B, C, Ht, Wt) of ``imgs`` at ``coords``, through
    ``torch.ops.sndepth.warp_gather``. A CUDA tensor launches the kernel,
    and any failure raises; a CPU tensor takes the plain version."""
    _check(imgs, coords, mode)
    if imgs.device.type in ("cuda", "cpu"):
        return _gather_op(imgs, coords, mode)
    raise ValueError(f"no warp kernel for device {imgs.device}")


def warp_coord_grad(imgs, coords, g, mode: str):
    """The coordinate gradient (B, 2, Ht, Wt) of the gather for the
    cotangent ``g``. Dispatches by device as :func:`warp_gather`."""
    _check(imgs, coords, mode, g)
    if imgs.shape[1] != g.shape[1]:
        raise ValueError(f"g has {g.shape[1]} channels, imgs {imgs.shape[1]}")
    if imgs.is_cuda:
        return _launch_coord_grad(imgs, coords, g, mode)
    if imgs.device.type == "cpu":
        return warp_coord_grad_reference(imgs, coords, g, mode)
    raise ValueError(f"no warp kernel for device {imgs.device}")


def warp_splat(coords, g, hs: int, ws: int, mode: str):
    """The image gradient (B, C, hs, ws) of the gather for the cotangent
    ``g``. Dispatches by device as :func:`warp_gather`."""
    _check(None, coords, mode, g)
    if g.is_cuda:
        return _launch_splat(coords, g, hs, ws, mode)
    if g.device.type == "cpu":
        return warp_splat_reference(coords, g, hs, ws, mode)
    raise ValueError(f"no warp kernel for device {g.device}")


warp_gather.launches = 0
warp_coord_grad.launches = 0
warp_splat.launches = 0


class _BilinearSample(torch.autograd.Function):
    """Forward: the gather. Backward: the coordinate-gradient kernel for
    the coordinates and the splat for the images, each only when its input
    wants a gradient. Saves the inputs, no tangent planes."""

    @staticmethod
    def forward(ctx, imgs, coords, mode):
        ctx.mode = mode
        ctx.save_for_backward(imgs, coords)
        return warp_gather(imgs, coords, mode)

    @staticmethod
    def backward(ctx, g):
        imgs, coords = ctx.saved_tensors
        g = g.contiguous()
        d_imgs = d_coords = None
        if ctx.needs_input_grad[0]:
            d_imgs = warp_splat(coords, g, *imgs.shape[2:], ctx.mode)
        if ctx.needs_input_grad[1]:
            d_coords = warp_coord_grad(imgs, coords, g, ctx.mode)
        return d_imgs, d_coords, None


def bilinear_sample(imgs: torch.Tensor, coords: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """Sample ``imgs`` at ``coords`` through the gather kernel (see the
    module docstring for modes and layouts); differentiable in both. Where
    no gradient is wanted the gather is called alone, as an exported
    inference program calls it."""
    if torch.is_grad_enabled() and (imgs.requires_grad
                                    or coords.requires_grad):
        return _BilinearSample.apply(imgs, coords, mode)
    return warp_gather(imgs, coords, mode)
