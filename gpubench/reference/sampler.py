"""Plain bilinear sampler of the references, differentiable by autograd.

Pixel coordinates (B, 2, Ht, Wt), channels (x, y), sample a (B, C, Hs, Ws)
image. ``edge_zero``: taps clamped into the image, so a sample outside
takes the border's weights (the GeoNet reference's sampler). ``zero_pad``:
each tap outside the image weighs 0 (mmcv's deformable attention and
DCNv2, and torch's ``grid_sample(align_corners=True, padding_mode=
"zeros")``).

Each call notes the work of the kernels the port launches for it: the
gather (K5), and in a differentiated call the coordinate gradient (K5b)
when the coordinates want one and the splat (K6) when the image does.
"""

from __future__ import annotations

import torch

from gpubench import work

MODES = ("edge_zero", "zero_pad")
# The port's device kernels of each noted call (``kernels/csrc/warp.cu``).
GATHER = ("warp_gather_kernel",)
COORD_GRAD = ("warp_coord_grad_kernel",)
SPLAT = ("warp_splat",)


def _taps(coords: torch.Tensor, hs: int, ws: int, mode: str):
    b = coords.shape[0]
    x, y = coords[:, 0:1], coords[:, 1:2]
    xf, yf = torch.floor(x), torch.floor(y)
    x0, x1 = xf.clamp(0.0, ws - 1.0), (xf + 1.0).clamp(0.0, ws - 1.0)
    y0, y1 = yf.clamp(0.0, hs - 1.0), (yf + 1.0).clamp(0.0, hs - 1.0)
    if mode == "edge_zero":
        wx0, wx1, wy0, wy1 = x1 - x, x - x0, y1 - y, y - y0
    else:
        fx, fy = x - xf, y - yf
        inside = [((c >= 0.0) & (c <= size - 1.0)).to(x.dtype)
                  for c, size in ((xf, ws), (xf + 1.0, ws),
                                  (yf, hs), (yf + 1.0, hs))]
        wx0, wx1 = (1.0 - fx) * inside[0], fx * inside[1]
        wy0, wy1 = (1.0 - fy) * inside[2], fy * inside[3]

    def index(c, size):
        return c.long().clamp(0, size - 1).reshape(b, -1)

    x0i, x1i = index(x0, ws), index(x1, ws)
    y0i, y1i = index(y0, hs), index(y1, hs)
    idx = (y0i * ws + x0i, y1i * ws + x0i, y0i * ws + x1i, y1i * ws + x1i)
    return idx, (wx0, wx1, wy0, wy1)


def _note(imgs: torch.Tensor, coords: torch.Tensor, mode: str) -> None:
    b, c, hs, ws = imgs.shape
    with torch.no_grad():
        cells = work.touched_cells(coords, hs, ws, mode)
    work.note("K5", *work.gather_call(c, hs, ws, coords.shape, cells),
              names=GATHER)
    if torch.is_grad_enabled() and coords.requires_grad:
        work.note("K5b", *work.coord_grad_call(c, hs, ws, coords.shape,
                                               cells), names=COORD_GRAD)
    if torch.is_grad_enabled() and imgs.requires_grad:
        work.note("K6", *work.splat_call(c, hs, ws, coords.shape),
                  names=SPLAT)


def sample(imgs: torch.Tensor, coords: torch.Tensor, mode: str,
           note: bool = True) -> torch.Tensor:
    """(B, C, Hs, Ws) sampled at (B, 2, Ht, Wt) -> (B, C, Ht, Wt).
    ``note=False`` where the port's kernel samples inside a larger one (the
    photo kernel), which notes its own work."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if note and work.active():
        _note(imgs, coords, mode)
    b, c, hs, ws = imgs.shape
    ht, wt = coords.shape[2:]
    idx, (wx0, wx1, wy0, wy1) = _taps(coords, hs, ws, mode)
    flat = imgs.reshape(b, c, -1)
    i00, i01, i10, i11 = (
        torch.gather(flat, 2, i[:, None].expand(b, c, ht * wt))
        .reshape(b, c, ht, wt) for i in idx)
    return ((wx0 * wy0) * i00 + (wx0 * wy1) * i01
            + (wx1 * wy0) * i10 + (wx1 * wy1) * i11)
