"""Dense-SE3 Gauss-Newton build (K8) and its backward (K8b).

Replaces the Pallas TPU kernels of ``sndepth_tpu/kernels/gn_build.py``
(:func:`gn_build_hg` -> ``_gn_pallas`` -> ``_kernel``, pair arithmetic
``_pair_contribs``; :func:`gn_build_hg_bwd` -> ``_gn_bwd_i_pallas`` and
``_gn_bwd_j_pallas``) with the CUDA C++ kernels ``csrc/gn_build.cu`` and
``csrc/gn_build_bwd.cu`` for Hopper (sm_90a). For every pixel i it
accumulates, over the pixels j within ``radius`` grid units of i on both
axes, the 6x6 normal equations H_i and
the right-hand side g_i of the reprojection residuals of T_i applied to the
point X_j against the target tgt_j:

    attn_ij = sigmoid(2 x_i . x_j - sq_i - sq_j)      (0 outside the radius)
    P = R_i X_j + t_i,  dinv = 1 / P_z
    r = tgt_j - (fx P_x dinv + cx,  fy P_y dinv + cy,  dinv)
    J = d pi / d delta (3 x 6, tangent order [tau, phi])
    H_i = sum_j sum_m attn_ij w_jm J_m^T J_m,   g_i = sum_j sum_m attn_ij w_jm J_m^T r_m

What bounds it on the card: operations (~218 a pair in the radius, against
a few megabytes of inputs), see the note at the top of ``csrc/gn_build.cu``
for what the design does about it. A pair outside the radius contributes
exactly nothing here, also where its transformed depth P_z is 0 (the TPU
kernel forms 0 * inf = NaN there).

Shapes (float32 for the kernel): rot (B, n, 3, 3), trans (B, n, 3), x (B, n, E) = ae / 8,
sq (B, n) = |x|^2, gy / gx (n,) grid rows and columns (integers, any dtype),
X / tgt / wgt (B, n, 3), intrinsics4 (B, 4) = (fx, fy, cx, cy). Returns H
(B, n, 6, 6), symmetric bit for bit, and g (B, n, 6).

The kernels are written for the 32-wide embedding and float32.

Gradients. :func:`gn_build_hg` is differentiable on both devices in its eight
float inputs (the grid positions only feed the radius test): on the CPU by
autograd through the plain version, on a CUDA tensor through a
``torch.autograd.Function`` whose backward is :func:`gn_build_hg_bwd`, one
kernel launch (:func:`gn_build_bwd`). The kernel makes one pass over the
pairs: a pixel p owns what is its as i of pair (p, q) (d rot, d trans, its
share of d intrinsics) and as j of pair (q, p) (d X, d tgt, d wgt), and d x,
d sq from both, summing the hand-derived adjoint of a pair
(``csrc/gn_pair.cuh``) over the pixels q in the radius. A gradient nobody
wants is not written, and a backward none of whose gradients is wanted
launches nothing. As in the forward, a pair outside the radius adds exactly
nothing, also where its depth is 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sndepth_tpu_torch.utils import tracing

EMB = 32
# Beyond this many pixels the plain version accumulates the j axis in blocks
# of _BLOCK (the JAX package's rule): a single shot holds O(n^2) Jacobians.
_SINGLE_SHOT_MAX = 2048
_BLOCK = 1024
# The pointers each kernel's C launcher ``<name>_launch`` in
# ``csrc/<name>.cu`` takes before (b, n, radius, stream).
_POINTERS = {"gn_build": 12, "gn_build_bwd": 20}
# A warp of either kernel owns a patch of PATCH_ROWS x PATCH_COLS grid
# pixels (:func:`owner_pixels`), 32 owners a block; the kernels stage the
# streamed pixels TILE at a time.
PATCH_ROWS, PATCH_COLS = 8, 4
OWNERS, TILE = 32, 64
# The forward kernel's clusters (``csrc/gn_build.cu`` ``cluster_size``): up
# to MAX_CLUSTER blocks share 32 owners, while the grid stays within SLOTS
# blocks (two on each of an H100's 132 SMs).
MAX_CLUSTER, SLOTS = 8, 2 * 132


def _check(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4) -> None:
    if sq.dim() != 2:
        raise ValueError("expected sq (B, n)")
    b, n = sq.shape
    want = {"rot": (b, n, 3, 3), "trans": (b, n, 3), "X": (b, n, 3),
            "tgt": (b, n, 3), "wgt": (b, n, 3), "intrinsics4": (b, 4)}
    got = {"rot": rot, "trans": trans, "X": X, "tgt": tgt, "wgt": wgt,
           "intrinsics4": intrinsics4}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} {tuple(got[name].shape)}, expected "
                             f"{shape}")
    if x.dim() != 3 or tuple(x.shape[:2]) != (b, n):
        raise ValueError(f"x {tuple(x.shape)}, expected ({b}, {n}, E)")
    if tuple(gy.shape) != (n,) or tuple(gx.shape) != (n,):
        raise ValueError(f"gy, gx must be ({n},)")
    for name, t in (*got.items(), ("x", x)):
        if t.dtype != sq.dtype or not t.is_floating_point():
            raise TypeError(f"{name} is {t.dtype}, sq is {sq.dtype}: the "
                            "float inputs must share one float type")
        if t.device != sq.device:
            raise ValueError("all inputs must be on one device")


def _accumulate(rot, trans, x, sq, gy, gx, fx, fy, cx, cy, radius,
                Xj, xj, sqj, gyj, gxj, tgtj, wgtj):
    """(H, g) partial sums over one block of j columns."""
    dist = (2.0 * torch.einsum("bic,bjc->bij", x, xj)
            - sq[:, :, None] - sqj[:, None, :])
    within = (((gy[:, None] - gyj[None, :]).abs() <= radius)
              & ((gx[:, None] - gxj[None, :]).abs() <= radius))
    attn = torch.sigmoid(dist) * within[None].to(dist.dtype)

    # P[b, m, i, j] = (R_i X_j + t_i)_m
    P = (torch.einsum("bimn,bjn->bmij", rot, Xj)
         + trans.transpose(1, 2)[:, :, :, None])
    Px, Py, Pz = P[:, 0], P[:, 1], P[:, 2]
    dinv = 1.0 / Pz
    d2 = dinv * dinv
    r = torch.stack([tgtj[:, None, :, 0] - (fx * Px * dinv + cx),
                     tgtj[:, None, :, 1] - (fy * Py * dinv + cy),
                     tgtj[:, None, :, 2] - dinv], 1)           # B,3,Ni,cj
    zeros = torch.zeros_like(Px)
    # Rows of J = d pi / d P @ [I | -[P]x] as (B, 3, Ni, 6, cj).
    J = torch.stack([
        torch.stack([fx * dinv, zeros, -fx * Px * d2, -fx * Px * Py * d2,
                     fx * (1.0 + Px * Px * d2), -fx * Py * dinv], 2),
        torch.stack([zeros, fy * dinv, -fy * Py * d2,
                     -fy * (1.0 + Py * Py * d2), fy * Px * Py * d2,
                     fy * Px * dinv], 2),
        torch.stack([zeros, zeros, -d2, -Py * d2, Px * d2, zeros], 2),
    ], 1)
    aw = attn[:, None] * wgtj.permute(0, 2, 1)[:, :, None, :]  # B,3,Ni,cj
    JW = J * aw[:, :, :, None, :]
    Hc = torch.einsum("bmicj,bmidj->bicd", JW, J)
    gc = torch.einsum("bmicj,bmij->bic", JW, r)
    return Hc, gc


def _grid_and_intrinsics(sq, gy, gx, intrinsics4):
    gy = gy.to(device=sq.device, dtype=sq.dtype)
    gx = gx.to(device=sq.device, dtype=sq.dtype)
    return gy, gx, intrinsics4[:, None, None, :].unbind(-1)


def _j_blocks(n: int) -> list[slice]:
    block = n if n <= _SINGLE_SHOT_MAX else _BLOCK
    return [slice(j0, j0 + block) for j0 in range(0, n, block)]


def _mirror(H: torch.Tensor) -> torch.Tensor:
    """Both triangles from the upper one's sums, as the kernel writes
    them."""
    return torch.triu(H) + torch.triu(H, 1).transpose(-1, -2)


def gn_build_hg_reference(rot, trans, x, sq, gy, gx, X, tgt, wgt,
                          intrinsics4, radius: int):
    """Plain PyTorch version, on any device, for any embedding width and
    in any float type; differentiable by autograd in every float input,
    with finite gradients at the pairs the radius masks (the weight is the
    sigmoid times a 0/1 mask, with no square root at 0). Up to 2048 pixels
    in one shot, beyond that over blocks of 1024 pixels j."""
    _check(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4)
    gy, gx, (fx, fy, cx, cy) = _grid_and_intrinsics(sq, gy, gx, intrinsics4)
    H = g = None
    for sl in _j_blocks(sq.shape[1]):
        Hc, gc = _accumulate(rot, trans, x, sq, gy, gx, fx, fy, cx, cy,
                             float(radius), X[:, sl], x[:, sl], sq[:, sl],
                             gy[sl], gx[sl], tgt[:, sl], wgt[:, sl])
        H, g = (Hc, gc) if H is None else (H + Hc, g + gc)
    return _mirror(H), g


def gn_build_hg_bwd_reference(rot, trans, x, sq, gy, gx, X, tgt, wgt,
                              intrinsics4, radius: int, ct_H, ct_g):
    """Plain version of the backward: ``torch.autograd.grad`` through the
    plain build, on any device and in any float type. (H, g) is a sum over
    the blocks of pixels j that :func:`gn_build_hg_reference` takes, and the
    mirroring of H is linear, so the gradients are taken block by block and
    added: the graph of one block is all that is held at a time. Returns
    (d rot, d trans, d x, d sq, d X, d tgt, d wgt, d intrinsics4), the order
    of the JAX package's ``gn_build_hg_bwd``."""
    _check(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4)
    leaves = [t.detach().requires_grad_(True)
              for t in (rot, trans, x, sq, X, tgt, wgt, intrinsics4)]
    rot_, trans_, x_, sq_, X_, tgt_, wgt_, intr_ = leaves
    total = None
    for sl in _j_blocks(sq.shape[1]):
        with torch.enable_grad():
            gy_, gx_, (fx, fy, cx, cy) = _grid_and_intrinsics(sq_, gy, gx,
                                                              intr_)
            Hc, gc = _accumulate(rot_, trans_, x_, sq_, gy_, gx_, fx, fy, cx,
                                 cy, float(radius), X_[:, sl], x_[:, sl],
                                 sq_[:, sl], gy_[sl], gx_[sl], tgt_[:, sl],
                                 wgt_[:, sl])
            grads = torch.autograd.grad([_mirror(Hc), gc], leaves,
                                        [ct_H, ct_g])
        total = grads if total is None else tuple(
            a + b for a, b in zip(total, grads))
    return total


@functools.lru_cache(maxsize=None)
def _library(name: str = "gn_build"):
    """The C launcher of kernel ``name``, its library built on first use,
    with its signature set."""
    from sndepth_tpu_torch.kernels.build import load_library
    fn = getattr(load_library(name + ".cu"), name + "_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * _POINTERS[name] + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _kernel_inputs(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4):
    """The ten inputs as the kernels take them: contiguous float32 on the
    device of ``sq``; raises on what they do not take."""
    if x.shape[-1] != EMB:
        raise ValueError(f"the kernel takes a {EMB}-wide embedding, got "
                         f"{x.shape[-1]}")
    if sq.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {sq.dtype}")
    gy, gx = (t.to(device=sq.device, dtype=torch.float32) for t in (gy, gx))
    return [t.detach().contiguous()
            for t in (rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4)]


def _launch(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
            radius: int):
    args = _kernel_inputs(rot, trans, x, sq, gy, gx, X, tgt, wgt,
                          intrinsics4)
    # The kernel copies rows of x 16 bytes at a time.
    if args[2].data_ptr() % 16:
        args[2] = args[2].clone()
    b, n = sq.shape
    launch = _library()
    H = torch.empty(b, n, 6, 6, dtype=torch.float32, device=sq.device)
    g = torch.empty(b, n, 6, dtype=torch.float32, device=sq.device)
    with torch.cuda.device(sq.device):
        rc = launch(*(t.data_ptr() for t in args), H.data_ptr(),
                    g.data_ptr(), b, n, float(radius),
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_build launch failed: CUDA error {rc}")
    tracing.count("K8")
    return H, g


def owner_pixels(gy: torch.Tensor) -> torch.Tensor:
    """The pixel each owner slot k of either kernel takes (slot k is lane
    k % 32 of the block, or cluster, k // 32), as ``owner_pixel`` in
    ``csrc/gn_pair.cuh`` maps it:
    the grid width w is the first index where ``gy`` changes (n if none);
    the full rows are cut into bands of 8 rows, each band into patches of 8
    rows x 4 columns left to right (the last one narrower where 4 does not
    divide w), a patch's pixels row-major; a last, partial grid row keeps
    its order. A permutation of [0, n) for any ``gy``."""
    n = gy.shape[0]
    changed = torch.nonzero(gy[1:] != gy[0])
    w = int(changed[0, 0]) + 1 if len(changed) else n
    rows = n // w
    k = torch.arange(n, device=gy.device)
    kk = k[:rows * w]
    band = kk // (PATCH_ROWS * w)
    hb = (rows - PATCH_ROWS * band).clamp(max=PATCH_ROWS)
    o = kk - band * PATCH_ROWS * w
    ncg = w // PATCH_COLS
    in_groups = hb * PATCH_COLS * ncg
    g = o // (hb * PATCH_COLS)
    i = o - g * hb * PATCH_COLS
    rest = o - in_groups
    wl = max(w - PATCH_COLS * ncg, 1)
    inside = o < in_groups
    r = torch.where(inside, i // PATCH_COLS, rest // wl)
    c = torch.where(inside, g * PATCH_COLS + i % PATCH_COLS,
                    PATCH_COLS * ncg + rest % wl)
    return torch.cat([(PATCH_ROWS * band + r) * w + c, k[rows * w:]])


def cluster_size(blocks: int) -> int:
    """Blocks in a cluster of the forward kernel for a grid of ``blocks``
    groups of 32 owners (B x ceil(n / 32)), as ``cluster_size`` in
    ``csrc/gn_build.cu`` picks it: the largest of 8, 4, 2, 1 that keeps
    ``blocks`` times it within :data:`SLOTS`."""
    c = MAX_CLUSTER
    while c > 1 and blocks * c > SLOTS:
        c //= 2
    return c


def cluster_tiles(gy: torch.Tensor, gx: torch.Tensor, radius: float,
                  csize: int) -> list[list[list[int]]]:
    """The tiles each block of the forward kernel computes, as the kernel
    deals them: for every group of 32 owner slots, and for every rank of
    its cluster of ``csize`` blocks, the first pixels of its tiles. A tile
    is in reach of the group when one of its pixels lies in the box of the
    owners' grid positions grown by ``radius``; the in-reach tiles, in
    order, go to the ranks in turn."""
    pix = owner_pixels(gy)
    n = pix.shape[0]
    gy, gx = gy.to(torch.float32), gx.to(torch.float32)
    out = []
    for k0 in range(0, n, OWNERS):
        own = pix[k0:k0 + OWNERS]
        ylo, yhi = gy[own].min() - radius, gy[own].max() + radius
        xlo, xhi = gx[own].min() - radius, gx[own].max() + radius
        held = (gy >= ylo) & (gy <= yhi) & (gx >= xlo) & (gx <= xhi)
        reach = [j0 for j0 in range(0, n, TILE)
                 if bool(held[j0:j0 + TILE].any())]
        out.append([reach[r::csize] for r in range(csize)])
    return out


def lane_share(gy: torch.Tensor, gx: torch.Tensor, radius: int) -> float:
    """Of the lanes that run a pair in either kernel, the share whose pair
    is within the radius. A warp owns 32 slots of
    :func:`owner_pixels` and steps through every streamed pixel that one of
    its lanes reaches, all 32 lanes at once."""
    pix = owner_pixels(gy)
    n = pix.shape[0]
    gy, gx = gy.to(torch.float64), gx.to(torch.float64)
    lanes = PATCH_ROWS * PATCH_COLS
    inside = running = 0
    for w0 in range(0, n, lanes):
        own = pix[w0:w0 + lanes]
        reach = (((gy[own, None] - gy[None]).abs() <= radius)
                 & ((gx[own, None] - gx[None]).abs() <= radius))
        inside += int(reach.sum())
        running += lanes * int(reach.any(0).sum())
    return inside / running


def gn_build_bwd(args, ct_H, ct_g, radius: int, want=(True,) * 8):
    """The backward kernel on a CUDA device, one launch: (d rot, d trans,
    d x, d sq, d X, d tgt, d wgt, d intrinsics4), ``None`` where ``want`` is
    false. ``args`` come from ``_kernel_inputs``; ``ct_H`` (B, n, 6, 6) and
    ``ct_g`` (B, n, 6) are float32 and contiguous."""
    # The kernel copies rows of x and ct_H 16 bytes at a time, ct_g 8.
    args = list(args)
    args[2], ct_H, ct_g = (t if t.data_ptr() % 16 == 0 else t.clone()
                           for t in (args[2], ct_H, ct_g))
    sq = args[3]
    b, n = sq.shape
    shapes = [(b, n, 3, 3), (b, n, 3), (b, n, EMB), (b, n), (b, n, 3),
              (b, n, 3), (b, n, 3), (b, n, 4)]
    out = [torch.empty(shape, dtype=torch.float32, device=sq.device) if w
           else None for w, shape in zip(want, shapes)]
    launch = _library("gn_build_bwd")
    with torch.cuda.device(sq.device):
        rc = launch(*(t.data_ptr() for t in args), ct_H.data_ptr(),
                    ct_g.data_ptr(),
                    *(None if t is None else t.data_ptr() for t in out),
                    b, n, float(radius),
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_build_bwd launch failed: CUDA error {rc}")
    tracing.count("K8b")
    if out[7] is not None:
        # The kernel writes each pixel's share; the sum over the pixels is
        # taken in one order from run to run.
        out[7] = out[7].sum(1)
    return tuple(out)


@tracing.span("kernel#K8b")
def gn_build_hg_bwd(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
                    radius: int, ct_H, ct_g, want=(True,) * 8):
    """Backward of :func:`gn_build_hg`: (d rot, d trans, d x, d sq, d X,
    d tgt, d wgt, d intrinsics4), ``None`` where ``want`` is false. CUDA
    tensors launch the kernel once (not at all if nothing is wanted), and
    any failure raises; CPU tensors take the plain version."""
    _check(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4)
    if sq.device.type == "cpu":
        grads = gn_build_hg_bwd_reference(rot, trans, x, sq, gy, gx, X, tgt,
                                          wgt, intrinsics4, radius, ct_H,
                                          ct_g)
        return tuple(g if w else None for g, w in zip(grads, want))
    if sq.device.type != "cuda":
        raise ValueError(f"no gn_build kernel for device {sq.device}")
    if not any(want):
        return (None,) * 8
    args = _kernel_inputs(rot, trans, x, sq, gy, gx, X, tgt, wgt,
                          intrinsics4)
    ct_H, ct_g = (t.detach().to(torch.float32).contiguous()
                  for t in (ct_H, ct_g))
    return gn_build_bwd(args, ct_H, ct_g, radius, want)


# The build as an operator of its own, ``torch.ops.sndepth.gn_build``: the
# plain version is its CPU kernel, K8 its CUDA kernel, and its fake version
# gives the outputs' shapes, so that ``torch.export`` traces RAFT3D through
# it (the ctypes launch reads pointers a fake tensor does not have) and an
# exported program launches K8 on the card. Defined through
# ``torch.library.Library``, as ``warp_gather`` is.
_OPS = torch.library.Library("sndepth", "FRAGMENT")
_OPS.define("gn_build(Tensor rot, Tensor trans, Tensor x, Tensor sq, "
            "Tensor gy, Tensor gx, Tensor X, Tensor tgt, Tensor wgt, "
            "Tensor intrinsics4, int radius) -> (Tensor, Tensor)")
_OPS.impl("gn_build", gn_build_hg_reference, "CPU")
_OPS.impl("gn_build", _launch, "CUDA")


@torch.library.register_fake("sndepth::gn_build")
def _(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4, radius):
    b, n = sq.shape
    return sq.new_empty((b, n, 6, 6)), sq.new_empty((b, n, 6))


_build_op = torch.ops.sndepth.gn_build.default


class _GNBuild(torch.autograd.Function):
    """K8 forward, K8b backward, on CUDA tensors."""

    @staticmethod
    def forward(ctx, rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
                radius):
        ctx.save_for_backward(rot, trans, x, sq, gy, gx, X, tgt, wgt,
                              intrinsics4)
        ctx.radius = radius
        return _build_op(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
                         radius)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct_H, ct_g):
        need = ctx.needs_input_grad
        want = tuple(need[k] for k in (0, 1, 2, 3, 6, 7, 8, 9))
        drot, dtrans, dx, dsq, dX, dtgt, dwgt, dintr = gn_build_hg_bwd(
            *ctx.saved_tensors, ctx.radius, ct_H, ct_g, want)
        return drot, dtrans, dx, dsq, None, None, dX, dtgt, dwgt, dintr, None


def gn_build_hg(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
                radius: int):
    """(H, g) of the build (see the module docstring for shapes),
    differentiable in the eight float inputs. A CUDA tensor launches the
    kernels at every n, forward and backward, and any failure raises; a CPU
    tensor takes the plain version. Where no gradient is wanted the build
    is ``torch.ops.sndepth.gn_build`` alone, as an exported inference
    program calls it."""
    _check(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4)
    args = (rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4, radius)
    if sq.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no gn_build kernel for device {sq.device}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in args[:-1])):
        return _build_op(*args)
    if sq.device.type == "cuda":
        return _GNBuild.apply(*args)
    return gn_build_hg_reference(*args)
