"""Dense-SE3 Gauss-Newton build (K8).

Replaces the Pallas TPU kernel of ``sndepth_tpu/kernels/gn_build.py``
(:func:`gn_build_hg` -> ``_gn_pallas`` -> ``_kernel``, pair arithmetic
``_pair_contribs``) with the CUDA C++ kernel ``csrc/gn_build.cu`` for Hopper
(sm_90a). For every pixel i it accumulates, over the pixels j within
``radius`` grid units of i on both axes, the 6x6 normal equations H_i and
the right-hand side g_i of the reprojection residuals of T_i applied to the
point X_j against the target tgt_j:

    attn_ij = sigmoid(2 x_i . x_j - sq_i - sq_j)      (0 outside the radius)
    P = R_i X_j + t_i,  dinv = 1 / P_z
    r = tgt_j - (fx P_x dinv + cx,  fy P_y dinv + cy,  dinv)
    J = d pi / d delta (3 x 6, tangent order [tau, phi])
    H_i = sum_j sum_m attn_ij w_jm J_m^T J_m,   g_i = sum_j sum_m attn_ij w_jm J_m^T r_m

What bounds it on the card: operations (~250 a pair in the radius, against
a few megabytes of inputs), see the note at the top of ``csrc/gn_build.cu``
for what the design does about it. A pair outside the radius contributes
exactly nothing here, also where its transformed depth P_z is 0 (the TPU
kernel forms 0 * inf = NaN there).

Shapes (float32 for the kernel): rot (B, n, 3, 3), trans (B, n, 3), x (B, n, E) = ae / 8,
sq (B, n) = |x|^2, gy / gx (n,) grid rows and columns (integers, any dtype),
X / tgt / wgt (B, n, 3), intrinsics4 (B, 4) = (fx, fy, cx, cy). Returns H
(B, n, 6, 6), symmetric bit for bit, and g (B, n, 6).

The kernel is written for the 32-wide embedding; the backward kernels of the
TPU package (``gn_build_hg_bwd``) are not ported yet, so a launch refuses
inputs that want a gradient.
"""

from __future__ import annotations

import ctypes

import torch

EMB = 32
# Beyond this many pixels the plain version accumulates the j axis in blocks
# of _BLOCK (the JAX package's rule): a single shot holds O(n^2) Jacobians.
_SINGLE_SHOT_MAX = 2048
_BLOCK = 1024
_SOURCE = "gn_build.cu"
_lib = None


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


def gn_build_hg_reference(rot, trans, x, sq, gy, gx, X, tgt, wgt,
                          intrinsics4, radius: int):
    """Plain PyTorch version, on any device, for any embedding width and
    in any float type; differentiable by autograd in every float input,
    with finite gradients at the pairs the radius masks (the weight is the
    sigmoid times a 0/1 mask, with no square root at 0). Up to 2048 pixels
    in one shot, beyond that over blocks of 1024 pixels j."""
    _check(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4)
    n = sq.shape[1]
    gy = gy.to(device=sq.device, dtype=sq.dtype)
    gx = gx.to(device=sq.device, dtype=sq.dtype)
    fx, fy, cx, cy = intrinsics4[:, None, None, :].unbind(-1)
    block = n if n <= _SINGLE_SHOT_MAX else _BLOCK
    H = g = None
    for j0 in range(0, n, block):
        sl = slice(j0, j0 + block)
        Hc, gc = _accumulate(rot, trans, x, sq, gy, gx, fx, fy, cx, cy,
                             float(radius), X[:, sl], x[:, sl], sq[:, sl],
                             gy[sl], gx[sl], tgt[:, sl], wgt[:, sl])
        H, g = (Hc, gc) if H is None else (H + Hc, g + gc)
    # Both triangles from the same sums, as the kernel writes them.
    upper = torch.triu(H)
    return upper + torch.triu(H, 1).transpose(-1, -2), g


def _library() -> ctypes.CDLL:
    """The built kernel library, with the launcher's C signature set."""
    global _lib
    if _lib is None:
        from sndepth_tpu_torch.kernels.build import load_library
        lib = load_library(_SOURCE)
        lib.gn_build_launch.restype = ctypes.c_int
        lib.gn_build_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [ctypes.c_float]
            + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _launch(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
            radius: int):
    if x.shape[-1] != EMB:
        raise ValueError(f"the kernel takes a {EMB}-wide embedding, got "
                         f"{x.shape[-1]}")
    if sq.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {sq.dtype}")
    floats = (rot, trans, x, sq, X, tgt, wgt, intrinsics4)
    if torch.is_grad_enabled() and any(t.requires_grad for t in floats):
        raise RuntimeError(
            "the Gauss-Newton build kernel has no backward yet: call it "
            "under torch.no_grad() or on tensors that want no gradient")
    b, n = sq.shape
    lib = _library()
    args = [t.contiguous() for t in floats]
    grid = [t.to(device=sq.device, dtype=torch.float32).contiguous()
            for t in (gy, gx)]
    rot_, trans_, x_, sq_, X_, tgt_, wgt_, intr_ = args
    H = torch.empty(b, n, 6, 6, dtype=torch.float32, device=sq.device)
    g = torch.empty(b, n, 6, dtype=torch.float32, device=sq.device)
    with torch.cuda.device(sq.device):
        rc = lib.gn_build_launch(
            rot_.data_ptr(), trans_.data_ptr(), x_.data_ptr(),
            sq_.data_ptr(), grid[0].data_ptr(), grid[1].data_ptr(),
            X_.data_ptr(), tgt_.data_ptr(), wgt_.data_ptr(),
            intr_.data_ptr(), H.data_ptr(), g.data_ptr(), b, n,
            float(radius), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_build launch failed: CUDA error {rc}")
    gn_build_hg.launches += 1
    return H, g


def gn_build_hg(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
                radius: int):
    """(H, g) of the build (see the module docstring for shapes). A CUDA
    tensor launches the kernel at every n, and any failure raises; a CPU
    tensor takes the plain version."""
    _check(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4)
    if sq.device.type == "cuda":
        return _launch(rot, trans, x, sq, gy, gx, X, tgt, wgt, intrinsics4,
                       radius)
    if sq.device.type == "cpu":
        return gn_build_hg_reference(rot, trans, x, sq, gy, gx, X, tgt, wgt,
                                     intrinsics4, radius)
    raise ValueError(f"no gn_build kernel for device {sq.device}")


gn_build_hg.launches = 0
