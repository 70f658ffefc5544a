"""Differentiable pinhole-camera geometry (PyTorch).

Counterpart of :mod:`sndepth_tpu.ops.camera`, with the reference's
semantics (reference `utils/utils_edited.py:149-362`): R = Rx @ Ry @ Rz
with unclamped angles, closed-form inverses of the rigid pose and of K,
and the ``z + 1e-10`` guard in :func:`cam2pixel`. Image-like outputs are
channel-first: pixel grids (B, 2|3, H, W), flows (B, 2, H, W) with
channels (x, y).
"""

from __future__ import annotations

import torch


def meshgrid(height: int, width: int, *, homogeneous: bool = True,
             dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-coordinate grid, shape (2|3, H, W) with channels (x, y[, 1])."""
    x = torch.arange(width, dtype=dtype, device=device)
    y = torch.arange(height, dtype=dtype, device=device)
    xg = x[None, :].expand(height, width)
    yg = y[:, None].expand(height, width)
    if homogeneous:
        return torch.stack([xg, yg, torch.ones_like(xg)], 0)
    return torch.stack([xg, yg], 0)


def euler2mat(z: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Batched rotation matrices from Euler angles (B,) -> (B, 3, 3);
    R = Rx @ Ry @ Rz."""
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    ones = torch.ones_like(z)
    zeros = torch.zeros_like(z)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rot_z = mat([[cz, -sz, zeros], [sz, cz, zeros], [zeros, zeros, ones]])
    rot_y = mat([[cy, zeros, sy], [zeros, ones, zeros], [-sy, zeros, cy]])
    rot_x = mat([[ones, zeros, zeros], [zeros, cx, -sx], [zeros, sx, cx]])
    return rot_x @ rot_y @ rot_z


def _bottom_row(b: int, like: torch.Tensor) -> torch.Tensor:
    # Made on the device, with no copy from the host, which a CUDA graph
    # could not capture.
    row = like.new_zeros(1, 1, 4)
    row[..., 3] = 1.0
    return row.expand(b, 1, 4)


def pose_vec2mat(vec: torch.Tensor) -> torch.Tensor:
    """6-DoF pose (B, 6) = [tx ty tz rx ry rz] -> (B, 4, 4) transform."""
    t = vec[:, :3, None]
    rot = euler2mat(vec[:, 5], vec[:, 4], vec[:, 3])
    top = torch.cat([rot, t], 2)
    return torch.cat([top, _bottom_row(vec.shape[0], vec)], 1)


def invert_pose_mat(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse [R^T, -R^T t] of a rigid (B, 4, 4) transform."""
    rot_t = mat[:, :3, :3].transpose(-1, -2)
    top = torch.cat([rot_t, -rot_t @ mat[:, :3, 3:]], 2)
    return torch.cat([top, _bottom_row(mat.shape[0], mat)], 1)


def invert_intrinsics(k: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a (B, 3, 3) pinhole intrinsics matrix."""
    fx, fy = k[:, 0, 0], k[:, 1, 1]
    cx, cy = k[:, 0, 2], k[:, 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    inv_fx, inv_fy = 1.0 / fx, 1.0 / fy
    r1 = torch.stack([inv_fx, zeros, -cx * inv_fx], -1)
    r2 = torch.stack([zeros, inv_fy, -cy * inv_fy], -1)
    r3 = torch.stack([zeros, zeros, ones], -1)
    return torch.stack([r1, r2, r3], -2)


def pixel2cam(depth: torch.Tensor, pixel_coords: torch.Tensor,
              intrinsics: torch.Tensor, *,
              homogeneous: bool = True) -> torch.Tensor:
    """Back-project pixels to the camera frame.

    depth (B, H, W); pixel_coords (B, 3, H, W); intrinsics (B, 3, 3).
    Returns (B, 4|3, H, W). Per-plane multiply-adds in the JAX version's
    order, not a matmul with a contraction of 3.
    """
    k_inv = invert_intrinsics(intrinsics)
    pc = [pixel_coords[:, j] for j in range(3)]
    rows = []
    for c in range(3):
        acc = k_inv[:, c, 0][:, None, None] * pc[0]
        acc = acc + k_inv[:, c, 1][:, None, None] * pc[1]
        acc = acc + k_inv[:, c, 2][:, None, None] * pc[2]
        rows.append(acc * depth)
    if homogeneous:
        rows.append(torch.ones_like(rows[0]))
    return torch.stack(rows, 1)


def cam2pixel(cam_coords: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Project homogeneous camera coords (B, 4, H, W) through a (B, 4, 4)
    projection. Returns pixel coords (B, 2, H, W), divided by z + 1e-10."""
    cc = [cam_coords[:, j] for j in range(4)]
    rows = []
    for c in range(3):
        acc = proj[:, c, 0][:, None, None] * cc[0]
        for j in range(1, 4):
            acc = acc + proj[:, c, j][:, None, None] * cc[j]
        rows.append(acc)
    return torch.stack([rows[0] / (rows[2] + 1e-10),
                        rows[1] / (rows[2] + 1e-10)], 1)


def intrinsics_4x4(intrinsics: torch.Tensor) -> torch.Tensor:
    """Pad (B, 3, 3) K to a (B, 4, 4) homogeneous projection matrix."""
    b = intrinsics.shape[0]
    k = torch.cat([intrinsics, intrinsics.new_zeros(b, 3, 1)], 2)
    return torch.cat([k, _bottom_row(b, intrinsics)], 1)


def compute_rigid_flow(pose: torch.Tensor, depth: torch.Tensor,
                       intrinsics: torch.Tensor,
                       reverse_pose: bool) -> torch.Tensor:
    """Rigid flow of a 6-DoF pose (B, 6) over a depth map (B, H, W) with
    intrinsics (B, 3, 3). Returns flow (B, 2, H, W), channels (x, y)."""
    b, h, w = depth.shape
    mat = pose_vec2mat(pose)
    if reverse_pose:
        mat = invert_pose_mat(mat)
    pix = meshgrid(h, w, dtype=depth.dtype,
                   device=depth.device)[None].expand(b, 3, h, w)
    cam = pixel2cam(depth, pix, intrinsics)
    proj = intrinsics_4x4(intrinsics) @ mat
    return cam2pixel(cam, proj) - pix[:, :2]


def compute_multi_scale_intrinsics(intrinsics: torch.Tensor,
                                   num_scales: int) -> torch.Tensor:
    """Per-scale intrinsics (B, 3, 3) -> (B, S, 3, 3), halving fx, fy, cx,
    cy at each scale."""
    scales = []
    for s in range(num_scales):
        f = 1.0 / (2 ** s)
        fx = intrinsics[:, 0, 0] * f
        fy = intrinsics[:, 1, 1] * f
        cx = intrinsics[:, 0, 2] * f
        cy = intrinsics[:, 1, 2] * f
        zeros = torch.zeros_like(fx)
        ones = torch.ones_like(fx)
        scales.append(torch.stack([torch.stack([fx, zeros, cx], -1),
                                   torch.stack([zeros, fy, cy], -1),
                                   torch.stack([zeros, zeros, ones], -1)],
                                  -2))
    return torch.stack(scales, 1)
