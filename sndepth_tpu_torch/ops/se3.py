"""Dense SE(3) fields as plain tensors.

Counterpart of ``sndepth_tpu/ops/se3.py``. An SE(3) field is a tensor of
shape ``(..., 7)`` laid out ``[tx ty tz qx qy qz qw]`` (lietorch's data
layout), channel-last as in the JAX package: every function here is
elementwise over the leading axes. Every group operation is closed-form
tensor math, differentiable by autograd. The exp/log coefficient functions
switch to Taylor series near theta = 0 at the JAX package's thresholds, and
guard the operands of ``sqrt`` and of the divisions as well as their
results: ``torch.where`` passes a NaN gradient from the branch it did not
select, as ``jnp.where`` does.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """SE3 identity field of the given leading shape -> (*shape, 7)."""
    data = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    data[..., 6] = 1.0
    return data


# --- quaternion helpers (x, y, z, w) ---

def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (..., 3) by unit quaternions q (..., 4)."""
    qv = q[..., :3]
    qw = q[..., 3:]
    t = 2.0 * _cross(qv, p)
    return p + qw * t + _cross(qv, t)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


# --- group ops ---

def exp(tangent: torch.Tensor) -> torch.Tensor:
    """SE3 exponential map. tangent: (..., 6) = [tau(3), phi(3)] -> (..., 7),
    translation components first (lietorch's convention)."""
    tau, phi = tangent[..., :3], tangent[..., 3:]
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    # sqrt has a NaN gradient at 0, so its operand is guarded too.
    theta = torch.sqrt(torch.where(small, one, theta_sq))

    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0,
                            torch.sin(half) / theta)
    qv = phi * sinc_half
    qw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    q = torch.cat([qv, qw], dim=-1)

    # V matrix: I + B [phi]x + C [phi]x^2.
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one,
                                                           theta_sq))
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, theta_sq * theta))
    px = _cross(phi, tau)
    pxx = _cross(phi, px)
    t = tau + b * px + c * pxx
    return torch.cat([t, q], dim=-1)


def log(g: torch.Tensor) -> torch.Tensor:
    """SE3 logarithm. g: (..., 7) -> tangent (..., 6) = [tau, phi]."""
    t, q = g[..., :3], g[..., 3:]
    qv, qw = q[..., :3], q[..., 3:]
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small = n_sq < 1e-12
    one = torch.ones_like(n_sq)
    n = torch.sqrt(torch.where(small, one, n_sq))
    theta_exact = 2.0 * torch.atan2(n, qw.abs())
    sign = torch.where(qw < 0, -one, one)
    # theta/n Taylor around n=0 (qw ~ +-1): 2/|qw| * (1 - n^2/(3 qw^2)).
    abs_qw = qw.abs().clamp_min(1e-12)
    scale = torch.where(
        small, sign * 2.0 / abs_qw * (1.0 - n_sq / (3 * abs_qw ** 2)),
        sign * theta_exact / n)
    phi = qv * scale

    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, one, theta_sq))
    # V^{-1} = I - 0.5 [phi]x + D [phi]x^2
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    # Up to theta ~ 3.5e-4 the float32 cosine rounds to 1 and the exact
    # branch would divide by 0 (the JAX function does, and returns
    # non-finite translations between theta = 1e-4 and there; a field in
    # its first training steps lives in that band): wherever the
    # denominator is exactly 0 the Taylor branch is taken too. Everywhere
    # else the thresholds and the arithmetic are the JAX function's.
    denom = 2.0 * (1.0 - cos_t)
    series = small | (denom == 0)
    d = torch.where(
        series, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - theta * sin_t / torch.where(series, one, denom))
        / torch.where(small, one, theta_sq))
    px = _cross(phi, t)
    pxx = _cross(phi, px)
    tau = t - 0.5 * px + d * pxx
    return torch.cat([tau, phi], dim=-1)


def mul(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """Group composition g1 * g2."""
    t1, q1 = g1[..., :3], g1[..., 3:]
    t2, q2 = g2[..., :3], g2[..., 3:]
    t = t1 + quat_rotate(q1, t2)
    q = quat_mul(q1, q2)
    return torch.cat([t, q], dim=-1)


def inv(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:]
    qi = quat_conj(q)
    return torch.cat([-quat_rotate(qi, t), qi], dim=-1)


def act(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply transforms to points: g (..., 7) x p (..., 3) -> (..., 3)."""
    return quat_rotate(g[..., 3:], p) + g[..., :3]


def rotation_matrix(g: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> the rotation block (..., 3, 3) of :func:`matrix`."""
    x, y, z, w = g[..., 3:].unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def matrix(g: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> homogeneous (..., 4, 4)."""
    top = torch.cat([rotation_matrix(g), g[..., :3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def normalize(g: torch.Tensor) -> torch.Tensor:
    """Re-normalize the quaternion part (drift control over iterations)."""
    t, q = g[..., :3], g[..., 3:]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return torch.cat([t, q], dim=-1)
