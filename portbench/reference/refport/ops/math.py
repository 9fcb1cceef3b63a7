"""Quaternion and spatial (6D) rigid-body math, MuJoCo conventions.

Counterpart of ``puppax/ops/math.py``. The JAX functions take single
operands and are batched with ``vmap``; these take tensors whose LAST axis
holds the components, with any leading batch axes, so they serve both.

Conventions: quaternions are (w, x, y, z); spatial vectors are
[angular(3); linear(3)]; spatial inertia is a (6, 6) matrix in that order.
"""

from __future__ import annotations

import math as _pymath

import torch


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u ⊗ v."""
    u0, u1, u2, u3 = u.unbind(-1)
    v0, v1, v2, v3 = v.unbind(-1)
    return torch.stack(
        [
            u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
            u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
            u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
            u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotate a 3-vector by a unit quaternion (q v q*), brax formula."""
    s, u = quat[..., :1], quat[..., 1:]
    r = 2.0 * (_dot(u, vec) * u) + (s * s - _dot(u, u)) * vec
    return r + 2.0 * s * torch.linalg.cross(u, vec.expand_as(u))


def rotate_inv(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotate a 3-vector by the inverse of a unit quaternion."""
    return rotate(vec, quat_inv(quat))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (column i = rotate(e_i))."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_to_quat(v: torch.Tensor) -> torch.Tensor:
    """Euler angles in DEGREES, intrinsic x-y'-z'' (brax convention)."""
    half = v * (_pymath.pi / 360.0)
    c1, c2, c3 = torch.cos(half).unbind(-1)
    s1, s2, s3 = torch.sin(half).unbind(-1)
    w = c1 * c2 * c3 - s1 * s2 * s3
    x = s1 * c2 * c3 + c1 * s2 * s3
    y = c1 * s2 * c3 - s1 * c2 * s3
    z = c1 * c2 * s3 + s1 * s2 * c3
    return torch.stack([w, x, y, z], -1)


def normalize(v: torch.Tensor, eps: float = 1e-6):
    """(unit vector, norm) with safe division (brax.math.normalize)."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / (norm + eps), norm[..., 0]


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a unit quaternion by a body-frame angular velocity."""
    norm = torch.linalg.vector_norm(omega_local, dim=-1, keepdim=True)
    angle = norm * dt
    axis = omega_local / torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    half = 0.5 * angle
    dq = torch.cat([torch.cos(half), axis * torch.sin(half)], -1)
    out = quat_mul(q, dq)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial cross product of two motion vectors: v x m."""
    ang = torch.linalg.cross(v[..., :3], m[..., :3])
    lin = torch.linalg.cross(v[..., :3], m[..., 3:]) + torch.linalg.cross(
        v[..., 3:], m[..., :3]
    )
    return torch.cat([ang, lin], -1)


def motion_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product of a motion vector with a force vector."""
    ang = torch.linalg.cross(v[..., :3], f[..., :3]) + torch.linalg.cross(
        v[..., 3:], f[..., 3:]
    )
    lin = torch.linalg.cross(v[..., :3], f[..., 3:])
    return torch.cat([ang, lin], -1)


def inert_mul(I: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Spatial inertia (..., 6, 6) times motion vector (..., 6)."""
    return (I @ v[..., None])[..., 0]


def _skew(c: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(c[..., 0])
    x, y, z = c.unbind(-1)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def transform_inertia(
    mass: torch.Tensor, diag_inertia: torch.Tensor, ipos: torch.Tensor,
    imat: torch.Tensor,
) -> torch.Tensor:
    """(..., 6, 6) spatial inertia about a frame origin:
    [[I + m cx cx^T, m cx], [m cx^T, m 1]] (MuJoCo cinert, dense)."""
    I3 = (imat * diag_inertia[..., None, :]) @ imat.transpose(-1, -2)
    m_ = mass[..., None, None]
    eye3 = torch.eye(3, dtype=ipos.dtype, device=ipos.device)
    cc = ipos[..., :, None] * ipos[..., None, :]
    dot = (ipos * ipos).sum(-1)[..., None, None]
    top_left = I3 + m_ * (dot * eye3 - cc)
    top_right = m_ * _skew(ipos)
    top = torch.cat([top_left, top_right], -1)
    bottom = torch.cat([top_right.transpose(-1, -2), m_ * eye3.expand_as(top_left)], -1)
    return torch.cat([top, bottom], -2)


def transform_motion(v: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Shift a spatial motion vector: [w; p - offset x w]."""
    ang = v[..., :3]
    return torch.cat([ang, v[..., 3:] - torch.linalg.cross(offset, ang)], -1)


def ad_dual(offset: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Shift a spatial force vector: torque about the new point."""
    return torch.cat([f[..., :3] + torch.linalg.cross(offset, f[..., 3:]), f[..., 3:]], -1)
