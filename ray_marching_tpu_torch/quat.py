"""Quaternion algebra on tensors (wxyz, Hamilton convention).

Counterpart of ``ray_marching_tpu/quat.py``, with its two APIs: a vector API
on tensors of shape ``(..., 4)`` / ``(..., 3)`` (camera, shaders of the
modular pipeline) and a componentwise API on x/y/z planes (scene compiler,
plane-native renderer). Each function keeps the JAX evaluation order term
for term, so f64 results match bit for bit wherever the two frameworks round
the same elementary ops.
"""

from __future__ import annotations

import torch


# -- vector API: (..., 3) vectors, (..., 4) quaternions ---------------------


def cross(u, v):
    """Cross product along the last axis."""
    return torch.stack(
        [
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
        ],
        dim=-1,
    )


def multiply(p, q):
    """Hamilton product of two wxyz quaternions."""
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy + py * qw + pz * qx - px * qz,
            pw * qz + px * qy + pz * qw - py * qx,
        ],
        dim=-1,
    )


def conjugate(q):
    """Quaternion conjugate: negate the vector part."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def rotation(v, q):
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4):
    ``v' = v + w·t + q_v × t`` with ``t = 2 q_v × v``."""
    qv = q[..., 1:]
    t = cross(qv, v) * 2
    return cross(qv, t) + q[..., 0:1] * t + v


def to_versor(v):
    """Lift a small vector in the 3-ball to a unit quaternion on S³
    (``w = sqrt(1 - |v|²)`` prepended; NaN for ``|v| > 1``)."""
    w = torch.sqrt(1.0 - torch.sum(v * v, dim=-1, keepdim=True))
    return torch.cat([w, v], dim=-1)


def normalize(q):
    """L2-normalize along the last axis (eps-free)."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def to_so3(q):
    """Rotation matrix (..., 3, 3) of a unit quaternion (..., 4)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = torch.stack(
        [
            ww + xx - yy - zz, 2 * (xy - wz), 2 * (wy + xz),
            2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
            2 * (xz - wy), 2 * (wx + yz), ww - xx - yy + zz,
        ],
        dim=-1,
    )
    return rows.reshape(rows.shape[:-1] + (3, 3))


# -- componentwise API: x/y/z planes of identical shape ---------------------


def cross_c(ux, uy, uz, vx, vy, vz):
    """Componentwise cross product; returns (x, y, z) planes."""
    return (uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx)


def rotate_c(qw, qx, qy, qz, x, y, z):
    """Rotate component planes (x, y, z) by a (possibly scalar) quaternion:
    ``v' = v + w·t + q_v × t`` with ``t = 2 q_v × v``."""
    tx, ty, tz = cross_c(qx, qy, qz, x, y, z)
    tx, ty, tz = 2 * tx, 2 * ty, 2 * tz
    cx, cy, cz = cross_c(qx, qy, qz, tx, ty, tz)
    return (cx + qw * tx + x, cy + qw * ty + y, cz + qw * tz + z)


def multiply_c(pw, px, py, pz, qw, qx, qy, qz):
    """Componentwise Hamilton product; returns (w, x, y, z) planes."""
    return (
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy + py * qw + pz * qx - px * qz,
        pw * qz + px * qy + pz * qw - py * qx,
    )
