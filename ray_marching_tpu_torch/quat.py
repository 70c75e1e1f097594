"""Componentwise quaternion algebra on tensors (wxyz, Hamilton convention).

Counterpart of the componentwise API of ``ray_marching_tpu/quat.py``. Each
function keeps the JAX evaluation order term for term, so f64 results match
bit for bit wherever the two frameworks round the same elementary ops.
"""

from __future__ import annotations


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
