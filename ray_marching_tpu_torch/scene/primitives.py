"""SDF primitives as componentwise tensor functions.

Counterpart of ``ray_marching_tpu/scene/primitives.py``: each maps
query-coordinate planes ``(x, y, z)`` and a parameter dict to a distance
plane, with the same formulas, the same evaluation order and the same
select (``where``) masks. :mod:`ray_marching_tpu_torch.scene.codegen` emits
the same op sequences as kernel source.
"""

from __future__ import annotations

import torch

from ray_marching_tpu_torch.utils import clamp, vmax


def sphere(params, x, y, z):
    """``|p| - radius``. Params: ``radius`` (scalar)."""
    return torch.sqrt(x * x + y * y + z * z) - params["radius"]


def box(params, x, y, z):
    """Exact box SDF. Params: ``halfsides`` (3,).

    ``|relu(|p| - h)| + min(max_i(|p| - h)_i, 0)`` with strict ``> 0`` /
    ``< 0`` select masks."""
    h = params["halfsides"]
    qx = torch.abs(x) - h[0]
    qy = torch.abs(y) - h[1]
    qz = torch.abs(z) - h[2]
    q_max = vmax(vmax(qx, qy), qz)
    rx = torch.where(qx > 0, qx, 0.0)
    ry = torch.where(qy > 0, qy, 0.0)
    rz = torch.where(qz > 0, qz, 0.0)
    outside = torch.sqrt(rx * rx + ry * ry + rz * rz)
    inside = torch.where(q_max < 0, q_max, 0.0)
    return outside + inside


def plane(params, x, y, z):
    """The plane x = 0. No params."""
    del params, y, z
    return x


def line(params, x, y, z):
    """Capsule from ``start`` to ``end`` with ``radius``;
    ``t = clamp(<AP, AB> / |AB|², 0, 1)``."""
    s, e, r = params["start"], params["end"], params["radius"]
    abx, aby, abz = e[0] - s[0], e[1] - s[1], e[2] - s[2]
    length2 = abx * abx + aby * aby + abz * abz
    apx, apy, apz = x - s[0], y - s[1], z - s[2]
    t = clamp((apx * abx + apy * aby + apz * abz) / length2, 0.0, 1.0)
    dx = t * abx - apx
    dy = t * aby - apy
    dz = t * abz - apz
    return torch.sqrt(dx * dx + dy * dy + dz * dz) - r


def disk(params, x, y, z):
    """Solid disk with axis x, radial in (y, z). Params: ``radius``."""
    r_dist = torch.sqrt(y * y + z * z) - params["radius"]
    rr = torch.where(r_dist > 0, r_dist, 0.0)
    return torch.sqrt(x * x + rr * rr)


def torus(params, x, y, z):
    """Torus: ring radius ``radius1`` in the xz-plane, tube ``radius2``."""
    a = torch.sqrt(x * x + z * z) - params["radius1"]
    return torch.sqrt(a * a + y * y) - params["radius2"]
