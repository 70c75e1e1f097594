"""SDF transformations and combinators (counterpart of
``ray_marching_tpu/scene/ops.py``)."""

from __future__ import annotations

import torch

from ray_marching_tpu_torch import quat
from ray_marching_tpu_torch.utils import vmin


def affine_inverse_query(orientation, translation, x, y, z):
    """Map world-space queries into the child's frame: ``R(q̄)(p - t)``."""
    qw, qx, qy, qz = (
        orientation[0],
        -orientation[1],
        -orientation[2],
        -orientation[3],
    )
    return quat.rotate_c(
        qw, qx, qy, qz, x - translation[0], y - translation[1], z - translation[2]
    )


def smooth_union(blend_k, distances):
    """Soft-min ``-(1/k)·logsumexp(-k·dᵢ)``, max-subtracted.

    The max propagates NaN (``torch.maximum``, as ``jnp.max``); the sum of
    exponentials runs left to right over the children."""
    neg_k = -blend_k
    a = [d * neg_k for d in distances]
    m = a[0]
    for ai in a[1:]:
        m = torch.maximum(m, ai)
    total = torch.exp(a[0] - m)
    for ai in a[1:]:
        total = total + torch.exp(ai - m)
    lse = torch.log(total) + m
    return lse / neg_k


def union(distances):
    """Hard min over children as a select chain (first child wins ties)."""
    out = distances[0]
    for d in distances[1:]:
        out = vmin(out, d)
    return out


def rounding(radius, d):
    """Inflate a shape by ``radius``: ``d - radius``."""
    return d - radius


def onion(radius, d):
    """Shell of thickness ``radius``: ``|d| - radius``."""
    return torch.abs(d) - radius
