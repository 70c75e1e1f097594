"""Sphere-tracing marcher of the modular pipeline: ``p ← p + f(p)·v``
(counterpart of ``ray_marching_tpu/render/march.py``).

Plain tensor code: the JAX package's ``lax.scan`` is a Python loop here, and
``remat=True`` wraps each step in ``torch.utils.checkpoint`` (the same values
and gradients, less memory held for the backward). The extensions over the
unconditional reference loop are the JAX package's:

* early-exit masking: rays with ``|f(p)| < tau`` freeze, by ``torch.where``
  (never by multiplying with a mask, except :func:`march_planes`, which
  multiplies as its JAX counterpart does); ``tau = 0`` is the reference's
  unconditional update;
* the along-ray closest approach (:func:`march_with_closest`);
* mirror reflection (:func:`reflect`), used by the pipeline's bounces.

The hand-written kernel form of the march is
:mod:`ray_marching_tpu_torch.ops.march_kernel`; the implicit-function-theorem
backward is :mod:`ray_marching_tpu_torch.render.implicit`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _maybe_remat(step, remat):
    if not remat:
        return step
    return lambda *carry: checkpoint(step, *carry, use_reentrant=False)


def march(sdf_vec, params, ray_positions, ray_directions, steps: int,
          *, tau: float = 0.0, remat: bool = False):
    """March ``ray_positions`` (..., 3) along ``ray_directions`` through the
    scene SDF ``sdf_vec`` (``(..., 3) -> (..., 1)``) for ``steps`` steps;
    returns the marched positions. ``tau`` is the early-exit threshold (0
    disables masking), ``remat`` recomputes each step in the backward."""
    if tau == 0.0:
        step = _maybe_remat(
            lambda p: p + sdf_vec(params, p) * ray_directions, remat)
        p = ray_positions
        for _ in range(steps):
            p = step(p)
        return p

    def masked_step(p, done):
        d = sdf_vec(params, p)
        done = torch.logical_or(done, torch.abs(d) < tau)
        return torch.where(done, p, p + d * ray_directions), done

    step = _maybe_remat(masked_step, remat)
    p = ray_positions
    done = torch.zeros(ray_positions.shape[:-1] + (1,), dtype=torch.bool,
                       device=ray_positions.device)
    for _ in range(steps):
        p, done = step(p, done)
    return p


def march_with_closest(sdf_vec, params, ray_positions, ray_directions,
                       steps: int, *, tau: float = 0.0, remat: bool = False):
    """March and track the along-ray closest approach ``min_i f(p_i)``, the
    quantity silhouette-aware gradients need (render/silhouette.py): for a
    ray that misses, it is smooth in the scene parameters where hit/miss is a
    step.

    Returns ``(marched positions (..., 3), min_f (..., 1))``."""

    def closest_step(p, min_f):
        d = sdf_vec(params, p)
        if tau != 0.0:
            p_next = torch.where(torch.abs(d) < tau, p,
                                 p + d * ray_directions)
        else:
            p_next = p + d * ray_directions
        return p_next, torch.minimum(min_f, d)

    step = _maybe_remat(closest_step, remat)
    p = ray_positions
    min_f = torch.full(ray_positions.shape[:-1] + (1,),
                       torch.finfo(ray_positions.dtype).max,
                       dtype=ray_positions.dtype,
                       device=ray_positions.device)
    for _ in range(steps):
        p, min_f = step(p, min_f)
    return p, min_f


def march_unrolled(sdf_vec, params, ray_positions, ray_directions, steps: int):
    """The reference's unconditional loop, written out."""
    p = ray_positions
    for _ in range(steps):
        p = p + sdf_vec(params, p) * ray_directions
    return p


def march_planes(sdf_c, params, px, py, pz, dx, dy, dz, steps: int,
                 *, tau: float = 0.0):
    """Componentwise marcher over coordinate planes of one shape; returns
    the marched (x, y, z) planes. With ``tau`` a frozen ray's distance is
    multiplied by 0, as in the JAX package."""
    x, y, z = px, py, pz
    for _ in range(steps):
        d = sdf_c(params, x, y, z)
        if tau != 0.0:
            d = d * (torch.abs(d) >= tau).to(d.dtype)
        x, y, z = x + d * dx, y + d * dy, z + d * dz
    return x, y, z


def reflect(ray_directions, surface_normals):
    """Mirror reflection ``v' = v + 2⟨N, −v⟩N``."""
    proj = torch.sum(surface_normals * (-ray_directions), dim=-1,
                     keepdim=True)
    return 2.0 * proj * surface_normals + ray_directions
