"""Implicit-function-theorem backward for the sphere-tracing fixed point
(counterpart of ``ray_marching_tpu/render/implicit.py``; the modular
pipeline's form: plain tensor code around :mod:`.march`).

At convergence the marched point satisfies ``p* = p0 + t*·v`` with
``f(θ, p*) = 0``. Differentiating the hit condition gives

    ∂t*/∂θ  = −f_θ / (v·∇f),    ∂t*/∂p0 = −∇f / (v·∇f),
    ∂t*/∂v  = −t*·∇f / (v·∇f),

so the backward needs one SDF VJP at the endpoint instead of backprop
through the whole march: O(1) instead of O(steps) in time and memory. The
denominator ``v·∇f`` vanishes for grazing rays and is clamped away from 0
(``denom_eps``); rays that never converged (``|f(p*)| >= hit_threshold``)
have no fixed point and get zero parameter gradient.

The two entry points are ``torch.autograd.Function``s under the hood (the
JAX package's are ``custom_vjp``s); the parameter dict is handed to them leaf
by leaf so that autograd sees every leaf.
"""

from __future__ import annotations

import torch

from ray_marching_tpu_torch.render import march as march_mod
from ray_marching_tpu_torch.scene.graph import param_paths


def _unflatten(paths, leaves):
    """Nested parameter dict from ``a/b/c`` paths and their leaves."""
    out = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, key = path.split("/")
        for parent in parents:
            node = node.setdefault(parent, {})
        node[key] = leaf
    return out


def _march_closest_argmin(sdf_vec, params, ray_positions, ray_directions,
                          steps, tau):
    """Forward march tracking (p*, min_f, arg-min position p_m): strict ``<``
    updates, so the first attaining step wins."""
    p = p_m = ray_positions
    min_f = torch.full(ray_positions.shape[:-1] + (1,),
                       torch.finfo(ray_positions.dtype).max,
                       dtype=ray_positions.dtype,
                       device=ray_positions.device)
    for _ in range(steps):
        d = sdf_vec(params, p)
        take = d < min_f
        p_m = torch.where(take, p, p_m)
        min_f = torch.where(take, d, min_f)
        if tau != 0.0:
            p = torch.where(torch.abs(d) < tau, p, p + d * ray_directions)
        else:
            p = p + d * ray_directions
    return p, min_f, p_m


def _endpoint_routing(sdf_vec, paths, leaves, p_star, p0, v, g, hit_threshold,
                      denom_eps):
    """The IFT cotangents of (leaves, p0, v) for the cotangent ``g`` of the
    marched endpoint."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    p = p_star.detach().requires_grad_(True)
    with torch.enable_grad():
        f_val = sdf_vec(_unflatten(paths, leaves), p)
    (nabla_f,) = torch.autograd.grad(f_val, p, torch.ones_like(f_val),
                                     retain_graph=True)
    denom = torch.sum(v * nabla_f, dim=-1, keepdim=True)
    safe = torch.where(denom.abs() < denom_eps,
                       torch.where(denom < 0, -denom_eps, denom_eps), denom)
    hit = f_val.detach().abs() < hit_threshold
    g_dot_v = torch.sum(g * v, dim=-1, keepdim=True)
    w = torch.where(hit, -g_dot_v / safe, torch.zeros_like(g_dot_v))
    leaf_cots = (torch.autograd.grad(f_val, leaves, w, allow_unused=True)
                 if leaves else ())
    # Signed travel distance (a ray can march backwards out of a negative
    # start): the displacement projected onto the unit direction.
    t_star = torch.sum((p_star - p0) * v, dim=-1, keepdim=True)
    p0_cot = g + nabla_f * w
    return list(leaf_cots), p0_cot, t_star * p0_cot


class _MarchImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sdf_vec, paths, steps, tau, hit_threshold, denom_eps,
                p0, v, *leaves):
        p_star = march_mod.march(sdf_vec, _unflatten(paths, leaves), p0, v,
                                 steps, tau=tau)
        ctx.cfg = (sdf_vec, paths, hit_threshold, denom_eps)
        ctx.save_for_backward(p_star, p0, v, *leaves)
        return p_star

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        sdf_vec, paths, hit_threshold, denom_eps = ctx.cfg
        p_star, p0, v, *leaves = ctx.saved_tensors
        leaf_cots, p0_cot, v_cot = _endpoint_routing(
            sdf_vec, paths, leaves, p_star, p0, v, g, hit_threshold,
            denom_eps)
        return (None,) * 6 + (p0_cot, v_cot) + tuple(leaf_cots)


class _MarchClosestImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sdf_vec, paths, steps, tau, hit_threshold, denom_eps,
                p0, v, *leaves):
        p_star, min_f, p_m = _march_closest_argmin(
            sdf_vec, _unflatten(paths, leaves), p0, v, steps, tau)
        ctx.cfg = (sdf_vec, paths, hit_threshold, denom_eps)
        ctx.save_for_backward(p_star, p_m, p0, v, *leaves)
        return p_star, min_f

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_p, g_minf):
        sdf_vec, paths, hit_threshold, denom_eps = ctx.cfg
        p_star, p_m, p0, v, *leaves = ctx.saved_tensors
        leaf_cots, p0_cot, v_cot = _endpoint_routing(
            sdf_vec, paths, leaves, p_star, p0, v, g_p, hit_threshold,
            denom_eps)
        # min_f with the arg-min frozen: one more joint VJP of f at p_m. The
        # route p_m = p0 + t_m·v (t_m frozen) carries its position cotangent
        # to the ray.
        at_min = [leaf.detach().requires_grad_(True) for leaf in leaves]
        pm = p_m.detach().requires_grad_(True)
        with torch.enable_grad():
            f_m = sdf_vec(_unflatten(paths, at_min), pm)
        *min_cots, pm_cot = torch.autograd.grad(f_m, at_min + [pm], g_minf,
                                                allow_unused=True)
        leaf_cots = [b if a is None else (a if b is None else a + b)
                     for a, b in zip(leaf_cots, min_cots)]
        t_m = torch.sum((p_m - p0) * v, dim=-1, keepdim=True)
        return ((None,) * 6 + (p0_cot + pm_cot, v_cot + t_m * pm_cot)
                + tuple(leaf_cots))


def _apply(fn, sdf_vec, params, ray_positions, ray_directions, steps, tau,
           hit_threshold, denom_eps):
    flat = param_paths(params)
    return fn.apply(sdf_vec, tuple(flat), steps, tau, hit_threshold,
                    denom_eps, ray_positions, ray_directions, *flat.values())


def march_implicit(sdf_vec, params, ray_positions, ray_directions,
                   steps: int, tau: float = 0.0, hit_threshold: float = 0.05,
                   denom_eps: float = 1e-6):
    """March with IFT gradients; the forward is :func:`march.march`."""
    return _apply(_MarchImplicit, sdf_vec, params, ray_positions,
                  ray_directions, steps, tau, hit_threshold, denom_eps)


def march_with_closest_implicit(sdf_vec, params, ray_positions,
                                ray_directions, steps: int, tau: float = 0.0,
                                hit_threshold: float = 0.05,
                                denom_eps: float = 1e-6):
    """:func:`march.march_with_closest` forward with an O(1) backward: the
    endpoint gets the routing of :func:`march_implicit`; the closest approach
    ``min_f`` gets the arg-min-frozen rule ``∂min_f/∂θ ≈ f_θ(θ, p_m)`` with
    the arg-min position ``p_m`` held constant. Returns ``(marched positions,
    min_f)``."""
    return _apply(_MarchClosestImplicit, sdf_vec, params, ray_positions,
                  ray_directions, steps, tau, hit_threshold, denom_eps)
