"""Soft silhouette coverage: differentiable hit/miss for sphere tracing
(counterpart of ``ray_marching_tpu/render/silhouette.py``).

Whether a ray hits at all is a step function of the scene parameters, so a
plain pixel loss sees nothing at a silhouette. The march also tracks the
along-ray closest approach ``min_f = min_i f(p_i)`` (plane 8 of
``fused_march_normals_cov``), and visibility is relaxed to

    α = σ(shift − min_f / β).

Sphere tracing converges from outside, so hits bottom out at ``min_f → 0⁺``:
with ``shift = 4`` hits give α = σ(4) ≈ 0.982 and clear misses
(``min_f ≫ β``) give α ≈ 0. ``∂min_f/∂θ`` is well defined through the
arg-min march step, so compositing ``α·image + (1 − α)·background`` carries
silhouette gradients into any pixel loss.
"""

from __future__ import annotations

import torch

DEFAULT_SHIFT = 4.0


def soft_coverage(min_f, beta: float, shift: float = DEFAULT_SHIFT):
    """``α = σ(shift − min_f/β)``: closest approach → coverage (hits ≈
    σ(shift), clear misses ≈ 0)."""
    return torch.sigmoid(shift - min_f / beta)


def composite(image, alpha, background=0.0):
    """``α·image + (1 − α)·background``: silhouette-aware pixel values."""
    return alpha * image + (1.0 - alpha) * background
