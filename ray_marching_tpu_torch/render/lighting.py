"""Ambient occlusion and soft-shadow lighting: the two shader modes beyond
the reference's eight (counterpart of ``ray_marching_tpu/render/lighting.py``).

* ``"occlusion"``: SDF-sampled ambient occlusion. The field is probed at a
  few points along the surface normal; where it falls short of the probe
  height, nearby geometry occludes ambient light.
* ``"shaded"``: directional-light Lambertian × soft shadow × ambient
  occlusion. The shadow term sphere-traces a secondary ray toward the light
  and keeps the penumbra estimate ``min(k · f(t) / t)`` along it.

Everything is componentwise over the scene's torch SDF ``sdf_c(params, x,
y, z)`` (``scene.graph.compile_scene``, which reaches the ``NeuralSDF``
matrices and custom nodes such as the Mandelbulb), on any shape of
coordinate tensors: the plane-native renderer passes its hit planes, the
modular one the unstacked components of its image grids, so the two agree to
roundoff. The lighting queries are plain PyTorch on the card: no kernel
evaluates them. Differentiable end to end: the running minimum and the
clamps are the where-selects :func:`utils.vmin` / :func:`utils.clamp`, so
cotangents reach the arg-min sample only.

The modes dispatch by name (``mode="shaded"``): integer modes keep the
reference's ``mode % 8`` wraparound.
"""

from __future__ import annotations

import math

from ray_marching_tpu_torch.utils import clamp, vmin

#: Shader modes beyond the reference's eight, dispatched by name.
EXTRA_MODES = ("occlusion", "shaded")

#: Initial offset along the shadow ray (escapes the |f| ~ 0 shell at the
#: hit point before the penumbra estimate starts dividing by t).
SHADOW_T0 = 0.02
#: Per-step march-distance clamp for the shadow ray: the minimum guarantees
#: progress past the surface shell, the maximum bounds the traced range to
#: steps * SHADOW_STEP_MAX.
SHADOW_STEP_MAX = 0.5
#: Geometric weight decay of successive AO probes.
AO_FALLOFF = 0.7


def normalized_light(light_direction):
    """Unit light direction (from the surface toward the light) as a tuple
    of python floats."""
    lx, ly, lz = (float(v) for v in light_direction)
    norm = math.sqrt(lx * lx + ly * ly + lz * lz)
    if norm == 0.0:
        raise ValueError("light_direction must be nonzero")
    return lx / norm, ly / norm, lz / norm


def ambient_occlusion(sdf_c, params, p, n, *, samples: int = 5,
                      step: float = 0.05, strength: float = 1.0,
                      falloff: float = AO_FALLOFF):
    """SDF ambient occlusion at surface points ``p`` with normals ``n``.

    Probes the field at ``p + i·step·n`` for ``i = 1..samples``; on open
    ground ``f == i·step`` exactly (occlusion 0). Returns
    ``clamp(1 − strength · Σ w_i (h_i − f_i)/h_i / Σ w_i, 0, 1)`` with
    ``w_i = falloff**(i−1)``: 1 is fully open.

    ``p`` and ``n`` are component triples of equal-shaped tensors."""
    px, py, pz = p
    nx, ny, nz = n
    occ = None
    weight = 1.0
    total = 0.0
    for i in range(1, samples + 1):
        h = i * step
        d = sdf_c(params, px + h * nx, py + h * ny, pz + h * nz)
        term = (weight / h) * (h - d)
        occ = term if occ is None else occ + term
        total += weight
        weight *= falloff
    return clamp(1.0 - (strength / total) * occ, 0.0, 1.0)


def soft_shadow(sdf_c, params, p, n, light_direction, *, steps: int = 16,
                sharpness: float = 16.0, t0: float = SHADOW_T0,
                step_max: float = SHADOW_STEP_MAX, surface_eps: float = 5e-2):
    """Soft shadow factor at surface points ``p``: sphere-trace toward the
    light from ``p + surface_eps·n``, advancing by ``clamp(f, t0,
    step_max)``, and keep ``min_t sharpness·f(t)/t``. Returns a factor in
    [0, 1] (1 fully lit, 0 hard shadow)."""
    lx, ly, lz = normalized_light(light_direction)
    px, py, pz = p
    nx, ny, nz = n
    ox = px + surface_eps * nx
    oy = py + surface_eps * ny
    oz = pz + surface_eps * nz
    res = None
    t = t0
    for _ in range(steps):
        d = sdf_c(params, ox + t * lx, oy + t * ly, oz + t * lz)
        est = sharpness * d / t
        res = est if res is None else vmin(res, est)
        t = t + clamp(d, t0, step_max)
    return clamp(res, 0.0, 1.0)


def shaded_intensity(sdf_c, params, p, n, config):
    """Directional-light intensity ``ao · (ambient + (1 − ambient) ·
    max(0, ⟨n, l⟩) · shadow)``, every term from the render configuration."""
    lx, ly, lz = normalized_light(config.light_direction)
    nx, ny, nz = n
    diffuse = clamp(nx * lx + ny * ly + nz * lz, 0.0, 1.0)
    ao = ambient_occlusion(
        sdf_c, params, p, n,
        samples=config.ao_samples, step=config.ao_step,
        strength=config.ao_strength,
    )
    shadow = soft_shadow(
        sdf_c, params, p, n, config.light_direction,
        steps=config.shadow_steps, sharpness=config.shadow_sharpness,
        surface_eps=config.normals_eps,
    )
    amb = float(config.ambient)
    return clamp(ao * (amb + (1.0 - amb) * diffuse * shadow), 0.0, 1.0)


def shade_extra(name: str, sdf_c, params, p, n, config):
    """One named extra mode → a single intensity channel shaped like
    ``p[0]``."""
    if name == "occlusion":
        return ambient_occlusion(
            sdf_c, params, p, n,
            samples=config.ao_samples, step=config.ao_step,
            strength=config.ao_strength,
        )
    if name == "shaded":
        return shaded_intensity(sdf_c, params, p, n, config)
    raise ValueError(f"unknown extra shader mode: {name!r}")
