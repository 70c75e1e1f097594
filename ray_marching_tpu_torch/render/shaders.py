"""The eight-shader stack and the cyclic colourmap (counterpart of
``ray_marching_tpu/render/shaders.py``).

The vector-form shaders below work on ``(N, H, W, ·)`` tensors and serve the
modular pipeline (:class:`ray_marching_tpu_torch.render.pipeline.Renderer`);
the plane-form ones live in
:meth:`ray_marching_tpu_torch.render.fast.FastRenderer._shade`, as in the JAX
package. Formula-exact including the quirks the golden images depend on: the
``1e-2`` distance clamps and ``1/2.33`` gamma, whole-tensor min/max
normalisations (``utils.rmin``/``rmax``), the spin shader's ``(im, re)``
passed into the ``(real, imag)`` slots, and the 4096-row colourmap
(``data/cyclic_cmap.npy``, this package's own copy) gathered exactly by
``floor → int → mod``. ``cmap_coeffs`` (``RenderConfig.cmap_fourier``)
swaps the gather for an 8-harmonic Fourier fit of the same table, evaluated
without a gather or a transcendental. Not ported yet: reductions across mesh
axes (``axis_names``).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ray_marching_tpu_torch import quat
from ray_marching_tpu_torch.utils import clamp, not_ported, rmax, rmin

_GAMMA = 1.0 / 2.33
_CMAP_PATH = Path(__file__).resolve().parent.parent / "data" / "cyclic_cmap.npy"

MODES = (
    "lambertian",
    "distance",
    "proximity",
    "vignette",
    "normal",
    "laplacian",
    "tangent",
    "spin",
)


def load_cyclic_cmap(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The (4096, 3) cyclic colourmap."""
    return torch.as_tensor(np.load(_CMAP_PATH), dtype=dtype, device=device)


def _cmap_rows(real, imag, cyclic_cmap, degree):
    """The colourmap row ``floor((atan2(im, re)/τ + 0.5)·degree·K) mod K`` of
    every element: ``real.shape + (3,)``."""
    k = cyclic_cmap.shape[0]
    idx = torch.floor(
        (torch.atan2(imag, real) / math.tau + 0.5) * degree * k
    ).to(torch.int32)
    return cyclic_cmap[torch.remainder(idx, k).long()]


def angle_colouring(real, imag, cyclic_cmap, degree):
    """Hue from the complex argument, as 3 channel planes."""
    rows = _cmap_rows(real, imag, cyclic_cmap, degree)
    return [rows[..., c] for c in range(3)]


def domain_colouring(real, imag, cyclic_cmap, degree, cmap_coeffs=None):
    """Angle colouring scaled by the modulus, as 3 channel planes (the
    Fourier hue when ``cmap_coeffs`` is given)."""
    cols = (angle_colouring(real, imag, cyclic_cmap, degree)
            if cmap_coeffs is None
            else angle_colouring_fourier(real, imag, cmap_coeffs, degree))
    brightness = torch.sqrt(real * real + imag * imag)
    return [brightness * c for c in cols]


# -- gather-free colourmap (Fourier evaluation) -----------------------------
#
# The colourmap is band-limited: an 8-harmonic Fourier fit matches it to
# 0.02/255, far below the table's own 1/4096-turn quantization. Evaluating
# the series takes ~60 multiply-adds, no gather and no atan2 (the angle
# enters through cos/sin, from re/im by normalization and de Moivre), and
# is differentiable in the angle where the gather is piecewise constant.
# Opt-in (RenderConfig.cmap_fourier): golden parity pins the gather.

FOURIER_HARMONICS = 8


def fourier_cmap_coeffs(cmap=None, harmonics: int = FOURIER_HARMONICS):
    """Least-squares Fourier fit of a cyclic colourmap (default: this
    package's ``data/cyclic_cmap.npy``).

    Returns (1 + 2·harmonics, 3) numpy float64 coefficients ordered
    [dc, cos 1θ, sin 1θ, cos 2θ, sin 2θ, …], table row ``i`` placed at the
    bin-centre angle ``(i + 0.5)·2π/K``."""
    cm = np.asarray(np.load(_CMAP_PATH) if cmap is None else cmap,
                    np.float64)
    k = cm.shape[0]
    theta = (np.arange(k) + 0.5) * (2.0 * np.pi / k)
    cols = [np.ones(k)]
    for h in range(1, harmonics + 1):
        cols += [np.cos(h * theta), np.sin(h * theta)]
    coef, *_ = np.linalg.lstsq(np.stack(cols, axis=1), cm, rcond=None)
    return coef


def angle_colouring_fourier(real, imag, coeffs, degree):
    """Gather-free :func:`angle_colouring`: the Fourier fit at the
    continuous angle ``degree·(atan2(im, re) + π)``. ``cos``/``sin`` of the
    base angle come from normalizing (re, im), the degree multiple and the
    harmonics from angle-addition recurrences. Returns 3 channel tensors
    shaped like ``real``."""
    r = torch.sqrt(real * real + imag * imag)
    pos = r > 0
    safe = torch.where(pos, r, torch.ones_like(r))
    # Base angle a + π: cos = −re/r, sin = −im/r; r == 0 gives the gather's
    # atan2(0, 0) = 0, so the angle π.
    c0 = torch.where(pos, -real / safe, -torch.ones_like(r))
    s0 = torch.where(pos, -imag / safe, torch.zeros_like(r))
    cd, sd = torch.ones_like(c0), torch.zeros_like(s0)
    for _ in range(abs(int(degree))):
        cd, sd = cd * c0 - sd * s0, cd * s0 + sd * c0
    if degree < 0:
        sd = -sd
    # The coefficients rounded to the tensors' dtype, as JAX's
    # jnp.asarray(c, dtype) does.
    coef = torch.as_tensor(np.asarray(coeffs), dtype=real.dtype).tolist()
    harmonics = (len(coef) - 1) // 2
    out = [torch.full_like(real, coef[0][j]) for j in range(3)]
    ch, sh = cd, sd
    for h in range(1, harmonics + 1):
        for j in range(3):
            out[j] = out[j] + coef[2 * h - 1][j] * ch + coef[2 * h][j] * sh
        if h < harmonics:
            ch, sh = ch * cd - sh * sd, ch * sd + sh * cd
    return out


def domain_colouring_fourier(real, imag, coeffs, degree):
    """Gather-free domain colouring, vector form: (..., 3)."""
    cols = angle_colouring_fourier(real, imag, coeffs, degree)
    brightness = torch.sqrt(real**2 + imag**2)
    return torch.stack([brightness * c for c in cols], dim=-1)


# -- vector-form shaders: (N, H, W, ·) tensors ------------------------------


def _no_axis_names(axis_names):
    if axis_names:
        raise not_ported("axis_names (shader reductions across mesh axes)")


def lambertian(ray_directions, surface_normals):
    """``clamp(−⟨v, N⟩, 0, 1)`` → 1 channel."""
    return clamp(-torch.sum(ray_directions * surface_normals, dim=-1,
                            keepdim=True), 0.0, 1.0)


def _log_minmax_norm(values):
    log_d = torch.log(clamp(values, 1e-2))
    lo, hi = rmin(log_d), rmax(log_d)
    return ((log_d - lo) / (hi - lo)) ** _GAMMA


def distance(px_coords, surface_coords, axis_names=()):
    """Log travel distance, min-max normalized over the whole tensor,
    gamma-corrected → 1 channel."""
    _no_axis_names(axis_names)
    return _log_minmax_norm(torch.linalg.norm(
        px_coords - surface_coords, dim=-1, keepdim=True))


def proximity(surface_distances, axis_names=()):
    """The same normalization on the terminal SDF values → 1 channel."""
    _no_axis_names(axis_names)
    return _log_minmax_norm(surface_distances)


def vignette(ray_directions, pixel_frames):
    """``⟨v, R·e_z⟩³``: cosine-to-optical-axis falloff, per camera
    (``pixel_frames`` is (N, 3, 3); its third column is the optical axis)."""
    axis = pixel_frames[:, None, None, :, 2]
    return torch.sum(ray_directions * axis, dim=-1, keepdim=True) ** 3


def normal(surface_normals):
    """RGB = |N| clamped → 3 channels."""
    return clamp(torch.abs(surface_normals), 0.0, 1.0)


def laplacian(surface_laplacian, axis_names=()):
    """Laplacian mapped ``(1 − L/max|L|)/2``, clamped, gamma-corrected →
    1 channel."""
    _no_axis_names(axis_names)
    x = surface_laplacian / rmax(torch.abs(surface_laplacian))
    return clamp((1.0 - x) / 2.0, 0.0, 1.0) ** _GAMMA


def _domain_colouring_vec(real, imag, cyclic_cmap, degree):
    brightness = torch.sqrt(real**2 + imag**2)[..., None]
    return brightness * _cmap_rows(real, imag, cyclic_cmap, degree)


def tangent(camera_orientation_conj, ray_directions, surface_normals,
            cyclic_cmap, degree=1, cmap_coeffs=None):
    """Screen-space tangent field: N projected onto the sensor plane, rotated
    into the camera frame with q̄, domain-coloured → 3 channels."""
    projected = quat.rotation(
        surface_normals
        - torch.sum(surface_normals * ray_directions, dim=-1, keepdim=True)
        * ray_directions,
        camera_orientation_conj,
    )
    if cmap_coeffs is not None:
        return domain_colouring_fourier(projected[..., 0], projected[..., 1],
                                        cmap_coeffs, degree)
    return _domain_colouring_vec(projected[..., 0], projected[..., 1],
                                 cyclic_cmap, degree)


def spin(camera_orientation_conj, surface_normals, cyclic_cmap, degree=1,
         cmap_coeffs=None):
    """S³→S¹ fibration colouring of ``q̄·(0, N)``; the ``(im, re)`` pair goes
    into domain colouring's ``(real, imag)`` slots, as in the reference."""
    zeros = torch.zeros(surface_normals.shape[:-1] + (1,),
                        dtype=surface_normals.dtype,
                        device=surface_normals.device)
    value = quat.multiply(torch.cat([zeros, surface_normals], dim=-1),
                          camera_orientation_conj)
    a, bcd = value[..., 0], value[..., 1:]
    real_part = a**2 - torch.sum(bcd**2, dim=-1)
    imag_part = torch.linalg.norm(bcd, dim=-1) * a * 2.0
    if cmap_coeffs is not None:
        return domain_colouring_fourier(imag_part, real_part, cmap_coeffs,
                                        degree)
    return _domain_colouring_vec(imag_part, real_part, cyclic_cmap, degree)


def shade(
    mode: int,
    *,
    px_coords,
    camera_orientation,
    pixel_frames,
    ray_directions,
    surface_coords,
    surface_normals,
    surface_laplacian,
    surface_distances,
    cyclic_cmap,
    degree: int = 1,
    axis_names=(),
    cmap_coeffs=None,
):
    """One of the eight shaders by mode index (``mode % 8``, the reference's
    wraparound). Returns (N, H, W, 1 or 3)."""
    name = MODES[mode % len(MODES)]
    if name == "lambertian":
        return lambertian(ray_directions, surface_normals)
    if name == "distance":
        return distance(px_coords, surface_coords, axis_names)
    if name == "proximity":
        return proximity(surface_distances, axis_names)
    if name == "vignette":
        return vignette(ray_directions, pixel_frames)
    if name == "normal":
        return normal(surface_normals)
    if name == "laplacian":
        return laplacian(surface_laplacian, axis_names)
    conj = quat.conjugate(camera_orientation)[:, None, None, :]
    if name == "tangent":
        return tangent(conj, ray_directions, surface_normals, cyclic_cmap,
                       degree, cmap_coeffs)
    return spin(conj, surface_normals, cyclic_cmap, degree, cmap_coeffs)


def shade_all(**kwargs):
    """Every shader mode at once: ``{mode_name: image}``."""
    return {name: shade(i, **kwargs) for i, name in enumerate(MODES)}
