"""Surface normals and Laplacians from tetrahedral finite differences
(counterpart of ``ray_marching_tpu/render/normals.py``).

Four SDF samples at scaled tetrahedral offsets give the gradient through a
precomputed 3×3 inverse; the Laplacian is ``(f(p) − mean(f(p + εvᵢ)))·6/ε²``.
The constants are computed in float64 numpy and cast to the requested dtype.
:func:`autodiff_normals` is the exact alternative (the gradient of the SDF).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_marching_tpu_torch.utils import resolve_device

_TETRA = np.asarray(
    [
        [1.0, 0.0, -np.sqrt(0.5)],
        [-1.0, 0.0, -np.sqrt(0.5)],
        [0.0, 1.0, np.sqrt(0.5)],
        [0.0, -1.0, np.sqrt(0.5)],
    ],
    dtype=np.float64,
)


def make_offsets(normals_eps: float, np_dtype=np.float64):
    """Scaled unit tetrahedral offsets (4, 3) and the inverse of the
    relative-offset matrix (3, 3), both as numpy in ``np_dtype``."""
    unit = _TETRA / np.linalg.norm(_TETRA, axis=-1, keepdims=True)
    offsets = (unit * normals_eps).astype(np_dtype)
    relative = offsets[1:4] - offsets[0:1]
    inverse = np.linalg.inv(relative.astype(np.float64)).astype(np_dtype)
    return offsets, inverse


class NormalsEstimator:
    """Holds the offset constants on ``device`` (the card unless the caller
    asks for the CPU, as for :class:`camera.Camera`); :meth:`__call__` is
    pure."""

    def __init__(self, normals_eps: float = 5e-2, dtype=torch.float32,
                 device="cuda"):
        device = resolve_device(device)
        self.normals_eps = normals_eps
        offsets, inverse = make_offsets(normals_eps)
        self.offsets = torch.as_tensor(offsets, dtype=dtype, device=device)
        self.offsets_inverse = torch.as_tensor(inverse, dtype=dtype,
                                               device=device)

    def __call__(self, sdf_vec, params, surface_coords):
        """Tetrahedral normals and Laplacian at ``surface_coords`` (..., 3):
        ``(normals (..., 3), laplacian (..., 1))``."""
        # One batched evaluation over the 4 offsets: (..., 4, 3) -> (..., 4, 1).
        offset_values = sdf_vec(params,
                                surface_coords[..., None, :] + self.offsets)
        d_values = offset_values[..., 1:4, :] - offset_values[..., 0:1, :]
        normals = torch.sum(
            self.offsets_inverse * d_values[..., None, :, 0], dim=-1)
        normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
        centre = sdf_vec(params, surface_coords)
        laplacian = (centre - torch.mean(offset_values, dim=-2)) * (
            6.0 / self.normals_eps**2)
        return normals, laplacian


def autodiff_normals(sdf_vec, params, surface_coords):
    """Exact normals: the gradient of the SDF, normalized. Stays
    differentiable (``create_graph=True``), so a loss on these normals
    reaches the parameters and the coordinates."""
    with torch.enable_grad():
        coords = surface_coords
        if not coords.requires_grad:
            coords = coords.detach().requires_grad_(True)
        total = sdf_vec(params, coords)[..., 0].sum()
        (grads,) = torch.autograd.grad(total, coords, create_graph=True)
    return grads / torch.linalg.norm(grads, dim=-1, keepdim=True)
