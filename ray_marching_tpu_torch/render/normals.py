"""Tetrahedral finite-difference constants (counterpart of
``ray_marching_tpu/render/normals.py::make_offsets``).

Four SDF samples at scaled tetrahedral offsets give the gradient through a
precomputed 3×3 inverse; the Laplacian is ``(f(p) − mean(f(p + εvᵢ)))·6/ε²``.
"""

from __future__ import annotations

import numpy as np

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
