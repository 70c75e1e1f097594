"""Shader mode names and the cyclic colourmap (counterpart of
``ray_marching_tpu/render/shaders.py``).

The plane-form shaders themselves live in
:meth:`ray_marching_tpu_torch.render.fast.FastRenderer._shade`, as in the
JAX package. The colourmap is this package's own copy of the 4096-row
cyclic map (``data/cyclic_cmap.npy``), gathered exactly by
``floor → int → mod``.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

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


def angle_colouring(real, imag, cyclic_cmap, degree):
    """Hue from the complex argument: the colourmap row
    ``floor((atan2(im, re)/τ + 0.5)·degree·K) mod K``, as 3 channel planes."""
    k = cyclic_cmap.shape[0]
    idx = torch.floor(
        (torch.atan2(imag, real) / math.tau + 0.5) * degree * k
    ).to(torch.int32)
    idx = torch.remainder(idx, k)
    rows = cyclic_cmap[idx.long()]
    return [rows[..., c] for c in range(3)]


def domain_colouring(real, imag, cyclic_cmap, degree):
    """Angle colouring scaled by the modulus."""
    cols = angle_colouring(real, imag, cyclic_cmap, degree)
    brightness = torch.sqrt(real * real + imag * imag)
    return [brightness * c for c in cols]

