"""Select-semantics min/max/clamp (counterpart of ``ray_marching_tpu/utils.py``).

``clamp``, ``vmin`` and ``vmax`` are ``where`` selects, never
``torch.clamp``/``torch.minimum``: a select passes a NaN operand through
exactly as the JAX package does (``where(b < a, b, a)`` keeps ``a`` when
``b`` is NaN), and it is the form whose backward routes the cotangent to the
winner only. ``rmin``/``rmax`` are forward-only whole-tensor reductions here;
their select backward comes with the training slice.
"""

from __future__ import annotations

import torch


def clamp(x, lo=None, hi=None):
    """``where(x < lo, lo, x)`` then ``where(x > hi, hi, x)``."""
    if lo is not None:
        x = torch.where(x < lo, lo, x)
    if hi is not None:
        x = torch.where(x > hi, hi, x)
    return x


def vmin(a, b):
    """Elementwise min as a select: ties and NaN in ``b`` keep ``a``."""
    return torch.where(b < a, b, a)


def vmax(a, b):
    """Elementwise max as a select (see :func:`vmin`)."""
    return torch.where(b > a, b, a)


def rmin(x):
    """Whole-tensor min (forward only)."""
    return torch.amin(x)


def rmax(x):
    """Whole-tensor max (forward only)."""
    return torch.amax(x)
