"""Select-semantics min/max/clamp (counterpart of ``ray_marching_tpu/utils.py``).

``clamp``, ``vmin`` and ``vmax`` are ``where`` selects, never
``torch.clamp``/``torch.minimum``: a select passes a NaN operand through
exactly as the JAX package does (``where(b < a, b, a)`` keeps ``a`` when
``b`` is NaN), and its backward routes the cotangent to the winner only:
``torch.where``'s backward is itself a select, so the losing branch gets
exact zeros even for a NaN cotangent (never ``NaN·0``).

``rmin``/``rmax`` are whole-tensor reductions whose backward is a select
too: ``where(x == m, g / n_ties, 0)``. Ties split evenly, and a NaN
cotangent stays on the tied elements instead of spreading over the tensor.
The cross-shard forms (``prmin``/``prmax``) come with the parallel slice.
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


class _SelectReduce(torch.autograd.Function):
    """Whole-tensor extremum with the select backward."""

    @staticmethod
    def forward(ctx, x, take_max):
        m = torch.amax(x) if take_max else torch.amin(x)
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        mask = x == m
        return torch.where(mask, g / mask.sum(), torch.zeros_like(x)), None


def rmin(x):
    """Whole-tensor min; the cotangent goes to the arg-min elements only,
    split evenly over ties."""
    return _SelectReduce.apply(x, False)


def rmax(x):
    """Whole-tensor max (see :func:`rmin`)."""
    return _SelectReduce.apply(x, True)
