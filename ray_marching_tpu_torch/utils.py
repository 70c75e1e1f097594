"""Select-semantics min/max/clamp (counterpart of ``ray_marching_tpu/utils.py``)
and two helpers every entry point of the port shares: :func:`resolve_device`
and :func:`not_ported`.

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


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port never
    moves to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def not_ported(what):
    """The error for an option of the JAX package the port does not run
    yet."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with a later slice of the "
        "PyTorch port (see ROADMAP.md)"
    )
