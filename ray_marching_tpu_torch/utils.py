"""Select-semantics min/max/clamp (counterpart of ``ray_marching_tpu/utils.py``)
and :func:`resolve_device`, which every entry point of the port shares.

``clamp``, ``vmin`` and ``vmax`` are ``where`` selects, never
``torch.clamp``/``torch.minimum``: a select passes a NaN operand through
exactly as the JAX package does (``where(b < a, b, a)`` keeps ``a`` when
``b`` is NaN), and its backward routes the cotangent to the winner only:
``torch.where``'s backward is itself a select, so the losing branch gets
exact zeros even for a NaN cotangent (never ``NaN·0``).

``rmin``/``rmax`` are whole-tensor reductions whose backward is a select
too: ``where(x == m, g / n_ties, 0)``. Ties split evenly, and a NaN
cotangent stays on the tied elements instead of spreading over the tensor.
``prmin``/``prmax`` are their cross-shard forms over ``torch.distributed``
process groups: the same value on every rank, ties split across all ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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


class _CrossShardReduce(torch.autograd.Function):
    """Whole-tensor extremum over every rank of ``groups`` with the select
    backward split over all ranks' ties."""

    @staticmethod
    def forward(ctx, x, take_max, groups):
        m = torch.amax(x) if take_max else torch.amin(x)
        op = dist.ReduceOp.MAX if take_max else dist.ReduceOp.MIN
        for group in groups:
            dist.all_reduce(m, op=op, group=group)
        ctx.groups = groups
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        mask = x == m
        # One all-reduce carries the tie count and the cotangent: every rank
        # consumed the replicated extremum, so their cotangents sum.
        n_g = torch.stack([mask.sum(dtype=x.dtype), g.to(x.dtype)])
        for group in ctx.groups:
            dist.all_reduce(n_g, op=dist.ReduceOp.SUM, group=group)
        return (torch.where(mask, n_g[1] / n_g[0], torch.zeros_like(x)),
                None, None)


def prmin(x, axis_names):
    """Cross-shard whole-tensor min: the local min, then an all-reduce MIN
    over each process group of ``axis_names`` in turn (the counterpart of
    ``lax.pmin`` over mesh axes). Its backward is :func:`rmin`'s applied to
    the tensor of all ranks together: the cotangents of every rank summed,
    then split evenly over every arg-min element of every rank (the shaders'
    ``clamp(·, 1e-2)`` floor makes ties across ranks routine). Every rank
    must call it, and its backward, in the same order."""
    return _CrossShardReduce.apply(x, False, tuple(axis_names))


def prmax(x, axis_names):
    """Cross-shard whole-tensor max (see :func:`prmin`)."""
    return _CrossShardReduce.apply(x, True, tuple(axis_names))


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
