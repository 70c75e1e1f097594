"""The kernels' parameter inputs (counterpart of
``ray_marching_tpu/ops/pallas_march.py::split_params_padded``).

Every leaf of the parameter dict with fewer than two dimensions gets its own
128-aligned segment of one flat vector, leaves in JAX's pytree flatten order
(dict keys sorted at every level), so the vector equals the JAX one element
for element. Matrix leaves (ndim ≥ 2, the weights of a ``NeuralSDF``) stay
out of it and come back as a tuple in the same order, as the JAX package
hands them to its kernels as inputs of their own. The code generator
(:mod:`ray_marching_tpu_torch.scene.codegen`) bakes the flat offsets into
the generated SDF, while the values stay a runtime pointer.

The CUDA kernels take the matrices as one packed buffer (:func:`pack_mats`):
each matrix row-major in its own 128-aligned segment, at the offsets
:func:`mat_specs` gives, which the generated SDF bakes in likewise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ray_marching_tpu_torch.scene.graph import param_paths

LANES = 128


class LeafSpec(NamedTuple):
    path: str
    offset: int
    size: int
    shape: Tuple[int, ...]


def _segment(size: int) -> int:
    return max(1, -(-size // LANES)) * LANES


def split_params_padded(params, dtype, device="cpu"):
    """Params dict → ``(flat, mats, specs)``: the 1-D aligned-segment vector
    of the leaves with ndim < 2 (at least one segment long), the tuple of
    matrix leaves cast to ``dtype`` (pytree order) and one :class:`LeafSpec`
    per flat leaf. ``device`` places the vector only when the dict has no
    flat leaves; otherwise it lies where the leaves do."""
    specs, segs, mats = [], [], []
    off = 0
    for path, leaf in param_paths(params).items():
        if leaf.dim() >= 2:
            mats.append(leaf.to(dtype))
            continue
        a = leaf.to(dtype).reshape(-1)
        size = a.shape[0]
        specs.append(LeafSpec(path, off, size, tuple(leaf.shape)))
        segs.append(torch.nn.functional.pad(a, (0, _segment(size) - size)))
        off += _segment(size)
    if not segs:
        flat = torch.zeros((LANES,), dtype=dtype, device=device)
    else:
        flat = torch.cat(segs)
    return flat, tuple(mats), tuple(specs)


def mat_specs(params):
    """One :class:`LeafSpec` per matrix leaf of ``params``, pytree order; the
    offsets are those of the packed buffer of :func:`pack_mats`."""
    specs, off = [], 0
    for path, leaf in param_paths(params).items():
        if leaf.dim() >= 2:
            size = leaf.numel()
            specs.append(LeafSpec(path, off, size, tuple(leaf.shape)))
            off += _segment(size)
    return tuple(specs)


def packed_size(specs) -> int:
    """Length of :func:`pack_mats`'s buffer for the :func:`mat_specs`
    ``specs``."""
    return sum(_segment(s.size) for s in specs)


def pack_mats(mats):
    """The matrices as the kernels take them: one 1-D buffer, each matrix
    row-major in its own 128-aligned segment (differentiable). ``None`` when
    there are none."""
    if not mats:
        return None
    return torch.cat([
        torch.nn.functional.pad(m.reshape(-1), (0, _segment(m.numel())
                                                - m.numel()))
        for m in mats])
