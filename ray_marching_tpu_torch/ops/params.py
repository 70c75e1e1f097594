"""The flat kernel parameter vector (counterpart of
``ray_marching_tpu/ops/pallas_march.py::split_params_padded``).

Every leaf of the parameter dict gets its own 128-aligned segment of one flat
vector, leaves in JAX's pytree flatten order (dict keys sorted at every
level), so the vector equals the JAX one element for element. The kernel
reads each parameter at its segment's offset; the code generator
(:mod:`ray_marching_tpu_torch.scene.codegen`) bakes those offsets into the
generated SDF, while the values stay a runtime pointer.
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


def split_params_padded(params, dtype, device="cpu"):
    """Params dict → ``(flat, specs)``: the 1-D aligned-segment vector (at
    least one segment long) and one :class:`LeafSpec` per leaf. ``device``
    places the vector only when the dict has no leaves; otherwise it lies
    where the leaves do.

    Matrix leaves (ndim ≥ 2, the neural slice's weights) are not supported
    yet and raise."""
    leaves = param_paths(params)
    specs, segs = [], []
    off = 0
    for path, leaf in leaves.items():
        if leaf.dim() >= 2:
            raise NotImplementedError(
                f"matrix parameter {path!r}: matrix leaves come with the "
                "neural slice of the port"
            )
        a = leaf.to(dtype).reshape(-1)
        size = a.shape[0]
        seg = max(1, -(-size // LANES)) * LANES
        specs.append(LeafSpec(path, off, size, tuple(leaf.shape)))
        segs.append(torch.nn.functional.pad(a, (0, seg - size)))
        off += seg
    if not segs:
        return torch.zeros((LANES,), dtype=dtype, device=device), ()
    return torch.cat(segs), tuple(specs)
