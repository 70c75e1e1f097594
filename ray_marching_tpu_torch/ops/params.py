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
:func:`mat_specs` gives, which the generated SDF bakes in likewise. The
tensor-core entries (the serving forward and the march, f32) take the same
buffer followed by each tensor-core layer's weights in the fragment order of
``mma.sync`` (:func:`pack_tc`, :func:`tc_fragments`), prepared on the
device at every call.
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


def tf32(t):
    """float32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (10
    mantissa bits, to nearest, ties away from zero), the 13 bits below
    cleared: a float32 again. Finite values only."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tc_segment(nin: int, nout: int, bf16: bool) -> int:
    """Floats of one layer's fragments in :func:`pack_tc`'s buffer
    (128-aligned)."""
    return _segment(nin * nout // 2 if bf16 else 2 * nin * nout)


def tc_fragments(w, bf16=False):
    """W (nin, nout) of a tensor-core layer as ``neural.cuh``'s ``rm_mlp_tc``
    loads it, a 1-D float32 tensor (plain torch).

    Lane ``l`` (group ``g = l // 4``, ``t = l % 4``) of the warp reads, for
    k-step ``kt`` and n-tile ``nt``, entry ``(kt·(nout/8) + nt)·32 + l``:

    - f32 (3xTF32, m16n8k8): 4 floats, ``hi`` of ``W[kt·8 + t, nt·8 + g]``
      and of ``W[kt·8 + t + 4, nt·8 + g]``, then their ``lo``, with ``hi =
      tf32(W)`` and ``lo = tf32(W - hi)`` (``hi + lo`` is ``W`` to
      2^-22 of it: ``lo`` keeps 11 of the residual's 13 bits);
    - bf16 (m16n8k16): 2 registers of two bf16 each, the lower k in the low
      half: ``W[kt·16 + 2t + {0, 1}, nt·8 + g]``, then ``+ 8`` in k.
    """
    nin, nout = w.shape
    w = w.to(torch.float32)
    if bf16:
        # [kt, r, t, e, nt, g] -> [kt, nt, g, t, r, e]
        frag = w.reshape(nin // 16, 2, 4, 2, nout // 8, 8).permute(
            0, 4, 5, 2, 1, 3)
        return frag.to(torch.bfloat16).contiguous().view(
            torch.float32).reshape(-1)
    hi = tf32(w)
    lo = tf32(w - hi)
    # [part, kt, h, t, nt, g] -> [kt, nt, g, t, part, h]
    frag = torch.stack([hi, lo]).reshape(2, nin // 8, 2, 4, nout // 8, 8)
    return frag.permute(1, 4, 5, 3, 0, 2).contiguous().reshape(-1)


def tc_weights(frags, nin: int, nout: int, bf16=False):
    """:func:`tc_fragments` read back: ``(hi, lo)`` as (nin, nout) float32
    matrices, or for bf16 the rounded matrix."""
    if bf16:
        w = frags[:nin * nout // 2].contiguous().view(torch.bfloat16)
        return w.reshape(nin // 16, nout // 8, 8, 4, 2, 2).permute(
            0, 4, 3, 5, 1, 2).reshape(nin, nout).to(torch.float32)
    w = frags[:2 * nin * nout].reshape(nin // 8, nout // 8, 8, 4, 2, 2)
    hi, lo = w.permute(4, 0, 5, 3, 1, 2).reshape(2, nin, nout)
    return hi, lo


def pack_tc(packed, mats, layers):
    """The buffer the tensor-core entries take: ``packed`` (:func:`pack_mats`)
    followed by the fragments of each ``(matrix index, bf16)`` of
    ``layers`` (``SdfProgram.tc_mats``), each in a 128-aligned segment."""
    segs = [packed]
    for index, bf16 in layers:
        frag = tc_fragments(mats[index], bf16)
        nin, nout = mats[index].shape
        segs.append(torch.nn.functional.pad(
            frag, (0, tc_segment(nin, nout, bf16) - frag.numel())))
    return torch.cat(segs)
