"""Meshes of ranks and the sharded modular render and train steps
(counterpart of ``ray_marching_tpu/parallel/sharding.py``).

The JAX package runs one process over many devices and lets XLA insert the
collectives. Here one process drives one device (a rank of a
``torch.distributed`` process group), and the collectives are explicit:

* a mesh is a ``DeviceMesh`` whose dimension names are the JAX axis names
  (``dp`` cameras, ``rows`` and ``cols`` image rows and columns; on several
  nodes ``host`` outermost, :func:`multihost.make_global_mesh`);
* a rank's shard is the block of rays that its mesh coordinate selects
  (:func:`ray_partition_spec`);
* the shaders' whole-image min/max run as ``utils.prmin``/``prmax`` over the
  mesh's per-dimension process groups (``axis_names``, reduced in turn);
* replicated parameters have their gradients summed by an all-reduce after
  ``backward()`` (:func:`allreduce_sum`), the counterpart of XLA's reduction
  of replicated cotangents, so every rank applies the same update.

Every rank must call the sharded functions in the same order: each one
issues its collectives unconditionally, whatever its shard holds.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

RAY_AXES = ("dp", "rows", "cols")


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("rows", "cols"),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the process group.

    With no ``shape`` every rank goes on the first axis and the others have
    size 1, as in the JAX package. Without a process group a mesh of one
    rank gets a one-rank group of its own (NCCL on the card, gloo on the
    CPU), so one process can call the sharded API; more ranks need the
    group first (:func:`ray_marching_tpu_torch.parallel.multihost.
    initialize`, or ``torchrun``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ray_marching_tpu_torch.utils import resolve_device

    resolve_device(device_type)
    axis_names = tuple(axis_names)
    if not dist.is_initialized():
        if shape is not None and math.prod(shape) != 1:
            raise RuntimeError(
                f"a mesh of shape {tuple(shape)} needs a process group of "
                f"{math.prod(shape)} ranks: call parallel.multihost."
                "initialize() in every rank first (or launch with torchrun)")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), world_size=1, rank=0)
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=axis_names)


def mesh_groups(mesh, names: Optional[Sequence[str]] = None) -> tuple:
    """The per-dimension process groups of ``mesh`` (of the dimensions
    ``names``, by default all): the ``axis_names`` value of the port."""
    names = mesh.mesh_dim_names if names is None else names
    return tuple(mesh.get_group(name) for name in names)


def shard_index(mesh, coordinate=None) -> int:
    """The rank's shard: its mesh coordinate taken row-major over the axes
    (``coordinate`` defaults to this rank's)."""
    coordinate = mesh.get_coordinate() if coordinate is None else coordinate
    idx = 0
    for d, c in enumerate(coordinate):
        idx = idx * mesh.size(d) + c
    return idx


def _coordinates(mesh):
    """``{rank: coordinate}`` of every rank of the mesh."""
    return {int(rank): c for c, rank in np.ndenumerate(mesh.mesh.numpy())}


def _check_world(mesh):
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh has {mesh.size()} ranks, the process "
                         f"group {dist.get_world_size()}: the sharded paths "
                         "take a mesh over every rank")


def allreduce_sum(tensors, groups):
    """Sum ``tensors`` in place over the process groups in turn (one
    all-reduce per group on one flat buffer) and return them. Every rank
    gets the same sums, so parameters updated from them stay equal bit for
    bit across the ranks."""
    tensors = list(tensors)
    if not tensors or not groups:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for group in groups:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def all_gather(t):
    """``t`` of every rank of the world, in rank order. Over gloo a CUDA
    tensor goes through host memory, because gloo gathers CPU tensors
    only (two ranks on one card cannot use NCCL)."""
    via_host = t.is_cuda and dist.get_backend() == "gloo"
    src = t.detach().cpu() if via_host else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out] if via_host else out


def _block(mesh, coordinate, shape):
    names = mesh.mesh_dim_names
    out = []
    for axis, size in zip(RAY_AXES, shape[:3]):
        if axis not in names:
            out.append(slice(0, size))
            continue
        d = names.index(axis)
        k = mesh.size(d)
        if size % k:
            raise ValueError(f"the {axis!r} axis of {k} ranks does not "
                             f"divide the ray grid's {size}")
        b = size // k
        out.append(slice(coordinate[d] * b, (coordinate[d] + 1) * b))
    return tuple(out)


def ray_partition_spec(mesh, shape):
    """The rank's ``(camera, row, col)`` block of an ``(N, H, W, 3)`` ray
    grid of ``shape``, as three slices: cameras over ``dp``, rows over
    ``rows``, columns over ``cols`` (each the whole extent when the mesh has
    no such axis; ranks along other axes hold the same block)."""
    return _block(mesh, mesh.get_coordinate(), shape)


def ray_groups(mesh) -> tuple:
    """The process groups of the mesh's ray axes (``dp``/``rows``/``cols``):
    the shaders' reductions and the gradient sums run over these."""
    return mesh_groups(mesh, [a for a in RAY_AXES
                              if a in mesh.mesh_dim_names])


def _block_renderer(renderer, mesh, mode, degree, marching_steps):
    """``f(params, q, t) -> (block image, block slices)``: the rank's block
    posed and rendered through ``render_from_rays``."""
    from ray_marching_tpu_torch import quat

    _check_world(mesh)
    groups = ray_groups(mesh)
    cam = renderer.camera

    def render_block(params, orientation, translation):
        orientation = renderer._tensor(orientation)
        translation = renderer._tensor(translation)
        block = ray_partition_spec(mesh, tuple(cam.ray_positions.shape))
        q = orientation[block[0]]
        t = translation[block[0]]
        qb = q[:, None, None, :]
        world_pos = (quat.rotation(cam.ray_positions[block], qb)
                     + t[:, None, None, :])
        world_dir = quat.rotation(cam.ray_directions[block], qb)
        image = renderer.render_from_rays(
            params, q, world_pos, quat.to_so3(q), world_pos, world_dir,
            mode=mode, degree=degree, marching_steps=marching_steps,
            axis_names=groups)
        return image, block

    return render_block


def shard_render(renderer, mesh, *, mode: int = 0, degree: int = 1,
                 marching_steps: Optional[int] = None):
    """``f(params, orientation, translation) -> (N, H, W, 3)`` on the modular
    :class:`~ray_marching_tpu_torch.render.pipeline.Renderer` with the rays
    sharded over ``mesh``: each rank poses and renders its block, the
    shaders' normalizations reduce across the ranks, and the blocks are
    gathered, so every rank returns the whole frame (JAX's global
    array)."""
    render_block = _block_renderer(renderer, mesh, mode, degree,
                                   marching_steps)
    coords = _coordinates(mesh)

    def render(params, orientation, translation):
        image, _ = render_block(params, orientation, translation)
        shape = tuple(renderer.camera.ray_positions.shape)
        out = torch.empty(shape, dtype=image.dtype, device=image.device)
        for rank, part in enumerate(all_gather(image)):
            out[_block(mesh, coords[rank], shape)] = part
        return out

    return render


def optimizer_step(optimizer, params, opt_state, local_loss, groups):
    """One replicated update: ``local_loss(work_params)`` is this rank's
    share of the loss; its gradients and the loss are summed over
    ``groups``, then ``optimizer`` (a ``torch.optim`` constructor) steps
    from ``opt_state`` (None for a fresh one; ``{leaf path: {key:
    tensor}}`` as ``optim.inverse._opt_state_tree`` writes it, copied, never
    changed in place). Returns ``(params, opt_state, loss)``."""
    from ray_marching_tpu_torch.optim.inverse import _opt_state_tree
    from ray_marching_tpu_torch.scene.graph import map_params, param_paths

    work = map_params(params,
                      lambda v: v.detach().clone().requires_grad_(True))
    named = param_paths(work)
    opt = optimizer(list(named.values()))
    for name, state in (opt_state or {}).items():
        opt.state[named[name]] = {k: v.clone() for k, v in state.items()}
    loss = local_loss(work)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    for leaf, g in zip(named.values(), grads):
        leaf.grad = torch.zeros_like(leaf) if g is None else g
    loss = loss.detach().clone()
    allreduce_sum([loss] + [leaf.grad for leaf in named.values()], groups)
    opt.step()
    return (map_params(work, torch.Tensor.detach),
            _opt_state_tree(opt, named), loss)


def make_train_step(renderer, mesh, optimizer, *, mode: int = 0,
                    degree: int = 1, marching_steps: Optional[int] = None):
    """``step(params, opt_state, target, orientation, translation) ->
    (params, opt_state, loss)`` on the modular renderer, rays sharded over
    ``mesh``.

    The loss is the whole image's mean squared error: each rank's squared
    error over its block of ``target`` (the whole (N, H, W, 3) image)
    divided by the image's element count, summed across the ranks.
    ``optimizer`` is a ``torch.optim`` constructor (e.g.
    ``functools.partial(torch.optim.Adam, lr=1e-2)``); ``opt_state`` is
    None at the first step, then what the last step returned. The
    gradients are all-reduced before the update, so the parameters stay
    replicated bit for bit."""
    render_block = _block_renderer(renderer, mesh, mode, degree,
                                   marching_steps)
    groups = ray_groups(mesh)

    def step(params, opt_state, target, orientation, translation):
        target = renderer._tensor(target)
        n_elems = target.numel()

        def local_loss(work):
            image, block = render_block(work, orientation, translation)
            return torch.sum((image - target[block]) ** 2) / n_elems

        return optimizer_step(optimizer, params, opt_state, local_loss,
                              groups)

    return step
