"""Sharded fast path: the fused kernels under a mesh of ranks (counterpart of
``ray_marching_tpu/parallel/fast_sharding.py``).

Each rank marches its row shard of the ``(rows, 128)`` coordinate planes of
a :class:`~ray_marching_tpu_torch.render.fast.FastRenderer` through the
fused forward kernel (the tensor-core entry for a scene with a tensor-core
MLP leaf), shades with the whole-image min/max normalizations reduced
across the ranks (``utils.prmin``/``prmax`` over the mesh's per-dimension
process groups), and differentiates through the backward kernel on its
shard; the parameter (and pose) gradients are then all-reduced, so the
parameters stay replicated.

Layout: the plane rows shard over all mesh axes jointly, row-major in the
mesh coordinate (the JAX package's ``PartitionSpec(mesh.axis_names)``).
Multi-camera batches stack cameras along the rows; the rank count must be a
multiple of the camera count, so each shard belongs to one camera, whose
pose row it takes by its index. Each rank's shard holds whole
``SHARD_ROWS``-row groups: construct the renderer with
``row_multiple=SHARD_ROWS * shards per camera`` (:func:`_check_rows` says
so when it does not).
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_marching_tpu_torch.parallel.sharding import (
    _check_world,
    all_gather,
    mesh_groups,
    optimizer_step,
    shard_index,
)

# Rows per shard group: whole blocks of every kernel launch (render/fast.py
# FastRenderer, ``row_multiple``), and the JAX package's sublane multiple,
# so the planes compare one to one with its sharded renderer's.
SHARD_ROWS = 8


def _check_rows(fast, mesh):
    nd = mesh.size()
    if nd % fast.num_cameras:
        raise ValueError(
            f"{fast.num_cameras} cameras over {nd} ranks: the rank count "
            "must be a multiple of the camera count (each row shard belongs "
            "to exactly one camera)")
    per_cam = nd // fast.num_cameras
    if fast.rows_per_cam % (SHARD_ROWS * per_cam):
        raise ValueError(
            f"rows_per_cam={fast.rows_per_cam} not divisible by "
            f"{SHARD_ROWS}×{per_cam} shards per camera; construct "
            f"FastRenderer(..., row_multiple={SHARD_ROWS * per_cam})")


def shard_rows(fast, mesh):
    """``(camera, rows)``: the camera this rank's shard belongs to and the
    slice of the renderer's plane rows that it holds."""
    _check_rows(fast, mesh)
    per_cam = mesh.size() // fast.num_cameras
    n = fast.rows_per_cam // per_cam
    idx = shard_index(mesh)
    return idx // per_cam, slice(idx * n, (idx + 1) * n)


def make_channel_fn(fast, mesh, *, mode: int = 0, degree: int = 1,
                    marching_steps: Optional[int] = None,
                    with_alpha: bool = False, beta: Optional[float] = None):
    """``channels(params, orientation, translation) -> (C, rows / n, 128)``:
    this rank's row shard of the RGB planes (``shard_map``'s local view; a
    4th plane, the soft silhouette coverage, with ``with_alpha``).
    Differentiable; the gradients it gives are this rank's share, which the
    caller sums across the ranks (:func:`sharding.allreduce_sum`). Every rank
    must call it, and its backward, in the same order."""
    from ray_marching_tpu_torch.render.fast import pose_plane_group
    from ray_marching_tpu_torch.render.silhouette import soft_coverage

    _check_world(mesh)
    cam, rows = shard_rows(fast, mesh)
    groups = mesh_groups(mesh)
    steps = marching_steps or fast.config.marching_steps
    beta = fast.config.silhouette_beta if beta is None else beta
    # The baked planes are one camera's: the shard's rows within its camera.
    local = slice(rows.start - cam * fast.rows_per_cam,
                  rows.stop - cam * fast.rows_per_cam)
    pos0 = tuple(p[local] for p in fast._pos0)
    dir0 = tuple(p[local] for p in fast._dir0)
    valid = fast._valid[rows]

    def channels(params, orientation, translation):
        orientation, translation = fast._pose(orientation, translation)
        q = orientation[cam:cam + 1]
        origin, dirs = pose_plane_group(q, translation[cam:cam + 1], pos0,
                                        dir0)
        out = fast._march_planes(params, origin, dirs, steps, valid=valid,
                                 with_closest=with_alpha)
        hit, final_dirs = out[0], out[1]
        planes = fast._shade(mode, degree, q, origin, final_dirs, hit,
                             valid_b=valid > 0.5, axis_names=groups,
                             cameras=1, params=params)
        if with_alpha:
            planes = list(planes) + [soft_coverage(out[2], beta)]
        return torch.stack(planes, dim=0)

    channels.valid = valid
    channels.rows = rows
    return channels


def gather_planes(mesh, local):
    """Every rank's ``(C, rows / n, 128)`` shard → the ``(C, rows, 128)``
    planes, on every rank."""
    parts = all_gather(local)
    order = [int(r) for r in mesh.mesh.reshape(-1)]
    return torch.cat([parts[r] for r in order], dim=1)


def fast_shard_render(fast, mesh, *, mode: int = 0, degree: int = 1,
                      marching_steps: Optional[int] = None):
    """``render(params, orientation, translation) -> (N, H, W, 3)``: the
    sharded frame, whole on every rank."""
    chan_fn = make_channel_fn(fast, mesh, mode=mode, degree=degree,
                              marching_steps=marching_steps)

    def render(params, orientation, translation):
        ch = gather_planes(mesh, chan_fn(params, orientation, translation))
        return fast._assemble([ch[0], ch[1], ch[2]])

    return render


def fast_shard_render_with_alpha(fast, mesh, *, mode: int = 0,
                                 degree: int = 1,
                                 marching_steps: Optional[int] = None,
                                 beta: Optional[float] = None):
    """``render(params, orientation, translation) -> (image (N, H, W, 3),
    alpha (N, H, W, 1))``, whole on every rank."""
    chan_fn = make_channel_fn(fast, mesh, mode=mode, degree=degree,
                              marching_steps=marching_steps, with_alpha=True,
                              beta=beta)

    def render(params, orientation, translation):
        ch = gather_planes(mesh, chan_fn(params, orientation, translation))
        return fast._assemble([ch[0], ch[1], ch[2]]), fast._assemble([ch[3]])

    return render


def target_planes(fast, mesh, target):
    """This rank's row shard ``(C, rows / n, 128)`` of an (N, H, W, C)
    target image laid out as channel planes."""
    _, rows = shard_rows(fast, mesh)
    return fast.image_to_planes(fast._tensor(target))[:, rows]


def _check_target(name, planes, chan_fn):
    want = (chan_fn.rows.stop - chan_fn.rows.start, 128)
    if tuple(planes.shape[1:]) != want:
        raise ValueError(f"{name} must be this rank's row shard (C, *{want}) "
                         f"(target_planes), got {tuple(planes.shape)}")


def fast_train_step(fast, mesh, optimizer, *, mode: int = 0,
                    degree: int = 1, marching_steps: Optional[int] = None):
    """``step(params, opt_state, target_planes, orientation, translation) ->
    (params, opt_state, loss)`` on the fused kernels, rows sharded over
    ``mesh``.

    The loss is the image's mean squared error computed in plane space over
    the valid slots: each rank's share over its shard (``target_planes``
    gives it) divided by the image's element count, summed across the
    ranks. ``optimizer`` is a ``torch.optim`` constructor; ``opt_state``
    None at the first step, then what the last step returned. The gradients
    are all-reduced before the update, so the parameters stay replicated
    bit for bit."""
    chan_fn = make_channel_fn(fast, mesh, mode=mode, degree=degree,
                              marching_steps=marching_steps)
    groups = mesh_groups(mesh)
    n_elems = fast.num_cameras * fast.total * 3
    valid = chan_fn.valid

    def step(params, opt_state, target, orientation, translation):
        _check_target("target", target, chan_fn)

        def local_loss(work):
            err = (chan_fn(work, orientation, translation) - target) \
                * valid[None]
            return torch.sum(err * err) / n_elems

        return optimizer_step(optimizer, params, opt_state, local_loss,
                              groups)

    return step


def fast_train_step_silhouette(fast, mesh, optimizer, *, mode: int = 0,
                               degree: int = 1,
                               marching_steps: Optional[int] = None,
                               beta: Optional[float] = None,
                               silhouette_weight: float = 1.0,
                               background: float = 0.0):
    """``step(params, opt_state, target_planes, target_alpha_planes,
    orientation, translation) -> (params, opt_state, loss)``: the objective
    of ``optim.inverse.optimize`` with ``silhouette_beta`` set, sharded: the
    mean squared error of the α-composited image against a composited
    target plus ``silhouette_weight`` times that of the coverage, both over
    the image's valid slots in plane space. Coverage is per ray, so the
    sharding adds no collective beyond the gradient sum."""
    chan_fn = make_channel_fn(fast, mesh, mode=mode, degree=degree,
                              marching_steps=marching_steps, with_alpha=True,
                              beta=beta)
    groups = mesh_groups(mesh)
    n_px = fast.num_cameras * fast.total
    valid = chan_fn.valid

    def step(params, opt_state, target, target_alpha, orientation,
             translation):
        _check_target("target", target, chan_fn)
        _check_target("target_alpha", target_alpha, chan_fn)

        def local_loss(work):
            ch = chan_fn(work, orientation, translation)
            rgb, alpha = ch[:3], ch[3]
            comp = alpha[None] * rgb + (1.0 - alpha)[None] * background
            err = (comp - target) * valid[None]
            aerr = (alpha - target_alpha[0]) * valid
            return (torch.sum(err * err) / (n_px * 3)
                    + silhouette_weight * torch.sum(aerr * aerr) / n_px)

        return optimizer_step(optimizer, params, opt_state, local_loss,
                              groups)

    return step
