"""Sphere-trace march + terminal distance: the CUDA kernel's wrappers and its
plain PyTorch version.

Counterpart of ``ray_marching_tpu/ops/pallas_march.py`` (``_march_kernel``;
``pallas_march`` and ``pallas_march_with_distance`` there). The kernel source
is ``csrc/march.cu``; it lives in the same per-scene library as the fused
kernels (:mod:`ray_marching_tpu_torch.ops.render_kernel` builds and binds
it) and runs the march loop they run (``csrc/march_loop.cuh``).

:func:`kernel_march` and :func:`kernel_march_with_distance` take ``(..., 3)``
positions and directions of any leading shape, lay them out as 7 planes
``(rows, 128)`` (``px py pz dx dy dz valid``), padded to whole rows only, and
call :func:`march_planes`, which is differentiable in the flat parameters
and the ray planes: its backward is the march-only instantiation of the
backward kernel (:func:`backward_kernel.march_backward`). The wrappers take
the plain versions only for tensors on the CPU. For CUDA tensors they launch
the kernels or raise; they never fall back. A scene with ``NeuralSDF``
leaves passes its matrix parameters as ``mats``; the MLP runs inside the
kernel and its VJP inside the backward kernel, which returns the matrices'
cotangents too. A march without a gradient on a scene with a tensor-core
leaf in f32 launches the tensor-core entry (``march_tc_kernel``); a
differentiated one the per-thread entry, whose positions the backward
marches again.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.ops.params import split_params_padded
from ray_marching_tpu_torch.scene.codegen import SdfProgram

LANES = rk.LANES

#: March-kernel launches so far (the wrapper adds one per launch, nowhere
#: else; its backward counts its own in backward_kernel.MARCH_LAUNCHES).
LAUNCHES = 0
#: Those of them that launched the tensor-core entry (march_tc_kernel).
TC_LAUNCHES = 0


def march_forward(program: SdfProgram, params_flat, rays7, steps, tau,
                  mats=(), route=None, tc_mats=None):
    """One march, not differentiable: rays7 (7, rows, 128) → (4, rows, 128),
    the marched x y z and the terminal distance (0 on pad slots), on the MLP
    ``route`` (by default the serving one, :func:`render_kernel.mlp_route`),
    which ``tc_mats`` may hand a prepared buffer
    (:func:`render_kernel.tc_buffer`). CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    global LAUNCHES, TC_LAUNCHES
    rk._check(program, params_flat, rays7, steps, mats)
    if route is None:
        route = rk.mlp_route(program, rays7.dtype)
    rk._check_route(program, rays7, route, tc_mats)
    if rays7.device.type == "cpu":
        return reference_march(program, params_flat, rays7, steps, tau, mats)
    if rays7.device.type != "cuda":
        raise ValueError(f"unsupported device {rays7.device}")
    if not (rays7.is_contiguous() and params_flat.is_contiguous()):
        raise ValueError("rays7 and params_flat must be contiguous")
    if route == "tc":
        lib_fn = "rm_march_tc_f32"
        packed = rk.tc_buffer(program, mats) if tc_mats is None else tc_mats
    else:
        lib_fn = ("rm_march_f32" if rays7.dtype == torch.float32
                  else "rm_march_f64")
        packed = rk._packed(mats)
    fn = getattr(rk._load(program), lib_fn)
    out = torch.empty((4,) + tuple(rays7.shape[1:]), dtype=rays7.dtype,
                      device=rays7.device)
    with torch.cuda.device(rays7.device):
        stream = torch.cuda.current_stream(rays7.device).cuda_stream
        LAUNCHES += 1
        if route == "tc":
            TC_LAUNCHES += 1
        err = fn(params_flat.data_ptr(), rk._ptr(packed), rays7.data_ptr(),
                 out.data_ptr(), rays7.shape[1] * LANES, int(steps),
                 float(tau), stream)
    if err != 0:
        raise RuntimeError(f"march kernel launch failed: cudaError {err}")
    return out


class _March(torch.autograd.Function):
    """Forward: the march kernel; backward: the backward kernel without its
    normals tail (counterpart of the ``custom_vjp`` pair ``_core_fwd`` /
    ``_core_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, params_flat, rays7, program, steps, tau, *mats):
        ctx.cfg = (program, steps, tau)
        ctx.save_for_backward(params_flat, rays7, *mats)
        return march_forward(program, params_flat, rays7, steps, tau, mats,
                             route="thread")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from ray_marching_tpu_torch.ops.backward_kernel import march_backward

        program, steps, tau = ctx.cfg
        params_flat, rays7, *mats = ctx.saved_tensors
        gflat, gmats, grays = march_backward(program, params_flat, rays7,
                                             g.contiguous(), steps, tau, mats)
        return (gflat, grays, None, None, None, *gmats)


def march_planes(program: SdfProgram, params_flat, rays7, steps, tau=0.0,
                 mats=()):
    """rays7 (7, rows, 128) → (4, rows, 128): x y z d, the first four planes
    of :func:`render_kernel.fused_march_normals` bit for bit (under a
    gradient: of its training configuration, the per-thread route of both).
    Differentiable in ``params_flat``, ``rays7`` and ``mats``."""
    if rk._requires_grad(params_flat, rays7, *mats):
        return _March.apply(params_flat, rays7, program, steps, tau, *mats)
    return march_forward(program, params_flat, rays7, steps, tau, mats)


def rays_to_planes(ray_positions, ray_directions):
    """``(..., 3)`` positions and directions → rays7 (7, rows, 128). The pad
    slots of the last row repeat the last real ray (a zero ray would sit at
    the world origin, a gradient singularity of many scenes, and a backward
    that evaluates pad slots would then poison the shared parameter
    cotangent); the validity plane marks them 0."""
    total = ray_positions[..., 0].numel()
    rows = max(1, -(-total // LANES))
    pad = rows * LANES - total

    def plane(a, idx):
        flat = a[..., idx].reshape(-1)
        if pad:
            flat = torch.cat([flat, flat[-1:].expand(pad)])
        return flat.reshape(rows, LANES)

    valid = torch.zeros(rows * LANES, dtype=ray_positions.dtype,
                        device=ray_positions.device)
    valid[:total] = 1.0
    return torch.stack(
        [plane(ray_positions, i) for i in range(3)]
        + [plane(ray_directions, i) for i in range(3)]
        + [valid.reshape(rows, LANES)], dim=0)


def kernel_march_with_distance(program: SdfProgram, params, ray_positions,
                               ray_directions, steps, tau=0.0):
    """March ``(..., 3)`` rays of any leading shape through the scene:
    ``(marched positions (..., 3), terminal distance (..., 1))``, the
    distance computed inside the kernel. ``params`` is the scene's parameter
    dict; differentiable in its leaves and in the rays."""
    if (ray_positions.shape != ray_directions.shape
            or ray_positions.shape[-1] != 3):
        raise ValueError(f"rays must be two (..., 3) tensors, got "
                         f"{tuple(ray_positions.shape)} and "
                         f"{tuple(ray_directions.shape)}")
    shape = ray_positions.shape[:-1]
    total = ray_positions[..., 0].numel()
    flat, mats, _ = split_params_padded(params, ray_positions.dtype,
                                        ray_positions.device)
    out = march_planes(program, flat,
                       rays_to_planes(ray_positions, ray_directions), steps,
                       tau, mats)
    x, y, z, d = (out[i].reshape(-1)[:total] for i in range(4))
    return (torch.stack([x, y, z], dim=-1).reshape(shape + (3,)),
            d.reshape(shape + (1,)))


def kernel_march(program: SdfProgram, params, ray_positions, ray_directions,
                 steps, tau=0.0):
    """:func:`kernel_march_with_distance` without the distance."""
    return kernel_march_with_distance(program, params, ray_positions,
                                      ray_directions, steps, tau)[0]


def reference_march(program: SdfProgram, params_flat, rays7, steps, tau,
                    mats=()):
    """The plain PyTorch version of :func:`march_forward`: the kernel's op
    sequence on planes, with the semantics of ``_march_kernel`` (pad slots
    never move and get distance 0; with tau > 0 a ray moves only while
    ``|d| >= tau``)."""
    sdf = program.sdf_c
    params = program.rebuild(params_flat, mats)
    x, y, z, dx, dy, dz = (rays7[i] for i in range(6))
    valid = rays7[6] > 0.5
    tau_t = float(np.asarray(tau, rk._np_dtype(rays7.dtype)))
    for _ in range(int(steps)):
        d = sdf(params, x, y, z)
        live = valid if tau_t == 0.0 else (torch.abs(d) >= tau_t) & valid
        x = torch.where(live, x + d * dx, x)
        y = torch.where(live, y + d * dy, y)
        z = torch.where(live, z + d * dz, z)
    dist = torch.where(valid, sdf(params, x, y, z), 0.0)
    return torch.stack([x, y, z, dist], dim=0)


def march_ops(program: SdfProgram, n_valid: int, steps: int) -> int:
    """Operations the kernel needs for ``n_valid`` rays that march ``steps``
    steps at tau = 0: steps + 1 SDF evaluations and the march arithmetic, by
    the op-count convention of scene/codegen.py."""
    return n_valid * ((steps + 1) * program.ops_per_eval
                      + steps * rk.OPS_PER_STEP)
