"""Backward of the fused march + normals kernel and of the march kernel:
the CUDA kernel's wrappers and its plain PyTorch version.

Counterpart of ``ray_marching_tpu/ops/pallas_backward.py::fused_backward``
(``_bwd_kernel`` and, with ``two_level``, ``_bwd_kernel_2l``). The kernel
source is ``csrc/render_bwd.cu``; it lives in the same per-scene library as
the forward kernel (:mod:`ray_marching_tpu_torch.ops.render_kernel` builds
and binds it) and calls the generated ``scene_sdf_vjp`` of
:mod:`ray_marching_tpu_torch.scene.codegen`. :func:`march_backward` launches
its march-only instantiation, the backward of ``csrc/march.cu`` (the JAX
package differentiates ``pallas_march`` through a checkpointed scan instead,
``pallas_march.py::_core_bwd``).

Both wrappers take the plain version only for tensors on the CPU. For CUDA
tensors they launch the kernel or raise; they never fall back. A scene with
``NeuralSDF`` leaves hands its matrices in as ``mats`` and gets their
cotangents back: the kernel's block-synchronous variant sums ``a ⊗ δ`` per
block into rows of partials (one row per block, the scalars then the packed
matrices, allocated per launch), which the wrapper sums over the blocks in
their order.

Scratch: where the kernel marches again (the recompute, the two levels, the
march-only mode) it keeps the positions per block, not per frame, as the
TPU kernel keeps them per tile in VMEM. The launch then runs one block per
block the card holds at once (:func:`scratch_slots`, from the kernel's
occupancy), each walking the ray blocks ``b, b + grid, ...`` in a scratch
slot of its own (:func:`scratch_shape`): on an H100, 660 slots of 50,688 B
(33.5 MB) for test_scene2 at 32 steps in f32, where a 1080p frame's
history is 821 MB.
Each ray block's row of partials is the same whichever block ran it, so
the gradients keep their bits.

Both take the MLP ``route`` of the forward they differentiate (by default
:func:`render_kernel.mlp_route`): ``"tc"`` launches the kernel's tensor-core
instantiation (``render_bwd.cu`` with ``TC``: its marches warp-masked on the
tensor-core MLP, so they give the tensor-core forward's positions bit for
bit, and the MLP's VJP and matrix sink on ``mma.sync``), with the backward
kernel's tensor-core buffer (:func:`render_kernel.tc_buffer` with
``backward``) prepared per launch.

The plain version (:func:`reference_backward`) is the kernel's own algorithm
written with tensors: one VJP of the tail, then the reverse sweep over the
steps from the history, one ``torch.autograd.grad`` of the step per step,
with the kernel's freeze and ``min_f`` tie rules. It is not whole-graph
autograd over the unrolled march: that would route cotangents through
diverged rays differently (NaN where this stays finite) and keep every
step's intermediates alive.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from ray_marching_tpu_torch.ops import render_kernel as rk
from ray_marching_tpu_torch.scene.codegen import SdfProgram

LANES = rk.LANES

#: Launches of the backward kernel by :func:`fused_backward` so far (the
#: wrapper adds one per launch, nowhere else), and of its march-only
#: instantiation by :func:`march_backward`; those of them on the tensor-core
#: instantiation.
LAUNCHES = 0
MARCH_LAUNCHES = 0
TC_LAUNCHES = 0
MARCH_TC_LAUNCHES = 0
#: Launches by :func:`fused_backward` that ran the union short-circuit: a
#: pruned program's kernel (``SdfProgram.pruned``) on the recompute or the
#: two-level path, whose marches skip guarded union children (render_kernel's
#: module doc). The history path marches nothing and is not counted.
PRUNE_LAUNCHES = 0
#: The two-level backward keeps every ``CKPT_INTERVAL``-th march position and
#: marches each segment again when the sweep reaches it (defined once, in
#: ``render_kernel``, which also hands it to the kernel's build).
CKPT_INTERVAL = rk.CKPT_INTERVAL
#: Which path the most recent :func:`fused_backward` took: ``use_hist``,
#: ``two_level``, ``tau``, ``track_min`` (the JAX package keeps the same
#: record, ``pallas_backward.LAST_PATH``); on the card also
#: :data:`LAST_LAUNCH`'s ``grid`` and ``scratch_bytes``.
LAST_PATH: dict = {}
#: The most recent launch of either wrapper: its ``grid`` and the bytes of
#: its ``scratch`` slots (0 with the forward's history).
LAST_LAUNCH: dict = {}
#: The kernel's modes, as ``rm_render_bwd_resident`` takes them.
MODE_FULL, MODE_TWO_LEVEL, MODE_MARCH_ONLY = 0, 1, 2

# (SdfProgram -> {device: flat offsets of the scene's scalars, on device}).
_SCALAR_INDEX = weakref.WeakKeyDictionary()
# (library, device index, f64, route, mode, track_min) -> resident blocks.
_RESIDENT: dict = {}


def _scalar_index(program, device):
    per_device = _SCALAR_INDEX.setdefault(program, {})
    if device not in per_device:
        per_device[device] = torch.tensor(program.scalar_offsets,
                                          dtype=torch.long, device=device)
    return per_device[device]


def two_level_engages(steps, tau=0.0, track_min=False) -> bool:
    """Whether a two-level backward that was asked for runs: the step count
    is a multiple of :data:`CKPT_INTERVAL` and at least two segments long,
    there is no early exit and no ``min_f`` routing (both need every
    position). The rule of the JAX package's ``two_level_engages``, whose
    environment switch is the ``two_level`` argument here. The forward's
    decision to log a history must agree with it, so both ask this one
    function."""
    k = CKPT_INTERVAL
    return (steps % k == 0 and steps >= 2 * k and not track_min
            and tau == 0.0)


def _check(program, params_flat, rays7, g, steps, track_min, hist, minf, amin,
           nlive, n_g=None, mats=()):
    rk._check(program, params_flat, rays7, steps, mats)
    plane = tuple(rays7.shape[1:])
    n_g = n_g or (9 if track_min else 8)
    if tuple(g.shape) != (n_g,) + plane or g.dtype != rays7.dtype:
        raise ValueError(f"g must be {(n_g,) + plane} of {rays7.dtype}, got "
                         f"{tuple(g.shape)} of {g.dtype}")
    if hist is None:
        return
    if nlive is None or (track_min and (minf is None or amin is None)):
        raise ValueError("a history needs nlive and, with track_min, minf "
                         "and amin")
    want = {"hist": ((int(steps) + 1, 3) + plane, rays7.dtype),
            "nlive": (plane, torch.int32)}
    given = {"hist": hist, "nlive": nlive}
    if track_min:
        want.update(minf=(plane, rays7.dtype), amin=(plane, torch.int32))
        given.update(minf=minf, amin=amin)
    for name, (shape, dtype) in want.items():
        t = given[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} of {dtype}, got "
                             f"{tuple(t.shape)} of {t.dtype}")
        if t.device != rays7.device:
            raise ValueError(f"{name} on {t.device}, rays7 on {rays7.device}")


def scratch_slots(n_blocks: int, resident: int) -> int:
    """The grid of a backward launch that marches again, which is also its
    number of scratch slots: one block per block the card holds at once
    (``resident``: its SMs times the instantiation's occupancy), never more
    than the ``n_blocks`` ray blocks, and at least one."""
    return max(1, min(int(n_blocks), int(resident)))


def scratch_shape(slots: int, steps: int, two_level: bool = False):
    """The scratch of a launch on ``slots`` blocks: per slot ``(steps + 1,
    3, 128)`` positions, or with ``two_level`` ``(steps / CKPT_INTERVAL, 3,
    128)`` checkpoints, lane-minor."""
    n_pos = int(steps) // CKPT_INTERVAL if two_level else int(steps) + 1
    return (int(slots), n_pos, 3, LANES)


def _resident(lib, dev, dtype, route, mode, track_min) -> int:
    """Blocks of the instantiation the card ``dev`` holds at once (the
    kernel's occupancy query, cached)."""
    key = (lib._name, dev.index, dtype, route, mode, bool(track_min))
    if key not in _RESIDENT:
        blocks = ctypes.c_longlong(0)
        with torch.cuda.device(dev):
            err = lib.rm_render_bwd_resident(
                int(dtype == torch.float64), int(route == "tc"), mode,
                int(track_min), ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"render_bwd occupancy query failed: "
                               f"cudaError {err}")
        _RESIDENT[key] = blocks.value
    return _RESIDENT[key]


def partial_cols(program: SdfProgram) -> int:
    """Columns of the kernel's partials: the scene's scalars, then its
    packed matrices (none for an analytic scene)."""
    return len(program.scalar_offsets) + program.mat_size


def _launch(program, params_flat, rays7, call, mats, route, mode=None,
            steps=0, track_min=False):
    """Allocate the outputs and, for a ``mode`` that marches again (None:
    the forward's history), the scratch slots; run ``call(lib, packed, out,
    partials, n_blocks, grid, scratch, n_cols, n, stream)`` (one kernel
    launch, returning its cudaError) and assemble ``(params_flat cotangent,
    matrix cotangents, rays7 cotangent)``: the rows of partials summed over
    the blocks in their order. ``packed`` is the matrix buffer of the MLP
    ``route``; ``scratch`` is None with the forward's history."""
    lib = rk._load(program)
    packed = (rk.tc_buffer(program, mats, backward=True) if route == "tc"
              else rk._packed(mats))
    dev, dtype = rays7.device, rays7.dtype
    n = rays7.shape[1] * LANES
    n_blocks = -(-n // lib.rm_render_bwd_block())
    n_scalars, n_cols = len(program.scalar_offsets), partial_cols(program)
    out = torch.empty((7,) + tuple(rays7.shape[1:]), dtype=dtype, device=dev)
    out[6].zero_()
    partials = torch.empty((n_blocks, n_cols), dtype=dtype, device=dev)
    grid, scratch = n_blocks, None
    if mode is not None:
        grid = scratch_slots(n_blocks, _resident(lib, dev, dtype, route,
                                                 mode, track_min))
        scratch = torch.empty(scratch_shape(grid, steps,
                                            mode == MODE_TWO_LEVEL),
                              dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = call(lib, rk._ptr(packed), out, partials, n_blocks, grid,
                   scratch, n_cols, n,
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_bwd kernel launch failed: cudaError {err}")
    LAST_LAUNCH.update(grid=grid, scratch_bytes=0 if scratch is None else
                       scratch.numel() * scratch.element_size())
    total = partials.sum(0)
    gflat = torch.zeros_like(params_flat)
    if n_scalars:
        gflat[_scalar_index(program, dev)] = total[:n_scalars]
    gmats = tuple(total[n_scalars + s.offset:n_scalars + s.offset + s.size]
                  .reshape(s.shape) for s in program.mat_specs)
    return gflat, gmats, out


def _contiguous_cuda(rays7, tensors):
    if rays7.device.type != "cuda":
        raise ValueError(f"unsupported device {rays7.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the backward kernel takes contiguous tensors")


def fused_backward(program: SdfProgram, params_flat, rays7, g, steps, tau,
                   normals_eps, track_min=False, hist=None, minf=None,
                   amin=None, nlive=None, two_level=False, mats=(),
                   route=None):
    """Backward of ``fused_march_normals`` (``track_min``: of ``_cov``).

    ``g`` holds the cotangents of the 8 (or 9) output planes. ``hist``
    (steps + 1, 3, rows, 128) and ``nlive`` (int32) are the forward's march
    history and live-step counts (:func:`render_kernel.march_forward` with
    ``log_hist``), and with ``track_min`` ``minf`` and ``amin`` its closest
    approach and arg-min step; without a history the positions are
    recomputed in the kernel, into scratch slots allocated here (the module
    doc). ``two_level`` asks for the recompute that keeps only every
    :data:`CKPT_INTERVAL`-th position, ``steps / CKPT_INTERVAL`` positions
    a slot, and marches each segment again during the sweep; it runs where
    :func:`two_level_engages` allows and ignores a history, otherwise the
    ordinary path runs. All three give bitwise the
    same result. :data:`LAST_PATH` records which one ran. ``mats`` are the
    scene's matrix parameters (``split_params_padded``). ``route`` is the
    MLP route of the forward that made the history (see the module doc).

    Returns ``(params_flat cotangent (P,), matrix cotangents (like mats),
    rays7 cotangent (7, rows, 128))``; the validity plane's cotangent is
    zero."""
    _check(program, params_flat, rays7, g, steps, track_min, hist, minf, amin,
           nlive, mats=mats)
    if route is None:
        route = rk.mlp_route(program, rays7.dtype)
    rk._check_route(program, rays7, route)
    two_level = bool(two_level) and two_level_engages(steps, tau, track_min)
    if two_level:
        hist = minf = amin = nlive = None
    LAST_PATH.clear()
    LAST_PATH.update(use_hist=hist is not None, two_level=two_level, tau=tau,
                     track_min=track_min)
    if rays7.device.type == "cpu":
        return reference_backward(program, params_flat, rays7, g, steps, tau,
                                  normals_eps, track_min=track_min, hist=hist,
                                  minf=minf, amin=amin, nlive=nlive,
                                  two_level=two_level, mats=mats)
    _contiguous_cuda(rays7, [params_flat, rays7, g]
                     + [t for t in (hist, minf, amin, nlive) if t is not None])
    dtype = rays7.dtype
    recompute = hist is None and not two_level
    mode = (MODE_TWO_LEVEL if two_level else MODE_FULL if recompute
            else None)
    consts = rk._host_consts(dtype, tau, normals_eps)

    def call(lib, packed, out, partials, n_blocks, grid, scratch, n_cols, n,
             stream):
        global LAUNCHES, TC_LAUNCHES, PRUNE_LAUNCHES
        if route == "tc":
            fn = lib.rm_render_bwd_tc_f32
            TC_LAUNCHES += 1
        else:
            fn = (lib.rm_render_bwd_f32 if dtype == torch.float32
                  else lib.rm_render_bwd_f64)
        LAUNCHES += 1
        if program.pruned and (recompute or two_level):
            PRUNE_LAUNCHES += 1
        return fn(params_flat.data_ptr(), packed, rays7.data_ptr(),
                  g.data_ptr(), int(track_min),
                  rk._ptr(scratch if recompute else hist), int(recompute),
                  rk._ptr(scratch if two_level else None), int(two_level),
                  rk._ptr(minf), rk._ptr(amin), rk._ptr(nlive),
                  out.data_ptr(), partials.data_ptr(), n_blocks, grid,
                  n_cols, n, int(steps),
                  consts.ctypes.data_as(ctypes.c_void_p), stream)

    result = _launch(program, params_flat, rays7, call, mats, route, mode,
                     steps, track_min)
    LAST_PATH.update(LAST_LAUNCH)
    return result


def march_backward(program: SdfProgram, params_flat, rays7, g, steps, tau,
                   mats=(), route=None):
    """Backward of :func:`march_kernel.march_planes`: ``g`` holds the
    cotangents of its 4 output planes (x y z d). The kernel marches again
    into scratch slots allocated here (the module doc), seeds the terminal
    position with the position cotangent plus one SDF VJP weighted by the
    distance's, and runs the reverse sweep: the backward kernel without its
    normals tail.
    ``route`` as in :func:`fused_backward`.

    Returns ``(params_flat cotangent (P,), matrix cotangents (like mats),
    rays7 cotangent (7, rows, 128))``."""
    _check(program, params_flat, rays7, g, steps, False, None, None, None,
           None, n_g=4, mats=mats)
    if route is None:
        route = rk.mlp_route(program, rays7.dtype)
    rk._check_route(program, rays7, route)
    if rays7.device.type == "cpu":
        return reference_backward(program, params_flat, rays7, g, steps, tau,
                                  None, march_only=True, mats=mats)
    _contiguous_cuda(rays7, [params_flat, rays7, g])
    dtype = rays7.dtype

    def call(lib, packed, out, partials, n_blocks, grid, scratch, n_cols, n,
             stream):
        global MARCH_LAUNCHES, MARCH_TC_LAUNCHES
        if route == "tc":
            fn = lib.rm_march_bwd_tc_f32
            MARCH_TC_LAUNCHES += 1
        else:
            fn = (lib.rm_march_bwd_f32 if dtype == torch.float32
                  else lib.rm_march_bwd_f64)
        MARCH_LAUNCHES += 1
        return fn(params_flat.data_ptr(), packed, rays7.data_ptr(),
                  g.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                  partials.data_ptr(), n_blocks, grid, n_cols, n, int(steps),
                  float(tau), stream)

    return _launch(program, params_flat, rays7, call, mats, route,
                   MODE_MARCH_ONLY, steps)


def _two_level_positions(sdf, params, start, dirs, steps):
    """The two-level recompute on tensors (tau = 0): march forward keeping
    every :data:`CKPT_INTERVAL`-th position, then hand out the positions in
    the sweep's order ``steps-1 .. 0``, marching each segment again from its
    checkpoint when the sweep reaches it. Returns ``(terminal position,
    iterator of (step, position))``; at most ``steps / CKPT_INTERVAL +
    CKPT_INTERVAL`` positions are alive at a time."""
    k = CKPT_INTERVAL

    def advance(pos, n):
        """``n`` march steps: the positions before each, and the one after
        the last."""
        before = []
        for _ in range(n):
            before.append(pos)
            d = sdf(params, *pos)
            pos = [c + d * v for c, v in zip(pos, dirs)]
        return before, pos

    with torch.no_grad():
        ckpts, pos = [], start
        for _ in range(steps // k):
            ckpts.append(pos)
            _, pos = advance(pos, k)

    def sweep():
        for seg in reversed(range(len(ckpts))):
            with torch.no_grad():
                before, last = advance(ckpts[seg], k - 1)
            segment = before + [last]
            for j in reversed(range(k)):
                yield seg * k + j, segment[j]

    return pos, sweep()


def reference_backward(program: SdfProgram, params_flat, rays7, g, steps, tau,
                       normals_eps, track_min=False, hist=None, minf=None,
                       amin=None, nlive=None, two_level=False,
                       march_only=False, mats=()):
    """The plain PyTorch version of :func:`fused_backward` and, with
    ``march_only``, of :func:`march_backward` (``g`` then has the 4 planes
    x y z d and ``normals_eps`` is not read).

    Pad slots (``valid <= 0.5``) are left out before anything is evaluated,
    as a kernel thread returns early on them: they get zero cotangents by
    construction, never by multiplying a possibly non-finite value by 0.
    ``two_level`` really runs the kernel's algorithm, checkpoints and
    segment replay (:func:`_two_level_positions`), where
    :func:`two_level_engages` allows it. The matrix cotangents are
    ``torch.autograd.grad`` into ``mats`` through the plain SDF."""
    steps = int(steps)
    two_level = bool(two_level) and two_level_engages(steps, tau, track_min)
    sdf = program.sdf_c
    valid = (rays7[6] > 0.5).reshape(-1)
    pick = lambda plane: plane.reshape(-1)[valid]  # noqa: E731
    vx, vy, vz = (pick(rays7[i]).detach() for i in (3, 4, 5))
    gv = [pick(g[i]) for i in range(g.shape[0])]
    flat = params_flat.detach().requires_grad_(True)
    leaves = [flat] + [m.detach().requires_grad_(True) for m in mats]
    with torch.enable_grad():
        params = program.rebuild(flat, leaves[1:])

    def grad(outputs, inputs, cotangents):
        """Cotangents of the parameter leaves (zeros where unused), then of
        ``inputs``."""
        got = torch.autograd.grad(outputs, leaves + inputs, cotangents,
                                  allow_unused=True)
        return ([torch.zeros_like(p) if d is None else d
                 for p, d in zip(leaves, got)], got[len(leaves):])

    if two_level:
        start = [pick(rays7[i]).detach() for i in range(3)]
        with torch.no_grad():
            end, positions = _two_level_positions(
                sdf, program.rebuild(params_flat.detach(),
                                     [m.detach() for m in mats]), start,
                (vx, vy, vz), steps)
        nlive_v = torch.full(vx.shape, steps, dtype=torch.int32,
                             device=vx.device)
    else:
        if hist is None:
            # march_only: the forward's tail planes are not read, so any
            # normals_eps does.
            fwd, extras = rk._reference_march(
                program, params_flat.detach(), rays7.detach(), steps, tau,
                5e-2 if march_only else normals_eps, track_min=track_min,
                log_hist=True, mats=[m.detach() for m in mats])
            hist, nlive = extras["hist"], extras["nlive"]
            if track_min:
                minf, amin = fwd[8], extras["amin"]
        nlive_v = pick(nlive)
        end = [pick(hist[steps, c]) for c in range(3)]
        n_sweep = (steps if track_min or not nlive_v.numel()
                   else int(nlive_v.max()))
        positions = ((s, [pick(hist[s, c]) for c in range(3)])
                     for s in reversed(range(n_sweep)))
    end = [c.detach().requires_grad_(True) for c in end]

    # Tail VJP into the terminal position.
    with torch.enable_grad():
        if march_only:
            tail, g_tail = [sdf(params, *end)], [gv[3]]
        else:
            off, inv, lap_scale, _ = rk._plain_consts(rays7.dtype, tau,
                                                      normals_eps)
            tail = rk._tail_planes(sdf, params, *end, off, inv, lap_scale)
            g_tail = [gv[3], gv[4], gv[5], gv[6], gv[7]]
    gparams, (gx, gy, gz) = grad(tail, end, g_tail)
    gx, gy, gz = gx + gv[0], gy + gv[1], gz + gv[2]

    # Reverse sweep; frozen steps sit at the terminal position.
    gvx, gvy, gvz = (torch.zeros_like(gx) for _ in range(3))
    if track_min:
        minf_v, amin_v, carry = pick(minf), pick(amin), gv[8]
    for s, before in positions:
        live = nlive_v > s
        pos = [torch.where(live, p.detach(), e.detach()).requires_grad_(True)
               for p, e in zip(before, end)]
        with torch.enable_grad():
            d = sdf(params, *pos)
        gd = torch.where(live, gx * vx + gy * vy + gz * vz, 0.0)
        if track_min:
            first = amin_v == s
            tie = (d.detach() == minf_v) & ~first
            share = torch.where(tie, 0.5 * carry, 0.0)
            gd = gd + torch.where(first, carry, share)
            carry = torch.where(first, 0.0, torch.where(tie, share, carry))
        dparams, (sx, sy, sz) = grad(d, pos, gd)
        gparams = [a + b for a, b in zip(gparams, dparams)]
        dd = d.detach()
        gvx = gvx + torch.where(live, gx * dd, 0.0)
        gvy = gvy + torch.where(live, gy * dd, 0.0)
        gvz = gvz + torch.where(live, gz * dd, 0.0)
        gx, gy, gz = gx + sx, gy + sy, gz + sz

    out = torch.zeros((7, valid.shape[0]), dtype=rays7.dtype,
                      device=rays7.device)
    for i, plane in enumerate((gx, gy, gz, gvx, gvy, gvz)):
        out[i, valid] = plane
    return (gparams[0].detach(), tuple(m.detach() for m in gparams[1:]),
            out.reshape(rays7.shape))


#: Ray-dependent operations per valid ray outside the SDF VJPs. Tail: 27
#: offset adds, the forward tail's 3 subs, 15 for the 3×3 inverse and 6 for
#: the norm, then 12 for the norm's cotangent, 2 for sqrt's, 15 into N, 15
#: through the inverse's transpose, 3 + 7 for the Laplacian and the offsets'
#: cotangents, 15 position adds. Step: 5 for the distance's cotangent, 6 for
#: the direction's, 3 position adds.
OPS_BWD_TAIL = 27 + 3 + 15 + 6 + 12 + 2 + 15 + 15 + 10 + 15
OPS_BWD_STEP = 14


def backward_ops(program: SdfProgram, n_valid: int, swept_steps: int,
                 recomputed_steps: int = 0, track_min: bool = False,
                 march_only: bool = False) -> int:
    """Operations the backward needs, by the op-count convention of
    scene/codegen.py: per valid ray 5 SDF VJPs for the tail (a VJP holds
    its own primal evaluation, which also gives the tail its 5 distances;
    the kernel evaluates the 4 offset distances once more before them, and
    that is not counted as needed), and one VJP per swept step
    (``swept_steps`` is their sum over the rays; with ``track_min`` the tie
    test evaluates the SDF once more). ``recomputed_steps`` (summed over
    the rays) are the forward steps the kernel marches again when it gets
    no history; the two-level backward marches every step once for its
    checkpoints and ``CKPT_INTERVAL - 1`` of every ``CKPT_INTERVAL`` once
    more in the replay. ``march_only``: the tail is one VJP and 3 adds."""
    ev, vjp = program.ops_per_eval, program.vjp_ops_per_eval
    tail = n_valid * (vjp + 3 if march_only else 5 * vjp + OPS_BWD_TAIL)
    per_step = vjp + OPS_BWD_STEP + (ev + 4 if track_min else 0)
    return (tail + swept_steps * per_step
            + recomputed_steps * (ev + rk.OPS_PER_STEP))
