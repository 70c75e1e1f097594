"""Fused march + normals + Laplacian: the CUDA kernel, its build and binding,
its plain PyTorch version, and the differentiable entry points.

Counterpart of ``ray_marching_tpu/ops/pallas_render.py`` (``_render_kernel``;
``fused_march_normals`` and ``fused_march_normals_cov`` there, and
``_reference_fn`` for the plain version). The kernel source is
``csrc/render_fwd.cu``; the scene's SDF is generated per scene by
:mod:`ray_marching_tpu_torch.scene.codegen` and included into it.

Scenes with ``NeuralSDF`` leaves hand their weight matrices to the kernels as
well: every entry point takes ``mats``, the matrix tuple of
:func:`ops.params.split_params_padded`, packs it (:func:`ops.params.pack_mats`)
and passes the buffer as ``M``; the MLP runs inside the kernels
(``csrc/neural.cuh``), its VJP inside the backward kernel, and the autograd
functions' ``backward`` returns one cotangent per matrix.

Build: ``nvcc`` compiles one shared library with a plain C interface per
scene, holding the forward kernel, the backward kernel
(``csrc/render_bwd.cu``, bound in :mod:`.backward_kernel`) and the march
kernel (``csrc/march.cu``, bound in :mod:`.march_kernel`), at first use,
into ``_build/<hash>/`` beside this module (the hash covers the generated
SDF, the kernel sources and the flags), and ctypes binds it. Each source is
compiled by an nvcc process of its own, all started together, and one more
links the objects. Launches go on the current CUDA stream and allocate
nothing inside the kernel; the wrapper allocates the outputs.

:func:`fused_march_normals` and :func:`fused_march_normals_cov` are
differentiable: when an input requires grad the forward launches the
training configuration of the kernel (with the march history when
``bwd_hist`` and the history fits under ``RM_TPU_BWD_HIST_MAX``,
:func:`hist_enabled`; without one when the two-level backward engages,
``bwd_two_level``) and ``backward()`` launches the backward kernel. Both take
the plain versions only for tensors on the CPU. For CUDA tensors they launch the
kernels or raise; they never fall back.

Two MLP routes (:func:`mlp_route`): a scene with a tensor-core leaf
(``SdfProgram.tc``) in f32 launches the tensor-core entries, served
(``render_fwd_tc_kernel``) or differentiated (``render_fwd_train_tc_kernel``,
whose backward is the backward kernel's tensor-core instantiation): the MLP
on ``mma.sync``, 3xTF32 or bf16 operands, within the f32 tolerance of the
plain version rather than equal to the per-thread kernel. f64 and every
other scene take the per-thread entries. On either route the training
forward's planes equal the serving forward's, and its history equals the
backward's recompute and two-level replay, bit for bit. The tensor-core
entries take the packed matrices followed by the fragments of
:func:`ops.params.pack_tc`.

A program built with the union short-circuit (``SdfProgram(scene,
prune=True)`` where some union child qualifies; ``FastRenderer`` builds one
when ``RM_TPU_CSG_PRUNE=1``) gets a library of its own whose forward kernels
and backward marches skip a guarded child per thread where it cannot be the
minimum (``scene_sdf_fwd``): the same outputs, bit for bit. Its plain
version keeps the plain ``sdf_c``, which gives those values by
construction.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ray_marching_tpu_torch.ops.params import pack_mats, pack_tc
from ray_marching_tpu_torch.render.normals import make_offsets
from ray_marching_tpu_torch.scene.codegen import SdfProgram

LANES = 128
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_UNITS = ("render_fwd.cu", "render_bwd.cu", "march.cu")
KERNEL_SOURCES = KERNEL_UNITS + ("sdf_prims.cuh", "render_consts.cuh",
                                 "march_loop.cuh", "neural.cuh")
#: The two-level backward keeps every ``CKPT_INTERVAL``-th march position and
#: marches each segment again when the sweep reaches it. The one definition:
#: the kernel gets it from the compiler's command line (so it is part of the
#: build hash), ``backward_kernel`` reads it from here.
CKPT_INTERVAL = 8
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    # Op-for-op parity with the plain version: no FMA contraction, and no
    # --use_fast_math (IEEE sqrt and division).
    "--fmad=false",
    f"-DRM_CKPT_INTERVAL={CKPT_INTERVAL}",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

#: Forward-kernel launches so far (the wrapper adds one per launch, nowhere
#: else; the backward kernel counts its own in backward_kernel.LAUNCHES).
LAUNCHES = 0
#: Those of them that launched the tensor-core entry (render_fwd_tc_kernel).
TC_LAUNCHES = 0
#: Those of them that launched a pruned program's kernels (SdfProgram.pruned).
PRUNE_LAUNCHES = 0
#: Whether a differentiated forward logs its march history for the backward
#: kernel; the counterpart of the JAX package's RM_TPU_BWD_HIST, and the one
#: default (the ``bwd_hist`` argument of the two entry points is the one
#: override). The other choice is the backward kernel's own recompute in
#: bounded scratch; the two give bitwise the same gradients. PERF.md has
#: both times on the H100. Above ``RM_TPU_BWD_HIST_MAX`` bytes no history is
#: logged, whatever this says (:func:`hist_enabled`).
BWD_HIST = True
#: The largest history in bytes a differentiated forward logs when the
#: environment does not set ``RM_TPU_BWD_HIST_MAX``: the JAX package's
#: default (4 GiB), not retuned for the H100.
HIST_MAX_DEFAULT = 2**32
#: Whether a differentiated forward asks for the two-level backward
#: (checkpoints every :data:`CKPT_INTERVAL` steps and segment
#: replay, for step counts whose history does not fit); the counterpart of
#: the JAX package's RM_TPU_BWD_TWO_LEVEL, overridden by the ``bwd_two_level``
#: argument of the two entry points. It runs only where
#: ``backward_kernel.two_level_engages`` allows it; the forward then logs no
#: history. Otherwise :data:`BWD_HIST` decides as before.
BWD_TWO_LEVEL = False
#: The serving forward refills lanes (``render_fwd_refill_kernel``) at
#: tau > 0 for a scene whose SDF costs at least this many operations per
#: evaluation; a cheaper one keeps one thread per ray, whose march the
#: refill bookkeeping and its per-pass tail would slow down (test_scene2, 65
#: ops, measured 1.76x slower with refill; the bulb, 875, 1.8x faster;
#: PERF.md §6). The per-thread march takes the same threshold
#: (:func:`uses_refill` decides for both): with refill test_scene2's
#: measured 1.56x slower at tau = 1e-3, the bulb's 1.17x faster.
REFILL_MIN_OPS = 400
#: nvcc/ptxas output of each build, keyed by build hash.
BUILD_LOG: dict = {}

_LIBS: dict = {}  # build hash -> loaded library
_BOUND = weakref.WeakKeyDictionary()  # SdfProgram -> loaded library


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def scene_flags(program: SdfProgram) -> tuple:
    """The nvcc flags of one scene's library beside :data:`NVCC_FLAGS`: the
    blocks an SM must hold of the backward's per-thread f32 instantiations
    that march into a scratch slot (``RM_BWD_OWN_MIN_BLOCKS``,
    ``csrc/render_bwd.cu``): 5 for an SDF without a rolled loop, 4 for one
    with (its checkpointed VJP needs 128 registers)."""
    return (f"-DRM_BWD_OWN_MIN_BLOCKS={4 if program.loops else 5}",)


def kernel_key(program: SdfProgram) -> str:
    """Hash of everything the scene's library is built from."""
    h = hashlib.sha256(program.cuda_source().encode())
    for name in KERNEL_SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + scene_flags(program)).encode())
    return h.hexdigest()[:16]


def _lib_path(key: str) -> Path:
    return BUILD_DIR / key / "librender.so"


def build_kernels(programs) -> None:
    """Build the libraries of ``programs`` that are not built yet: one nvcc
    process per source file and scene, all started together, then one link
    per scene; record their output in :data:`BUILD_LOG`."""
    pending = {}
    for program in programs:
        key = kernel_key(program)
        if key not in pending and not _lib_path(key).exists():
            pending[key] = program
    nvcc = _nvcc() if pending else None
    procs = []

    def start(cmd):
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append(proc)
        return proc

    def finish(key, proc):
        log, _ = proc.communicate()
        BUILD_LOG[key] = BUILD_LOG.get(key, "") + log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kernel {key}:\n{log}")

    try:
        compiles = []
        for key, program in pending.items():
            out_dir = BUILD_DIR / key
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / "scene_sdf.cuh").write_text(program.cuda_source())
            BUILD_LOG[key] = ""
            for unit in KERNEL_UNITS:
                obj = out_dir / f"{unit}.{os.getpid()}.o"
                compiles.append((key, obj, start(
                    [nvcc, *NVCC_FLAGS, *scene_flags(program), "-I",
                     str(CSRC), "-I", str(out_dir), "-c", "-o", str(obj),
                     str(CSRC / unit)])))
        for key, _, proc in compiles:
            finish(key, proc)
        links = []
        for key in pending:
            tmp = BUILD_DIR / key / f"librender.so.tmp{os.getpid()}"
            objs = [str(obj) for k, obj, _ in compiles if k == key]
            links.append((key, tmp, objs, start(
                [nvcc, "-shared", "-o", str(tmp), *objs])))
        for key, tmp, objs, proc in links:
            finish(key, proc)
            os.replace(tmp, _lib_path(key))
            for obj in objs:
                os.unlink(obj)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _load(program: SdfProgram):
    lib = _BOUND.get(program)
    if lib is not None:
        return lib
    key = kernel_key(program)
    lib = _LIBS.get(key)
    if lib is None:
        build_kernels([program])
        lib = ctypes.CDLL(str(_lib_path(key)))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f64 = ctypes.c_double
        for name in ("rm_render_fwd_f32", "rm_render_fwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr, ptr, ptr]
            fn.restype = i32
        for name in ("rm_render_fwd_train_f32", "rm_render_fwd_train_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, ptr, i32, ptr, ptr,
                           ptr, ptr, ptr]
            fn.restype = i32
        for name in ("rm_march_f32", "rm_march_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, f64, ptr, ptr]
            fn.restype = i32
        for name in ("rm_render_bwd_f32", "rm_render_bwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, i32, ptr, i32, ptr,
                           ptr, ptr, ptr, ptr, i64, i64, i64, i64, i32, ptr,
                           ptr]
            fn.restype = i32
        for name in ("rm_march_bwd_f32", "rm_march_bwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                           i64, i32, f64, ptr]
            fn.restype = i32
        lib.rm_render_bwd_block.argtypes = []
        lib.rm_render_bwd_block.restype = i32
        lib.rm_render_bwd_resident.argtypes = [i32, i32, i32, i32,
                                               ctypes.POINTER(i64)]
        lib.rm_render_bwd_resident.restype = i32
        if program.tc:
            lib.rm_render_fwd_tc_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i32,
                                                 ptr, ptr]
            lib.rm_render_fwd_tc_f32.restype = i32
            lib.rm_render_fwd_train_tc_f32.argtypes = [
                ptr, ptr, ptr, ptr, i64, i32, ptr, i32, ptr, ptr, ptr, ptr,
                ptr]
            lib.rm_render_fwd_train_tc_f32.restype = i32
            lib.rm_march_tc_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i32, f64,
                                            ptr]
            lib.rm_march_tc_f32.restype = i32
            lib.rm_render_bwd_tc_f32.argtypes = [
                ptr, ptr, ptr, ptr, i32, ptr, i32, ptr, i32, ptr, ptr, ptr,
                ptr, ptr, i64, i64, i64, i64, i32, ptr, ptr]
            lib.rm_render_bwd_tc_f32.restype = i32
            lib.rm_march_bwd_tc_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                                ptr, i64, i64, i64, i64, i32,
                                                f64, ptr]
            lib.rm_march_bwd_tc_f32.restype = i32
            lib.rm_render_bwd_tc_smem.argtypes = []
            lib.rm_render_bwd_tc_smem.restype = i32
        _LIBS[key] = lib
    _BOUND[program] = lib
    return lib


def _np_dtype(dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


@functools.lru_cache(maxsize=64)
def _host_consts(dtype, tau, normals_eps) -> np.ndarray:
    """Offsets, inverse, 6/eps² and tau, each rounded to ``dtype`` once
    (cached: callers must not write to the array)."""
    npd = _np_dtype(dtype)
    offsets, inverse = make_offsets(normals_eps, np_dtype=npd)
    return np.concatenate([
        offsets.reshape(-1), inverse.reshape(-1),
        np.asarray([6.0 / normals_eps**2, tau], npd),
    ]).astype(npd)


def _check(program, params_flat, rays7, steps, mats=()):
    if len(mats) != program.n_mats:
        raise ValueError(f"the scene has {program.n_mats} matrix parameters, "
                         f"got {len(mats)}")
    for spec, m in zip(program.mat_specs, mats):
        if (tuple(m.shape) != spec.shape or m.dtype != rays7.dtype
                or m.device != rays7.device):
            raise ValueError(f"matrix {spec.path!r} must be {spec.shape} of "
                             f"{rays7.dtype} on {rays7.device}, got "
                             f"{tuple(m.shape)} of {m.dtype} on {m.device}")
    if rays7.dim() != 3 or rays7.shape[0] != 7 or rays7.shape[2] != LANES:
        raise ValueError(f"rays7 must be (7, rows, {LANES}), got "
                         f"{tuple(rays7.shape)}")
    if rays7.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rays7 must be float32 or float64, got {rays7.dtype}")
    if params_flat.dtype != rays7.dtype:
        raise TypeError(f"params_flat dtype {params_flat.dtype} != rays7 "
                        f"dtype {rays7.dtype}")
    if params_flat.shape != (program.n_flat,):
        raise ValueError(f"params_flat must be ({program.n_flat},), got "
                         f"{tuple(params_flat.shape)}")
    if params_flat.device != rays7.device:
        raise ValueError(f"params_flat on {params_flat.device}, rays7 on "
                         f"{rays7.device}")
    if int(steps) != steps or steps < 0:
        raise ValueError(f"steps must be a non-negative int, got {steps!r}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _packed(mats):
    """The matrix buffer a kernel takes (None for an analytic scene): one
    contiguous allocation, so its 16-byte alignment holds."""
    packed = pack_mats(mats)
    if packed is not None and packed.data_ptr() % 16:
        raise ValueError("the packed matrix buffer is not 16-byte aligned")
    return packed


def mlp_route(program: SdfProgram, dtype) -> str:
    """The MLP evaluation the forward, the march and their backward take by
    default: ``"tc"`` (the tensor-core entries) for a scene with a
    tensor-core leaf in float32, ``"thread"`` (one thread per ray)
    otherwise. A differentiated forward or march hands its route to its
    backward, whose marches then give the forward's positions bit for
    bit."""
    return "tc" if program.tc and dtype == torch.float32 else "thread"


def uses_refill(program: SdfProgram, dtype, tau, route) -> bool:
    """Whether the serving forward or the march takes its lane-refill entry
    on the card: on the per-thread route, at tau > 0 as the kernels round it
    to ``dtype``, for an SDF of at least :data:`REFILL_MIN_OPS`
    operations."""
    return bool(route == "thread"
                and np.asarray(tau, _np_dtype(dtype)) != 0
                and program.ops_per_eval >= REFILL_MIN_OPS)


def tc_buffer(program: SdfProgram, mats, backward=False):
    """The matrix buffer of the tensor-core entries: the packed matrices,
    then each tensor-core layer's fragments and, with ``backward`` (the
    backward kernel's buffer), its backward fragments
    (:func:`ops.params.pack_tc`), prepared from ``mats`` on their device,
    detached."""
    with torch.no_grad():
        return pack_tc(_packed(mats), mats, program.tc_mats, backward)


def _check_route(program, rays7, route, tc_mats=None):
    if route not in ("tc", "thread"):
        raise ValueError(f"route must be 'tc' or 'thread', got {route!r}")
    if route == "tc" and not (program.tc and rays7.dtype == torch.float32):
        raise ValueError("the tensor-core route needs a scene with a "
                         "tensor-core MLP leaf and float32")
    if tc_mats is not None and (
            route != "tc" or tc_mats.shape != (program.tc_size,)
            or tc_mats.dtype != torch.float32
            or tc_mats.device != rays7.device
            or not tc_mats.is_contiguous() or tc_mats.data_ptr() % 16):
        raise ValueError(f"tc_mats must be a contiguous, 16-byte aligned "
                         f"({program.tc_size},) float32 buffer on "
                         f"{rays7.device}, for the tensor-core route")


def march_forward(program: SdfProgram, params_flat, rays7, steps, tau,
                  normals_eps, track_min=False, log_hist=False,
                  track_argpos=False, mats=(), route=None, tc_mats=None):
    """One forward march, not differentiable: ``(out, extras)``. ``mats``
    are the scene's matrix parameters (``split_params_padded``).

    ``out`` is (8, rows, 128), or (9, rows, 128) with ``track_min`` (plane 8
    is ``min_f``). ``extras`` holds what was asked for: ``amin`` (int32
    arg-min step, with ``track_min`` and ``log_hist``), ``argpos``
    (3, rows, 128), ``hist`` (steps + 1, 3, rows, 128) and ``nlive`` (int32
    live-step count). With none of the options this is the serving
    configuration of the kernel, else its training configuration, on the
    MLP ``route`` (by default :func:`mlp_route`), which ``tc_mats`` may hand
    a prepared buffer (:func:`tc_buffer`). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global LAUNCHES, TC_LAUNCHES, PRUNE_LAUNCHES
    _check(program, params_flat, rays7, steps, mats)
    if route is None:
        route = mlp_route(program, rays7.dtype)
    _check_route(program, rays7, route, tc_mats)
    if rays7.device.type == "cpu":
        return _reference_march(program, params_flat, rays7, steps, tau,
                                normals_eps, track_min, log_hist,
                                track_argpos, mats)
    if rays7.device.type != "cuda":
        raise ValueError(f"unsupported device {rays7.device}")
    if not (rays7.is_contiguous() and params_flat.is_contiguous()):
        raise ValueError("rays7 and params_flat must be contiguous")
    if route == "tc":
        packed = tc_buffer(program, mats) if tc_mats is None else tc_mats
    else:
        packed = _packed(mats)
    lib = _load(program)
    plane_shape = tuple(rays7.shape[1:])
    dev, dtype = rays7.device, rays7.dtype
    out = torch.empty((9 if track_min else 8,) + plane_shape, dtype=dtype,
                      device=dev)
    consts = _host_consts(dtype, tau, normals_eps)
    consts_p = consts.ctypes.data_as(ctypes.c_void_p)
    n = rays7.shape[1] * LANES
    f32 = dtype == torch.float32
    extras = {}
    if track_min and log_hist:
        extras["amin"] = torch.empty(plane_shape, dtype=torch.int32,
                                     device=dev)
    if track_min and track_argpos:
        extras["argpos"] = torch.empty((3,) + plane_shape, dtype=dtype,
                                       device=dev)
    if log_hist:
        extras["hist"] = torch.empty((int(steps) + 1, 3) + plane_shape,
                                     dtype=dtype, device=dev)
        extras["nlive"] = torch.empty(plane_shape, dtype=torch.int32,
                                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        LAUNCHES += 1
        if route == "tc":
            TC_LAUNCHES += 1
        if program.pruned:
            PRUNE_LAUNCHES += 1
        if route == "tc" and not (track_min or extras):
            err = lib.rm_render_fwd_tc_f32(
                params_flat.data_ptr(), packed.data_ptr(), rays7.data_ptr(),
                out.data_ptr(), n, int(steps), consts_p, stream)
        elif track_min or extras:
            if route == "tc":
                fn = lib.rm_render_fwd_train_tc_f32
            else:
                fn = (lib.rm_render_fwd_train_f32 if f32
                      else lib.rm_render_fwd_train_f64)
            err = fn(params_flat.data_ptr(), _ptr(packed), rays7.data_ptr(),
                     out.data_ptr(), n, int(steps), consts_p, int(track_min),
                     _ptr(extras.get("amin")), _ptr(extras.get("argpos")),
                     _ptr(extras.get("hist")), _ptr(extras.get("nlive")),
                     stream)
        else:
            # The lane-refill kernel's slot counter: without one the kernel
            # marches one thread per ray.
            nxt = (torch.zeros(1, dtype=torch.int32, device=dev)
                   if uses_refill(program, dtype, tau, route) else None)
            fn = lib.rm_render_fwd_f32 if f32 else lib.rm_render_fwd_f64
            err = fn(params_flat.data_ptr(), _ptr(packed), rays7.data_ptr(),
                     out.data_ptr(), n, int(steps), consts_p, _ptr(nxt),
                     stream)
    if err != 0:
        raise RuntimeError(f"render_fwd kernel launch failed: cudaError {err}")
    return out, extras


class _FusedMarch(torch.autograd.Function):
    """Forward: the kernel's training configuration; backward: the backward
    kernel on the same MLP route (counterpart of the ``custom_vjp`` pairs
    ``_fwd``/``_bwd`` and ``_fwd_cov``/``_bwd_cov`` of the JAX package). The
    scene's matrices come last, so that autograd sees them."""

    @staticmethod
    def forward(ctx, params_flat, rays7, program, steps, tau, normals_eps,
                track_min, log_hist, two_level, *mats):
        route = mlp_route(program, rays7.dtype)
        out, extras = march_forward(
            program, params_flat, rays7, steps, tau, normals_eps,
            track_min=track_min, log_hist=log_hist, mats=mats, route=route)
        ctx.cfg = (program, steps, tau, normals_eps, track_min, log_hist,
                   two_level, route)
        saved = [params_flat, rays7, *mats]
        if log_hist:
            saved += [extras["hist"], extras["nlive"]]
            if track_min:
                saved += [out[8].clone(), extras["amin"]]
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from ray_marching_tpu_torch.ops.backward_kernel import fused_backward

        (program, steps, tau, normals_eps, track_min, log_hist,
         two_level, route) = ctx.cfg
        params_flat, rays7, *rest = ctx.saved_tensors
        mats, rest = rest[:program.n_mats], rest[program.n_mats:]
        handoff = {}
        if log_hist:
            handoff = dict(hist=rest[0], nlive=rest[1])
            if track_min:
                handoff.update(minf=rest[2], amin=rest[3])
        gflat, gmats, grays = fused_backward(
            program, params_flat, rays7, g.contiguous(), steps, tau,
            normals_eps, track_min=track_min, two_level=two_level, mats=mats,
            route=route, **handoff)
        return (gflat, grays, None, None, None, None, None, None, None,
                *gmats)


def _requires_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def hist_bytes(rays7, steps) -> int:
    """Bytes of the march history of a forward over ``rays7``:
    ``(steps + 1) · 3 · rows · 128 · itemsize``."""
    return ((int(steps) + 1) * 3 * rays7.shape[1] * LANES
            * rays7.element_size())


def hist_enabled(rays7, steps, bwd_hist=None, two_level=False) -> bool:
    """Whether a differentiated forward logs its march history for the
    backward kernel: ``bwd_hist`` (None: :data:`BWD_HIST`), unless the
    two-level backward engages (``two_level``, already decided) or the
    history would exceed ``RM_TPU_BWD_HIST_MAX`` bytes (read at each call,
    default :data:`HIST_MAX_DEFAULT`), which overrides even
    ``bwd_hist=True``; the backward then recomputes in bounded scratch.
    The rule of the JAX package's ``pallas_render._hist_enabled``, over the
    port's own rows (JAX counts rows padded to its tile). JAX's clause that
    turns the history off at tau != 0 with ``track_min`` is not carried
    over: it exists because a TPU tile shares one exit step, while the
    port's history keeps each ray's own, so neither is read here."""
    if two_level or not (BWD_HIST if bwd_hist is None else bool(bwd_hist)):
        return False
    cap = int(os.environ.get("RM_TPU_BWD_HIST_MAX", str(HIST_MAX_DEFAULT)))
    return hist_bytes(rays7, steps) <= cap


def _fused(program, params_flat, rays7, steps, tau, normals_eps, track_min,
           bwd_hist, bwd_two_level, mats):
    if _requires_grad(params_flat, rays7, *mats):
        from ray_marching_tpu_torch.ops.backward_kernel import (
            two_level_engages,
        )

        two_level = (
            (BWD_TWO_LEVEL if bwd_two_level is None else bool(bwd_two_level))
            and two_level_engages(steps, tau, track_min))
        log_hist = hist_enabled(rays7, steps, bwd_hist, two_level)
        return _FusedMarch.apply(params_flat, rays7, program, steps, tau,
                                 normals_eps, track_min, log_hist, two_level,
                                 *mats)
    return march_forward(program, params_flat, rays7, steps, tau,
                         normals_eps, track_min=track_min, mats=mats)[0]


def fused_march_normals(program: SdfProgram, params_flat, rays7, steps, tau,
                        normals_eps, bwd_hist=None, bwd_two_level=None,
                        mats=()):
    """rays7 (7, rows, 128) → (8, rows, 128): x y z d nx ny nz lap.

    ``program`` is the scene (:class:`scene.codegen.SdfProgram`),
    ``params_flat`` its flat parameter vector and ``mats`` its matrix
    parameters (:func:`ops.params.split_params_padded`). CPU tensors take
    the plain version; CUDA tensors launch the kernel. Differentiable in
    ``params_flat`` and ``rays7``; ``bwd_hist`` chooses between the history
    handoff and the backward kernel's recompute (see :data:`BWD_HIST` and
    :func:`hist_enabled`),
    ``bwd_two_level`` asks for the two-level backward (see
    :data:`BWD_TWO_LEVEL`)."""
    return _fused(program, params_flat, rays7, steps, tau, normals_eps, False,
                  bwd_hist, bwd_two_level, mats)


def fused_march_normals_cov(program: SdfProgram, params_flat, rays7, steps,
                            tau, normals_eps, bwd_hist=None,
                            bwd_two_level=None, mats=()):
    """Coverage variant: (9, rows, 128), the 8 planes of
    :func:`fused_march_normals` plus the along-ray closest approach
    ``min_f`` (plane 8), the carrier of silhouette gradients
    (render/silhouette.py). Its cotangent is routed to the arg-min march
    step inside the backward kernel, which needs every march position: the
    two-level backward never engages here."""
    return _fused(program, params_flat, rays7, steps, tau, normals_eps, True,
                  bwd_hist, bwd_two_level, mats)


class _MarchIFT(torch.autograd.Function):
    """A forward march, then an O(1) backward by the implicit function
    theorem (counterpart of ``fused_march_normals_ift`` / ``_cov_ift`` and
    of ``xla_march_normals_ift`` / ``_cov_ift`` of the JAX package, whose
    backward is tensor code outside any kernel too): no reverse sweep.
    Exact on converged rays; silhouette gradients differ from the unrolled
    backward. ``plain`` marches with :func:`_reference_march` (the XLA
    route, :mod:`.xla_render`), else with the kernel on :func:`mlp_route`,
    the tensor-core entries for a scene with a tensor-core leaf in f32: the
    backward differentiates that endpoint with plain torch."""

    @staticmethod
    def forward(ctx, params_flat, rays7, program, steps, tau, normals_eps,
                track_min, hit_threshold, denom_eps, plain, *mats):
        march = _reference_march if plain else march_forward
        out, extras = march(program, params_flat, rays7, steps, tau,
                            normals_eps, track_min=track_min,
                            track_argpos=track_min, mats=mats)
        ctx.cfg = (program, tau, normals_eps, hit_threshold, denom_eps)
        ctx.save_for_backward(params_flat, rays7, out.clone(), *mats,
                              *([extras["argpos"]] if track_min else []))
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        params_flat, rays7, out, *rest = ctx.saved_tensors
        n_mats = ctx.cfg[0].n_mats
        mats, argpos = rest[:n_mats], rest[n_mats:]
        gflat, gmats, grays = _ift_backward(
            *ctx.cfg, params_flat, rays7, out, g,
            argpos[0] if argpos else None, mats)
        return (gflat, grays, None, None, None, None, None, None, None, None,
                *gmats)


def _ift_backward(program, tau, normals_eps, hit_threshold, denom_eps,
                  params_flat, rays7, out, g, argpos, mats=()):
    """IFT routing at the fixed point (``_ift_bwd`` / ``_cov_ift_bwd`` of
    the JAX package): the tail's VJP into the endpoint, then
    ``w = −(g·v)/(∇f·v)`` on hit rays carries the endpoint cotangent to the
    parameters through one VJP of f; with ``argpos`` the ``min_f`` cotangent
    goes through f at the arg-min position, held fixed. Pad slots are left
    out before anything is evaluated. Returns ``(params_flat cotangent,
    matrix cotangents, rays7 cotangent)``."""
    sdf = program.sdf_c
    off, inv, lap_scale, _ = _plain_consts(rays7.dtype, tau, normals_eps)
    valid = (rays7[6] > 0.5).reshape(-1)
    pick = lambda plane: plane.reshape(-1)[valid].detach()  # noqa: E731
    px, py, pz, vx, vy, vz = (pick(rays7[i]) for i in range(6))
    gv = [pick(g[i]) for i in range(g.shape[0])]
    d_star = pick(out[3])
    leaves = [params_flat.detach().requires_grad_(True)] + [
        m.detach().requires_grad_(True) for m in mats]
    end = [pick(out[i]).requires_grad_(True) for i in range(3)]
    with torch.enable_grad():
        params = program.rebuild(leaves[0], leaves[1:])
        tail = _tail_planes(sdf, params, *end, off, inv, lap_scale)
        f = sdf(params, *end)

    def add_grad(total, outputs, cotangents, inputs=()):
        """``total`` plus the leaves' cotangents; and those of ``inputs``."""
        got = torch.autograd.grad(outputs, leaves + list(inputs), cotangents,
                                  allow_unused=True)
        return ([t if d is None else t + d
                 for t, d in zip(total, got)], got[len(leaves):])

    gtheta, (gx, gy, gz) = add_grad([torch.zeros_like(p) for p in leaves],
                                    tail, gv[3:8], end)
    gx, gy, gz = gx + gv[0], gy + gv[1], gz + gv[2]
    nfx, nfy, nfz = torch.autograd.grad(f, end, torch.ones_like(f),
                                        retain_graph=True)
    denom = vx * nfx + vy * nfy + vz * nfz
    safe = torch.where(denom.abs() < denom_eps,
                       torch.where(denom < 0, -denom_eps, denom_eps), denom)
    hit = d_star.abs() < hit_threshold
    w = torch.where(hit, -(gx * vx + gy * vy + gz * vz) / safe, 0.0)
    gtheta, _ = add_grad(gtheta, f, w)
    x, y, z = (e.detach() for e in end)
    t_star = (x - px) * vx + (y - py) * vy + (z - pz) * vz
    gp = [gx + nfx * w, gy + nfy * w, gz + nfz * w]
    planes = gp + [t_star * c for c in gp]
    if argpos is not None:
        pm = [pick(argpos[i]).requires_grad_(True) for i in range(3)]
        with torch.enable_grad():
            fm = sdf(params, *pm)
        gtheta, gm = add_grad(gtheta, fm, gv[8], pm)
        gm = list(gm)
        xm, ym, zm = (c.detach() for c in pm)
        t_m = (xm - px) * vx + (ym - py) * vy + (zm - pz) * vz
        planes = [a + b for a, b in zip(planes, gm + [t_m * c for c in gm])]
    grays = torch.zeros((7, valid.shape[0]), dtype=rays7.dtype,
                        device=rays7.device)
    for i, plane in enumerate(planes):
        grays[i, valid] = plane
    return (gtheta[0].detach(), tuple(t.detach() for t in gtheta[1:]),
            grays.reshape(rays7.shape))


def march_ift(program: SdfProgram, params_flat, rays7, steps, tau,
              normals_eps, hit_threshold, denom_eps, track_min, mats, plain):
    """The march of :class:`_MarchIFT`, differentiable when an input
    requires grad; ``plain`` takes :func:`_reference_march` for the kernel."""
    if _requires_grad(params_flat, rays7, *mats):
        return _MarchIFT.apply(params_flat, rays7, program, steps, tau,
                               normals_eps, track_min, hit_threshold,
                               denom_eps, plain, *mats)
    march = _reference_march if plain else march_forward
    return march(program, params_flat, rays7, steps, tau, normals_eps,
                 track_min=track_min, mats=mats)[0]


def fused_march_normals_ift(program: SdfProgram, params_flat, rays7, steps,
                            tau, normals_eps, hit_threshold=0.05,
                            denom_eps=1e-6, track_min=False, mats=()):
    """:func:`fused_march_normals` (``track_min``: ``_cov``) with the
    implicit-function-theorem backward: the forward kernel, then plain
    PyTorch at the endpoint; with ``track_min`` the ``min_f`` gradient takes
    the arg-min position (a further kernel output) as fixed. On a scene
    with a tensor-core leaf in f32 the gradient is that of the tensor-core
    endpoint (:class:`_MarchIFT`)."""
    return march_ift(program, params_flat, rays7, steps, tau, normals_eps,
                     hit_threshold, denom_eps, track_min, mats, plain=False)


def _tail_planes(sdf, params, x, y, z, offsets, inverse, lap_scale):
    """Terminal distance, normals and Laplacian at (x, y, z), unmasked."""
    d_centre = sdf(params, x, y, z)
    f = [sdf(params, x + offsets[i][0], y + offsets[i][1], z + offsets[i][2])
         for i in range(4)]
    d1, d2, d3 = f[1] - f[0], f[2] - f[0], f[3] - f[0]
    nx = inverse[0][0] * d1 + inverse[0][1] * d2 + inverse[0][2] * d3
    ny = inverse[1][0] * d1 + inverse[1][1] * d2 + inverse[1][2] * d3
    nz = inverse[2][0] * d1 + inverse[2][1] * d2 + inverse[2][2] * d3
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    mean4 = (f[0] + f[1] + f[2] + f[3]) * 0.25
    lap = (d_centre - mean4) * lap_scale
    return d_centre, nx / norm, ny / norm, nz / norm, lap


def _plain_consts(dtype, tau, normals_eps):
    """Offsets, inverse, 6/eps² and tau as python floats rounded to
    ``dtype`` (the values :func:`_host_consts` hands the kernel)."""
    c = _host_consts(dtype, tau, normals_eps)
    off = [[float(c[3 * i + j]) for j in range(3)] for i in range(4)]
    inv = [[float(c[12 + 3 * i + j]) for j in range(3)] for i in range(3)]
    return off, inv, float(c[21]), float(c[22])


def _reference_march(program, params_flat, rays7, steps, tau, normals_eps,
                     track_min=False, log_hist=False, track_argpos=False,
                     mats=(), remat=False):
    """The plain PyTorch version of :func:`march_forward`: plane-wise march
    + normals with the semantics of ``pallas_render._reference_fn``, and the
    training outputs as the kernel defines them (strict ``<`` updates of
    ``min_f``, so the first attaining step wins). ``remat`` runs each step
    under ``torch.utils.checkpoint``: autograd keeps each step's inputs (the
    position history) and recomputes the step's activations in the
    backward, with the same values and gradients (the XLA route,
    :mod:`.xla_render`)."""
    sdf = program.sdf_c
    params = program.rebuild(params_flat, mats)
    dx, dy, dz = (rays7[i] for i in range(3, 6))
    valid = rays7[6] > 0.5
    off, inv, lap_scale, tau_t = _plain_consts(rays7.dtype, tau, normals_eps)
    big = torch.finfo(rays7.dtype).max

    def step(s, x, y, z, minf, amin, xm, ym, zm, nlive):
        d = sdf(params, x, y, z)
        if track_min:
            take = (d < minf) & valid
            minf = torch.where(take, d, minf)
            amin = torch.where(take, s, amin)
            if track_argpos:
                xm, ym, zm = (torch.where(take, c, a)
                              for c, a in zip((x, y, z), (xm, ym, zm)))
        live = valid if tau_t == 0.0 else (torch.abs(d) >= tau_t) & valid
        return (torch.where(live, x + d * dx, x),
                torch.where(live, y + d * dy, y),
                torch.where(live, z + d * dz, z),
                minf, amin, xm, ym, zm, nlive + live.to(torch.int32))

    if remat:
        step = functools.partial(checkpoint, step, use_reentrant=False)

    x, y, z = (rays7[i] for i in range(3))
    amin = torch.full(x.shape, -1, dtype=torch.int32, device=x.device)
    carry = (x, y, z, torch.full_like(x, big), amin, x, y, z,
             torch.zeros_like(amin))
    hist = []
    for s in range(int(steps)):
        if log_hist:
            hist.append(torch.stack(carry[:3]))
        carry = step(s, *carry)
    x, y, z, minf, amin, xm, ym, zm, nlive = carry
    d_centre, nx, ny, nz, lap = _tail_planes(sdf, params, x, y, z, off, inv,
                                             lap_scale)
    planes = [x, y, z] + [torch.where(valid, v, 0.0)
                          for v in (d_centre, nx, ny, nz, lap)]
    if track_min:
        planes.append(minf)
    extras = {}
    if track_min and log_hist:
        extras["amin"] = amin
    if track_min and track_argpos:
        extras["argpos"] = torch.stack((xm, ym, zm))
    if log_hist:
        extras["hist"] = torch.stack(hist + [torch.stack((x, y, z))])
        extras["nlive"] = nlive
    return torch.stack(planes, dim=0), extras


def reference_march_normals(program: SdfProgram, params_flat, rays7, steps,
                            tau, normals_eps, mats=()):
    """The plain PyTorch version of the serving configuration."""
    return _reference_march(program, params_flat, rays7, steps, tau,
                            normals_eps, mats=mats)[0]


#: Ray-dependent operations per valid ray outside the SDF evaluations:
#: a march step is 3 mul + 3 add; the tail is 12 offset adds, 3 subs,
#: 9 mul + 6 add (3×3 inverse), 3 mul + 2 add + 1 sqrt (norm), 3 div,
#: 3 add + 1 mul (mean4), 1 sub + 1 mul (Laplacian).
OPS_PER_STEP = 6
OPS_TAIL = 12 + 3 + 15 + 6 + 3 + 4 + 2


def kernel_ops(program: SdfProgram, n_valid: int, steps: int) -> int:
    """Operations the kernel needs for ``n_valid`` rays that march ``steps``
    steps at tau = 0: (steps + 5) SDF evaluations plus the march and tail
    arithmetic, by the op-count convention of scene/codegen.py."""
    per_ray = ((steps + 5) * program.ops_per_eval
               + steps * OPS_PER_STEP + OPS_TAIL)
    return n_valid * per_ray
