"""Fused march + normals + Laplacian: the CUDA kernel, its build and binding,
and its plain PyTorch version.

Counterpart of ``ray_marching_tpu/ops/pallas_render.py`` (forward
configuration of ``_render_kernel``; ``fused_march_normals`` there, and
``_reference_fn`` for the plain version). The kernel source is
``csrc/render_fwd.cu``; the scene's SDF is generated per scene by
:mod:`ray_marching_tpu_torch.scene.codegen` and included into it.

Build: ``nvcc`` compiles one shared library with a plain C interface per
scene, at first use, into ``_build/<hash>/`` beside this module (the hash
covers the generated SDF, the kernel sources and the flags), and ctypes
binds it. Launches go on the current CUDA stream and allocate nothing
inside the kernel; the wrapper allocates the output.

:func:`fused_march_normals` takes the plain version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises; it never falls back.
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

from ray_marching_tpu_torch.render.normals import make_offsets
from ray_marching_tpu_torch.scene.codegen import SdfProgram

LANES = 128
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("render_fwd.cu", "sdf_prims.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    # Op-for-op parity with the plain version: no FMA contraction, and no
    # --use_fast_math (IEEE sqrt and division).
    "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

#: Kernel launches so far (the wrapper adds one per launch, nowhere else).
LAUNCHES = 0
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


def kernel_key(program: SdfProgram) -> str:
    """Hash of everything the scene's library is built from."""
    h = hashlib.sha256(program.cuda_source().encode())
    for name in KERNEL_SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(key: str) -> Path:
    return BUILD_DIR / key / "librender_fwd.so"


def build_kernels(programs) -> None:
    """Build the libraries of ``programs`` that are not built yet, all nvcc
    processes started together; record their output in :data:`BUILD_LOG`."""
    pending = {}
    for program in programs:
        key = kernel_key(program)
        if key not in pending and not _lib_path(key).exists():
            pending[key] = program
    procs = []
    try:
        for key, program in pending.items():
            out_dir = BUILD_DIR / key
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / "scene_sdf.cuh").write_text(program.cuda_source())
            tmp = out_dir / f"librender_fwd.so.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(out_dir),
                   "-o", str(tmp), str(CSRC / "render_fwd.cu")]
            procs.append((key, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for key, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[key] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for kernel {key}:\n{log}")
            os.replace(tmp, _lib_path(key))
    finally:
        for _, _, proc in procs:
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
        for name in ("rm_render_fwd_f32", "rm_render_fwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
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


def _check(program, params_flat, rays7, steps):
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


def fused_march_normals(program: SdfProgram, params_flat, rays7, steps, tau,
                        normals_eps):
    """rays7 (7, rows, 128) → (8, rows, 128): x y z d nx ny nz lap.

    ``program`` is the scene (:class:`scene.codegen.SdfProgram`),
    ``params_flat`` its flat parameter vector
    (:func:`ops.params.split_params_padded`). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global LAUNCHES
    _check(program, params_flat, rays7, steps)
    if rays7.device.type == "cpu":
        return reference_march_normals(program, params_flat, rays7, steps,
                                       tau, normals_eps)
    if rays7.device.type != "cuda":
        raise ValueError(f"unsupported device {rays7.device}")
    if not (rays7.is_contiguous() and params_flat.is_contiguous()):
        raise ValueError("rays7 and params_flat must be contiguous")
    lib = _load(program)
    out = torch.empty((8,) + tuple(rays7.shape[1:]), dtype=rays7.dtype,
                      device=rays7.device)
    consts = _host_consts(rays7.dtype, tau, normals_eps)
    fn = (lib.rm_render_fwd_f32 if rays7.dtype == torch.float32
          else lib.rm_render_fwd_f64)
    with torch.cuda.device(rays7.device):
        stream = torch.cuda.current_stream(rays7.device).cuda_stream
        LAUNCHES += 1
        err = fn(params_flat.data_ptr(), rays7.data_ptr(), out.data_ptr(),
                 rays7.shape[1] * LANES, int(steps),
                 consts.ctypes.data_as(ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"render_fwd kernel launch failed: cudaError {err}")
    return out


def reference_march_normals(program: SdfProgram, params_flat, rays7, steps,
                            tau, normals_eps):
    """The plain PyTorch version: plane-wise march + normals with the
    semantics of ``pallas_render._reference_fn`` (forward only)."""
    npd = _np_dtype(rays7.dtype)
    sdf = program.sdf_c
    params = program.rebuild(params_flat)
    x, y, z, dx, dy, dz = (rays7[i] for i in range(6))
    valid = rays7[6] > 0.5
    offsets, inverse = make_offsets(normals_eps, np_dtype=npd)
    off = [[float(v) for v in row] for row in offsets]
    inv = [[float(v) for v in row] for row in inverse]
    tau_t = float(npd(tau))
    for _ in range(int(steps)):
        d = sdf(params, x, y, z)
        live = valid if tau_t == 0.0 else (torch.abs(d) >= tau_t) & valid
        x = torch.where(live, x + d * dx, x)
        y = torch.where(live, y + d * dy, y)
        z = torch.where(live, z + d * dz, z)
    d_centre = torch.where(valid, sdf(params, x, y, z), 0.0)
    f = [sdf(params, x + off[i][0], y + off[i][1], z + off[i][2])
         for i in range(4)]
    d1, d2, d3 = f[1] - f[0], f[2] - f[0], f[3] - f[0]
    nx = inv[0][0] * d1 + inv[0][1] * d2 + inv[0][2] * d3
    ny = inv[1][0] * d1 + inv[1][1] * d2 + inv[1][2] * d3
    nz = inv[2][0] * d1 + inv[2][1] * d2 + inv[2][2] * d3
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    mean4 = (f[0] + f[1] + f[2] + f[3]) * 0.25
    lap = (d_centre - mean4) * float(npd(6.0 / normals_eps**2))
    planes = [x, y, z, d_centre] + [
        torch.where(valid, v, 0.0) for v in (nx / norm, ny / norm, nz / norm, lap)
    ]
    return torch.stack(planes, dim=0)


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
