// Fused sphere-trace march + terminal distance + tetrahedral normals +
// Laplacian, for one scene whose SDF is generated into scene_sdf.cuh.
//
// Replaces: ray_marching_tpu/ops/pallas_render.py::_render_kernel (the
// forward configuration: track_min=False, log_hist=False, dual=False),
// launched there by _call_render_kernel for fused_march_normals.
//
// Contract: rays (7, plane) = x y z dx dy dz valid; out (8, plane) =
// x y z d nx ny nz lap (pallas_render.py:318-330). Invalid slots
// (valid <= 0.5) do not move and get d = normals = lap = 0.
//
// Bound on an H100: compute. Per valid ray it runs 37 scene SDF
// evaluations (steps march evaluations, the terminal one and 4 offsets) and
// moves 60 bytes in f32 (7 planes read, 8 written). test_scene2 costs 65
// ray-dependent operations per evaluation (scene/codegen.py counts them),
// about 2,600 per ray in all, so the operations outweigh the bytes (PERF.md
// has the counted bound: 0.082 ms of operations against 0.038 ms of bytes at
// 1080p on an H100 SXM).
//
// Design: one thread per ray slot of the (rows, 128) planes, so every
// plane load and store is coalesced. Position, direction and validity stay
// in registers through all steps; the SDF is inlined straight-line code
// whose parameters are read through a runtime pointer (new parameter values
// never rebuild). tau > 0: a ray breaks out of its loop once |d| < tau,
// which gives exactly the masked march of the JAX kernel, where a frozen ray
// re-evaluates the same position. The TPU kernel's 64-row tiles, EXIT_SEG
// segments and static unroll are not carried over.
//
// Parity traps, kept deliberately:
//  - min/max/clamp/relu are selects (sdf_prims.cuh), not fminf/fmaxf;
//  - built with --fmad=false and without --use_fast_math: no contraction
//    into FMA, IEEE sqrt and division, so the kernel matches the plain
//    PyTorch version op for op;
//  - constants are rounded to T once on the host, like the JAX kernel's
//    numpy constants (pallas_render.py:365): the offsets and the 3x3
//    inverse from make_offsets, 6/eps^2, tau; 0.25 is exact;
//  - evaluation order follows JAX: mean4 = ((f0 + f1) + f2) + f3, 3-term
//    dot products left to right, x + d * dx;
//  - the freeze test is !(|d| >= tau), so a NaN distance freezes the ray as
//    jnp.abs(d) >= tau does.
#include <cuda_runtime.h>

#include "sdf_prims.cuh"
#include "scene_sdf.cuh"

template <typename T>
struct RenderConsts {
  T off[4][3];  // tetrahedral offsets, scaled by normals_eps
  T inv[3][3];  // inverse of the relative-offset matrix
  T lap_scale;  // 6 / eps^2
  T tau;        // early-exit threshold (0: march every step)
};

template <typename T>
__global__ void __launch_bounds__(256)
render_fwd_kernel(const T* __restrict__ P, const T* __restrict__ rays,
                  T* __restrict__ out, long long plane, int steps,
                  RenderConsts<T> c) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  T x = rays[i];
  T y = rays[plane + i];
  T z = rays[2 * plane + i];
  const T zero = static_cast<T>(0);
  if (!(rays[6 * plane + i] > static_cast<T>(0.5))) {
    out[i] = x;
    out[plane + i] = y;
    out[2 * plane + i] = z;
    for (int k = 3; k < 8; ++k) out[k * plane + i] = zero;
    return;
  }
  const T dx = rays[3 * plane + i];
  const T dy = rays[4 * plane + i];
  const T dz = rays[5 * plane + i];
  const bool freeze = c.tau != zero;
  for (int s = 0; s < steps; ++s) {
    const T d = scene_sdf<T>(P, x, y, z);
    if (freeze && !(rm_abs(d) >= c.tau)) break;
    x = x + d * dx;
    y = y + d * dy;
    z = z + d * dz;
  }
  const T d_centre = scene_sdf<T>(P, x, y, z);
  T f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = scene_sdf<T>(P, x + c.off[k][0], y + c.off[k][1], z + c.off[k][2]);
  }
  const T d1 = f[1] - f[0];
  const T d2 = f[2] - f[0];
  const T d3 = f[3] - f[0];
  const T nx = c.inv[0][0] * d1 + c.inv[0][1] * d2 + c.inv[0][2] * d3;
  const T ny = c.inv[1][0] * d1 + c.inv[1][1] * d2 + c.inv[1][2] * d3;
  const T nz = c.inv[2][0] * d1 + c.inv[2][1] * d2 + c.inv[2][2] * d3;
  const T norm = rm_sqrt(nx * nx + ny * ny + nz * nz);
  const T mean4 = (f[0] + f[1] + f[2] + f[3]) * static_cast<T>(0.25);
  out[i] = x;
  out[plane + i] = y;
  out[2 * plane + i] = z;
  out[3 * plane + i] = d_centre;
  out[4 * plane + i] = nx / norm;
  out[5 * plane + i] = ny / norm;
  out[6 * plane + i] = nz / norm;
  out[7 * plane + i] = (d_centre - mean4) * c.lap_scale;
}

template <typename T>
static int launch(const T* P, const T* rays, T* out, long long plane,
                  int steps, const T* host_consts, void* stream) {
  RenderConsts<T> c;
  for (int k = 0; k < 12; ++k) c.off[k / 3][k % 3] = host_consts[k];
  for (int k = 0; k < 9; ++k) c.inv[k / 3][k % 3] = host_consts[12 + k];
  c.lap_scale = host_consts[21];
  c.tau = host_consts[22];
  const int block = 256;
  const long long grid = (plane + block - 1) / block;
  render_fwd_kernel<T><<<(unsigned int)grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      P, rays, out, plane, steps, c);
  return static_cast<int>(cudaGetLastError());
}

// Plain C interface (bound with ctypes). host_consts: 23 values of T on the
// host: offsets (4x3, row-major), inverse (3x3), 6/eps^2, tau. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rm_render_fwd_f32(const float* P, const float* rays, float* out,
                                 long long plane, int steps,
                                 const float* host_consts, void* stream) {
  return launch<float>(P, rays, out, plane, steps, host_consts, stream);
}

extern "C" int rm_render_fwd_f64(const double* P, const double* rays,
                                 double* out, long long plane, int steps,
                                 const double* host_consts, void* stream) {
  return launch<double>(P, rays, out, plane, steps, host_consts, stream);
}
