// Fused sphere-trace march + terminal distance + tetrahedral normals +
// Laplacian, for one scene whose SDF is generated into scene_sdf.cuh.
//
// Replaces: ray_marching_tpu/ops/pallas_render.py::_render_kernel, launched
// there by _call_render_kernel for fused_march_normals (and _cov, _ift,
// _cov_ift). Two kernels: render_fwd_kernel is the serving configuration
// (track_min=False, log_hist=False); render_fwd_train_kernel adds the
// outputs a differentiated forward hands to the backward kernel
// (render_bwd.cu). The dual branch is not carried over.
//
// Contract: P the flat parameters, M the packed matrices of the scene's
// neural leaves (null for an analytic scene; neural.cuh evaluates them);
// rays (7, plane) = x y z dx dy dz valid; out (8, plane) =
// x y z d nx ny nz lap (pallas_render.py:318-330). Invalid slots
// (valid <= 0.5) do not move and get d = normals = lap = 0.
//
// Training outputs, each optional (a null pointer leaves it out):
//  - min_f, plane 8 of out: the least distance over the march's pre-step
//    evaluations (not the terminal one); pad slots get the largest finite T;
//  - amin (int32 plane): the first step that attains min_f (strict "<"
//    updates), -1 if none did;
//  - argpos (3 planes): the position at that step;
//  - hist (steps + 1, 3, plane), plane-major so that every store is
//    coalesced: the position before each step and, at [steps], the terminal
//    one. With tau > 0 a ray writes only the steps it ran; the rest of its
//    column stays unwritten;
//  - nlive (int32 plane): the number of steps the ray moved (steps at
//    tau = 0). It takes the place of the TPU kernel's per-tile exit step:
//    rays break out one by one here.
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
// re-evaluates the same position. The loop itself is march_ray of
// march_loop.cuh, shared with march.cu and render_bwd.cu. The TPU kernel's
// 64-row tiles, EXIT_SEG segments and static unroll are not carried over.
//
// Tensor cores (render_fwd_tc_kernel, f32, built for a scene with a
// tensor-core MLP leaf, SCENE_TC): the serving configuration with the MLP
// of neural.cuh's rm_mlp_tc, 128-thread blocks. mma.sync needs the warp's 32
// lanes converged, so nothing breaks out per lane: the march is the
// warp-masked one of march_loop.cuh, an invalid slot evaluates at its unmoved
// position with its stores masked (its outputs are the per-thread kernel's:
// the position, zeros), and the normals tail runs on every lane. Its planes
// are within the f32 tolerance of the per-thread kernel, not equal to it;
// march.cu's march_tc_kernel gives its planes 0-3 bit for bit. The training
// kernel keeps the per-thread MLP (its history must equal the backward's
// recompute bit for bit).
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

#include <limits>

#include "march_loop.cuh"
#include "render_consts.cuh"

template <typename T>
struct TrainOuts {
  T* minf;     // plane 8 of out, or null
  int* amin;   // or null
  T* argpos;   // (3, plane), or null
  T* hist;     // (steps + 1, 3, plane), or null
  int* nlive;  // or null
};

// The outputs of an invalid slot: its position, zeros.
template <typename T>
__device__ __forceinline__ void store_pad(T* __restrict__ out,
                                          long long plane, long long i, T x,
                                          T y, T z) {
  out[i] = x;
  out[plane + i] = y;
  out[2 * plane + i] = z;
  for (int k = 3; k < 8; ++k) out[k * plane + i] = static_cast<T>(0);
}

// Terminal distance, tetrahedral normals and Laplacian at (x, y, z):
// planes 0..7 of out. TC: every lane evaluates, an invalid one stores the
// pad outputs.
template <typename T, bool TC = false>
__device__ __forceinline__ void store_hit(const T* __restrict__ P,
                                          const T* __restrict__ M,
                                          T* __restrict__ out, long long plane,
                                          long long i, T x, T y, T z,
                                          const RenderConsts<T>& c,
                                          bool valid = true) {
  const T d_centre = march_sdf<T, TC>(P, M, x, y, z);
  T f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = march_sdf<T, TC>(P, M, x + c.off[k][0], y + c.off[k][1],
                            z + c.off[k][2]);
  }
  if (!valid) {
    store_pad<T>(out, plane, i, x, y, z);
    return;
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
__global__ void __launch_bounds__(256)
render_fwd_kernel(const T* __restrict__ P, const T* __restrict__ M,
                  const T* __restrict__ rays,
                  T* __restrict__ out, long long plane, int steps,
                  RenderConsts<T> c) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  T x = rays[i];
  T y = rays[plane + i];
  T z = rays[2 * plane + i];
  if (!(rays[6 * plane + i] > static_cast<T>(0.5))) {
    store_pad<T>(out, plane, i, x, y, z);
    return;
  }
  const T dx = rays[3 * plane + i];
  const T dy = rays[4 * plane + i];
  const T dz = rays[5 * plane + i];
  NoObserver none;
  march_ray<T>(P, M, x, y, z, dx, dy, dz, steps, c.tau, none);
  store_hit<T>(P, M, out, plane, i, x, y, z, c);
}

#ifdef SCENE_TC
// The serving configuration on the tensor cores; every ray slot of a warp
// takes part in every evaluation (plane is a multiple of 128).
__global__ void __launch_bounds__(128)
render_fwd_tc_kernel(const float* __restrict__ P, const float* __restrict__ M,
                     const float* __restrict__ rays, float* __restrict__ out,
                     long long plane, int steps, RenderConsts<float> c) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float x = rays[i];
  float y = rays[plane + i];
  float z = rays[2 * plane + i];
  const bool valid = rays[6 * plane + i] > 0.5f;
  NoObserver none;
  march_ray<float, NoObserver, true>(P, M, x, y, z, rays[3 * plane + i],
                                     rays[4 * plane + i], rays[5 * plane + i],
                                     steps, c.tau, none, valid);
  store_hit<float, true>(P, M, out, plane, i, x, y, z, c, valid);
}
#endif

template <typename T>
__global__ void __launch_bounds__(256)
render_fwd_train_kernel(const T* __restrict__ P, const T* __restrict__ M,
                        const T* __restrict__ rays,
                        T* __restrict__ out, long long plane, int steps,
                        RenderConsts<T> c, T big, TrainOuts<T> t) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  T x = rays[i];
  T y = rays[plane + i];
  T z = rays[2 * plane + i];
  const long long p3 = 3 * plane;
  if (!(rays[6 * plane + i] > static_cast<T>(0.5))) {
    store_pad<T>(out, plane, i, x, y, z);
    if (t.minf) t.minf[i] = big;
    if (t.amin) t.amin[i] = -1;
    if (t.argpos) {
      t.argpos[i] = x;
      t.argpos[plane + i] = y;
      t.argpos[2 * plane + i] = z;
    }
    if (t.hist) {
      T* h = t.hist + (long long)steps * p3;
      h[i] = x;
      h[plane + i] = y;
      h[2 * plane + i] = z;
    }
    if (t.nlive) t.nlive[i] = 0;
    return;
  }
  const T dx = rays[3 * plane + i];
  const T dy = rays[4 * plane + i];
  const T dz = rays[5 * plane + i];
  HistoryObserver<T, true> seen = {t.hist, plane, i, big, -1, x, y, z};
  const int s = march_ray<T>(P, M, x, y, z, dx, dy, dz, steps, c.tau, seen);
  if (t.minf) t.minf[i] = seen.minf;
  if (t.amin) t.amin[i] = seen.amin;
  if (t.argpos) {
    t.argpos[i] = seen.ax;
    t.argpos[plane + i] = seen.ay;
    t.argpos[2 * plane + i] = seen.az;
  }
  if (t.hist) {
    T* h = t.hist + (long long)steps * p3;
    h[i] = x;
    h[plane + i] = y;
    h[2 * plane + i] = z;
  }
  if (t.nlive) t.nlive[i] = s;
  store_hit<T>(P, M, out, plane, i, x, y, z, c);
}

template <typename T>
static int launch(const T* P, const T* M, const T* rays, T* out,
                  long long plane, int steps, const T* host_consts,
                  void* stream) {
  const RenderConsts<T> c = unpack_consts<T>(host_consts);
  const int block = 256;
  const long long grid = (plane + block - 1) / block;
  render_fwd_kernel<T><<<(unsigned int)grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      P, M, rays, out, plane, steps, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_train(const T* P, const T* M, const T* rays, T* out,
                        long long plane, int steps, const T* host_consts,
                        int track_min,
                        int* amin, T* argpos, T* hist, int* nlive,
                        void* stream) {
  const RenderConsts<T> c = unpack_consts<T>(host_consts);
  TrainOuts<T> t;
  t.minf = track_min ? out + 8 * plane : nullptr;
  t.amin = amin;
  t.argpos = argpos;
  t.hist = hist;
  t.nlive = nlive;
  const int block = 256;
  const long long grid = (plane + block - 1) / block;
  render_fwd_train_kernel<T><<<(unsigned int)grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      P, M, rays, out, plane, steps, c, std::numeric_limits<T>::max(), t);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SCENE_TC
static int launch_tc(const float* P, const float* M, const float* rays,
                     float* out, long long plane, int steps,
                     const float* host_consts, void* stream) {
  const RenderConsts<float> c = unpack_consts<float>(host_consts);
  const int block = 128;
  render_fwd_tc_kernel<<<(unsigned int)(plane / block), block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      P, M, rays, out, plane, steps, c);
  return static_cast<int>(cudaGetLastError());
}
#endif

// Plain C interface (bound with ctypes). M is the packed matrix buffer, null
// for a scene without neural leaves. host_consts: 23 values of T on the
// host: offsets (4x3, row-major), inverse (3x3), 6/eps^2, tau. Returns the
// cudaError_t of the launch (0 on success). The training entry points take
// out with 9 planes when track_min is set, and a null pointer for each extra
// output that is not wanted.
extern "C" int rm_render_fwd_f32(const float* P, const float* M,
                                 const float* rays, float* out,
                                 long long plane, int steps,
                                 const float* host_consts, void* stream) {
  return launch<float>(P, M, rays, out, plane, steps, host_consts, stream);
}

extern "C" int rm_render_fwd_f64(const double* P, const double* M,
                                 const double* rays, double* out,
                                 long long plane, int steps,
                                 const double* host_consts, void* stream) {
  return launch<double>(P, M, rays, out, plane, steps, host_consts, stream);
}

extern "C" int rm_render_fwd_train_f32(const float* P, const float* M,
                                       const float* rays, float* out,
                                       long long plane, int steps,
                                       const float* host_consts, int track_min,
                                       int* amin, float* argpos, float* hist,
                                       int* nlive, void* stream) {
  return launch_train<float>(P, M, rays, out, plane, steps, host_consts,
                             track_min, amin, argpos, hist, nlive, stream);
}

extern "C" int rm_render_fwd_train_f64(const double* P, const double* M,
                                       const double* rays, double* out,
                                       long long plane, int steps,
                                       const double* host_consts,
                                       int track_min, int* amin, double* argpos,
                                       double* hist, int* nlive,
                                       void* stream) {
  return launch_train<double>(P, M, rays, out, plane, steps, host_consts,
                              track_min, amin, argpos, hist, nlive, stream);
}

#ifdef SCENE_TC
// The serving configuration on the tensor cores, f32: M is the packed matrix
// buffer followed by the tensor-core fragments (ops/params.py tc_fragments);
// plane a multiple of 128.
extern "C" int rm_render_fwd_tc_f32(const float* P, const float* M,
                                    const float* rays, float* out,
                                    long long plane, int steps,
                                    const float* host_consts, void* stream) {
  return launch_tc(P, M, rays, out, plane, steps, host_consts, stream);
}
#endif
