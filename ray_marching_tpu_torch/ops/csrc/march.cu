// Sphere-trace march + terminal distance, for one scene whose SDF is
// generated into scene_sdf.cuh: the marcher of the modular pipeline
// (render/pipeline.py::Renderer with use_pallas=True).
//
// Replaces: ray_marching_tpu/ops/pallas_march.py::_march_kernel, launched
// there by _pallas_march_flat for pallas_march and
// pallas_march_with_distance.
//
// Contract: P the flat parameters, M the packed matrices of the scene's
// neural leaves (null for an analytic scene; neural.cuh evaluates them);
// rays (7, plane) = x y z dx dy dz valid; out (4, plane) =
// the marched x y z and the terminal distance. Invalid slots (valid <= 0.5)
// never evaluate the SDF: their position passes through and their distance
// is 0.
//
// Bound on an H100: operations. Per valid ray it runs steps + 1 scene SDF
// evaluations (65 ray-dependent operations each for test_scene2,
// scene/codegen.py counts them) and moves 44 bytes in f32 (7 planes read, 4
// written); PERF.md has the counted bound.
//
// Design: one thread per ray slot of the (rows, 128) planes, every plane
// access coalesced, the ray in registers through all steps; the loop is
// march_ray of march_loop.cuh, the one render_fwd.cu runs, so the 4 planes
// equal planes 0-3 of the fused kernel bit for bit. tau > 0: each ray leaves
// its loop on its own. march_tc_kernel (f32, a scene with a tensor-core MLP
// leaf, SCENE_TC) is the same march on neural.cuh's rm_mlp_tc: warp-masked
// (march_loop.cuh), an invalid slot evaluating at its unmoved position with
// its distance stored as 0; its 4 planes equal planes 0-3 of render_fwd.cu's
// render_fwd_tc_kernel bit for bit. A differentiated march takes the same
// entry: its backward (render_bwd.cu's TC march-only instantiation) marches
// again on the tensor cores and differentiates those positions.
// The TPU kernel's row tiles, its tile-wide while_loop
// and its VMEM budgets are not carried over. Built with --fmad=false and
// IEEE sqrt and division, like the other kernels, for op-for-op parity with
// the plain PyTorch version. A counted loop of the scene's SDF (the bulb's
// iterations) is unrolled by 5 here: rolled (1) this kernel measured 3.3 %
// slower than with the parent's unrolled SDF, by 5 0.6 % faster (PERF.md).
#include <cuda_runtime.h>

#define RM_SDF_LOOP_UNROLL 5
#include "march_loop.cuh"

template <typename T>
__global__ void __launch_bounds__(256)
march_kernel(const T* __restrict__ P, const T* __restrict__ M,
             const T* __restrict__ rays, T* __restrict__ out, long long plane,
             int steps, T tau) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  T x = rays[i];
  T y = rays[plane + i];
  T z = rays[2 * plane + i];
  T d = static_cast<T>(0);
  if (rays[6 * plane + i] > static_cast<T>(0.5)) {
    NoObserver none;
    march_ray<T>(P, M, x, y, z, rays[3 * plane + i], rays[4 * plane + i],
                 rays[5 * plane + i], steps, tau, none);
    d = scene_sdf<T>(P, M, x, y, z);
  }
  out[i] = x;
  out[plane + i] = y;
  out[2 * plane + i] = z;
  out[3 * plane + i] = d;
}

#ifdef SCENE_TC
__global__ void __launch_bounds__(128)
march_tc_kernel(const float* __restrict__ P, const float* __restrict__ M,
                const float* __restrict__ rays, float* __restrict__ out,
                long long plane, int steps, float tau) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float x = rays[i];
  float y = rays[plane + i];
  float z = rays[2 * plane + i];
  const bool valid = rays[6 * plane + i] > 0.5f;
  NoObserver none;
  march_ray<float, NoObserver, true>(P, M, x, y, z, rays[3 * plane + i],
                                     rays[4 * plane + i], rays[5 * plane + i],
                                     steps, tau, none, valid);
  const float d = scene_sdf<float, true>(P, M, x, y, z);
  out[i] = x;
  out[plane + i] = y;
  out[2 * plane + i] = z;
  out[3 * plane + i] = valid ? d : 0.0f;
}
#endif

template <typename T>
static int launch(const T* P, const T* M, const T* rays, T* out,
                  long long plane, int steps, double tau, void* stream) {
  const int block = 256;
  const long long grid = (plane + block - 1) / block;
  march_kernel<T><<<(unsigned int)grid, block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      P, M, rays, out, plane, steps, static_cast<T>(tau));
  return static_cast<int>(cudaGetLastError());
}

// Plain C interface (bound with ctypes). M is the packed matrix buffer, null
// for a scene without neural leaves. tau arrives as a double and is rounded
// to T here, to nearest, as the host rounds it for the other kernels.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rm_march_f32(const float* P, const float* M, const float* rays,
                            float* out, long long plane, int steps, double tau,
                            void* stream) {
  return launch<float>(P, M, rays, out, plane, steps, tau, stream);
}

extern "C" int rm_march_f64(const double* P, const double* M,
                            const double* rays, double* out, long long plane,
                            int steps, double tau, void* stream) {
  return launch<double>(P, M, rays, out, plane, steps, tau, stream);
}

#ifdef SCENE_TC
// The march on the tensor cores, f32: M is the packed matrix buffer followed
// by the tensor-core fragments (ops/params.py tc_fragments); plane a
// multiple of 128.
extern "C" int rm_march_tc_f32(const float* P, const float* M,
                               const float* rays, float* out, long long plane,
                               int steps, double tau, void* stream) {
  const int block = 128;
  march_tc_kernel<<<(unsigned int)(plane / block), block, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      P, M, rays, out, plane, steps, static_cast<float>(tau));
  return static_cast<int>(cudaGetLastError());
}
#endif
