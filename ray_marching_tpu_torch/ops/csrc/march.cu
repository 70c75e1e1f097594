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
// Bound on an H100: operations. Per valid ray it runs one scene SDF
// evaluation per step it moves and one more (65 ray-dependent operations
// each for test_scene2, scene/codegen.py counts them) and moves 44 bytes in
// f32 (7 planes read, 4 written); PERF.md has the counted bound.
//
// Design: one thread per ray slot of the (rows, 128) planes (march_kernel),
// every plane access coalesced, the ray in registers through all steps; the
// loop is march_ray of march_loop.cuh, the one render_fwd.cu runs, so the 4
// planes equal planes 0-3 of the fused kernel bit for bit. tau > 0: each ray
// leaves its loop on its own, and a ray that froze keeps the distance that
// froze it as its terminal distance (march_kernel<T, true>): the evaluation
// at the terminal position would repeat it op for op on the same inputs, so
// it gives the same bits. A warp then runs until its slowest ray stops while
// the lanes of the others idle (on the bulb at 1440x900, 64 steps, tau =
// 1e-4, warps of 32 slots use 74 % of their lanes' evaluations; PERF.md).
// For an SDF expensive enough (the caller decides, ops/march_kernel.py) the
// march at tau > 0 refills lanes (march_refill_kernel): persistent warps
// take ray slots from a global counter, one warp-aggregated atomicAdd per
// refill, as render_fwd.cu's render_fwd_refill_kernel does, and each lane
// holds one state: march step k of its ray, or its terminal evaluation
// (k == steps). Every pass evaluates the SDF once on every lane, at its
// ray's position, so the SDF call is uniform across the warp and only the
// bookkeeping diverges. A ray that freezes stores its position and the
// distance that froze it and takes the next slot; one that ran every step
// takes one more pass for its terminal distance; a pad slot is stored at
// once. Each ray sees march_step's op sequence, so the planes are
// march_kernel's bit for bit. The analytic scenes keep march_kernel: on a
// 65-op SDF the march is close to issue-bound, not idle-bound, and refill
// measured 1.56x slower at tau = 1e-3 (PERF.md).
//
// march_tc_kernel (f32, a scene with a tensor-core MLP leaf, SCENE_TC) is
// the same march on neural.cuh's rm_mlp_tc: warp-masked (march_loop.cuh),
// an invalid slot evaluating at its unmoved position with its distance
// stored as 0; its 4 planes equal planes 0-3 of render_fwd.cu's
// render_fwd_tc_kernel bit for bit. A differentiated march takes the same
// entry: its backward (render_bwd.cu's TC march-only instantiation) marches
// again on the tensor cores and differentiates those positions.
// The TPU kernel's row tiles, its tile-wide while_loop
// and its VMEM budgets are not carried over. Built with --fmad=false and
// IEEE sqrt and division, like the other kernels, for op-for-op parity with
// the plain PyTorch version. A counted loop of the scene's SDF (the bulb's
// iterations) is unrolled by 5 here, for both kernels: rolled (1)
// march_kernel measured 3.3 % slower than with the unrolled SDF, by 5 0.6 %
// faster, and march_refill_kernel rolled 1.6 % slower than by 5 (PERF.md).
#include <cuda_runtime.h>

#define RM_SDF_LOOP_UNROLL 5
#include "march_loop.cuh"

constexpr int MARCH_REFILL_BLOCK = 128;

// Keeps the distance of the last step march_ray ran.
template <typename T>
struct LastDistance {
  T d;
  __device__ __forceinline__ void operator()(int, T, T, T, T dd) { d = dd; }
};

template <typename T>
__device__ __forceinline__ void store_march(T* __restrict__ out,
                                            long long plane, long long i, T x,
                                            T y, T z, T d) {
  out[i] = x;
  out[plane + i] = y;
  out[2 * plane + i] = z;
  out[3 * plane + i] = d;
}

// KEEP_FREEZE (tau > 0): a ray that froze keeps its last evaluation as its
// terminal distance. At tau = 0 no ray freezes, and the observer that keeps
// it would cost a move a step (0.6-1.4 %, PERF.md).
template <typename T, bool KEEP_FREEZE>
__global__ void __launch_bounds__(256)
march_kernel(const T* __restrict__ P, const T* __restrict__ M,
             const T* __restrict__ rays, T* __restrict__ out, long long plane,
             int steps, T tau) {
  P = scene_params(P);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  T x = rays[i];
  T y = rays[plane + i];
  T z = rays[2 * plane + i];
  T d = static_cast<T>(0);
  if (rays[6 * plane + i] > static_cast<T>(0.5)) {
    const T vx = rays[3 * plane + i];
    const T vy = rays[4 * plane + i];
    const T vz = rays[5 * plane + i];
    if constexpr (KEEP_FREEZE) {
      LastDistance<T> last = {d};
      const int s = march_ray<T>(P, M, x, y, z, vx, vy, vz, steps, tau, last);
      // Fewer moves than steps: the ray froze at its last evaluation.
      d = s < steps ? last.d : scene_sdf<T>(P, M, x, y, z);
    } else {
      NoObserver none;
      march_ray<T>(P, M, x, y, z, vx, vy, vz, steps, tau, none);
      d = scene_sdf<T>(P, M, x, y, z);
    }
  }
  store_march<T>(out, plane, i, x, y, z, d);
}

template <typename T>
__global__ void __launch_bounds__(MARCH_REFILL_BLOCK)
march_refill_kernel(const T* __restrict__ P, const T* __restrict__ M,
                    const T* __restrict__ rays, T* __restrict__ out,
                    long long plane, int steps, T tau,
                    unsigned int* __restrict__ next) {
  P = scene_params(P);
  const unsigned full = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  long long i = -1;   // the lane's ray slot; -1: it needs one
  bool done = false;  // no slot is left for the lane
  T x = static_cast<T>(0), y = x, z = x, dx = x, dy = x, dz = x;
  int k = 0;  // march step; steps: the terminal evaluation
  for (;;) {
    // Lanes without a ray take the next slots; a pad slot is stored at once
    // and its lane asks again.
    for (;;) {
      const bool want = i < 0 && !done;
      const unsigned need = __ballot_sync(full, want);
      if (!need) break;
      const int leader = __ffs(need) - 1;
      unsigned int base = 0;
      if (lane == leader) base = atomicAdd(next, __popc(need));
      base = __shfl_sync(full, base, leader);
      if (want) {
        const long long s =
            (long long)base + __popc(need & ((1u << lane) - 1u));
        if (s >= plane) {
          done = true;
        } else {
          x = rays[s];
          y = rays[plane + s];
          z = rays[2 * plane + s];
          if (rays[6 * plane + s] > static_cast<T>(0.5)) {
            i = s;
            dx = rays[3 * plane + s];
            dy = rays[4 * plane + s];
            dz = rays[5 * plane + s];
            k = 0;
          } else {
            store_march<T>(out, plane, s, x, y, z, static_cast<T>(0));
          }
        }
      }
    }
    if (__all_sync(full, done)) break;
    const T d = march_sdf<T, false>(P, M, x, y, z);
    if (done) continue;
    if (k == steps) {
      store_march<T>(out, plane, i, x, y, z, d);
      i = -1;
    } else if (march_step(x, y, z, dx, dy, dz, d, tau)) {
      ++k;
    } else {
      store_march<T>(out, plane, i, x, y, z, d);
      i = -1;
    }
  }
}

#ifdef SCENE_TC
__global__ void __launch_bounds__(128)
march_tc_kernel(const float* __restrict__ P, const float* __restrict__ M,
                const float* __restrict__ rays, float* __restrict__ out,
                long long plane, int steps, float tau) {
  P = scene_params(P);
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

// Lane refill at tau > 0 when the caller hands a zeroed counter (next),
// else one thread per ray slot. At tau = 0 every ray marches every step and
// the bookkeeping would only cost time.
template <typename T>
static int launch(const T* P, const T* M, const T* rays, T* out,
                  long long plane, int steps, double tau, unsigned int* next,
                  void* stream) {
  const T t = static_cast<T>(tau);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t != static_cast<T>(0) && next != nullptr) {
    // Persistent blocks: as many as the SMs hold at the kernel's occupancy,
    // and no more than the slots need.
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, march_refill_kernel<T>, MARCH_REFILL_BLOCK, 0);
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long need =
        (plane + MARCH_REFILL_BLOCK - 1) / MARCH_REFILL_BLOCK;
    if (grid > need) grid = need;
    if (grid < 1) grid = 1;
    return static_cast<int>(rm_launch_with_params(P, st, [&] {
      march_refill_kernel<T><<<(unsigned int)grid, MARCH_REFILL_BLOCK, 0,
                               st>>>(P, M, rays, out, plane, steps, t, next);
      return cudaGetLastError();
    }));
  }
  const int block = 256;
  const unsigned int grid = (unsigned int)((plane + block - 1) / block);
  return static_cast<int>(rm_launch_with_params(P, st, [&] {
    if (t != static_cast<T>(0)) {
      march_kernel<T, true><<<grid, block, 0, st>>>(P, M, rays, out, plane,
                                                    steps, t);
    } else {
      march_kernel<T, false><<<grid, block, 0, st>>>(P, M, rays, out, plane,
                                                     steps, t);
    }
    return cudaGetLastError();
  }));
}

// Plain C interface (bound with ctypes). M is the packed matrix buffer, null
// for a scene without neural leaves. tau arrives as a double and is rounded
// to T here, to nearest, as the host rounds it for the other kernels. next:
// a zeroed 4-byte counter of the caller's for lane refill at tau > 0 (null:
// one thread per ray). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int rm_march_f32(const float* P, const float* M, const float* rays,
                            float* out, long long plane, int steps, double tau,
                            unsigned int* next, void* stream) {
  return launch<float>(P, M, rays, out, plane, steps, tau, next, stream);
}

extern "C" int rm_march_f64(const double* P, const double* M,
                            const double* rays, double* out, long long plane,
                            int steps, double tau, unsigned int* next,
                            void* stream) {
  return launch<double>(P, M, rays, out, plane, steps, tau, next, stream);
}

#ifdef SCENE_TC
// The march on the tensor cores, f32: M is the packed matrix buffer followed
// by the tensor-core fragments (ops/params.py tc_fragments); plane a
// multiple of 128.
extern "C" int rm_march_tc_f32(const float* P, const float* M,
                               const float* rays, float* out, long long plane,
                               int steps, double tau, void* stream) {
  const int block = 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rm_launch_with_params(P, st, [&] {
    march_tc_kernel<<<(unsigned int)(plane / block), block, 0, st>>>(
        P, M, rays, out, plane, steps, static_cast<float>(tau));
    return cudaGetLastError();
  }));
}
#endif

// Registers a thread and blocks an SM (of 256 threads) of the per-thread
// march at tau = 0 (march_kernel<T, false>) in f32 or f64.
extern "C" int rm_march_occupancy(int f64, int* regs, int* blocks) {
  return f64 ? rm_occupancy(march_kernel<double, false>, 256, 0, regs, blocks)
             : rm_occupancy(march_kernel<float, false>, 256, 0, regs, blocks);
}
