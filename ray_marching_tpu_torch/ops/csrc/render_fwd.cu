// Fused sphere-trace march + terminal distance + tetrahedral normals +
// Laplacian, for one scene whose SDF is generated into scene_sdf.cuh.
//
// Replaces: ray_marching_tpu/ops/pallas_render.py::_render_kernel, launched
// there by _call_render_kernel for fused_march_normals (and _cov, _ift,
// _cov_ift). render_fwd_kernel is the serving configuration
// (track_min=False, log_hist=False), and render_fwd_refill_kernel the same
// at tau > 0 with lane refill, for an SDF expensive enough that a warp's
// idle lanes cost more than the refill's bookkeeping (the caller decides);
// render_fwd_train_kernel adds the outputs a differentiated forward hands
// to the backward kernel (render_bwd.cu). The dual branch is not carried
// over.
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
// 1080p on an H100 SXM). What binds it is instruction issue: a march step
// of test_scene2 is about 149 SASS instructions (the IEEE square roots and
// division with their range checks among them), and the loop alone issues
// near the SMs' one warp-instruction a cycle per scheduler (PERF.md §6).
// So only fewer instructions a step make it faster.
//
// Design: one thread per ray slot of the (rows, 128) planes, so every
// plane load and store is coalesced. Position, direction and validity stay
// in registers through all steps; the SDF is inlined straight-line code
// whose parameters are read through a runtime pointer (new parameter values
// never rebuild), and the compiler keeps them in registers through the
// loop: read from the constant bank (scene_params.cuh), as the backward
// reads them, the kernels measured 2-5 % slower (a uniform load in the loop
// and the bank's copy before each launch; PERF.md), so they keep the
// pointer. At tau = 0 the march runs a loop without the freeze test for an
// SDF without a rolled loop (march_loop.cuh, RM_MARCH_TAU0_LOOP): fewer
// instructions a step, the same positions. tau > 0: a ray breaks out of
// its loop once |d| < tau, which gives exactly the masked march of the JAX
// kernel, where a frozen ray re-evaluates the same position. The loop
// itself is march_ray of march_loop.cuh, shared with march.cu and
// render_bwd.cu. The TPU kernel's 64-row tiles, EXIT_SEG segments and
// static unroll are not carried over.
//
// Tensor cores (render_fwd_tc_kernel, f32, built for a scene with a
// tensor-core MLP leaf, SCENE_TC): the serving configuration with the MLP
// of neural.cuh's rm_mlp_tc, 128-thread blocks. mma.sync needs the warp's 32
// lanes converged, so nothing breaks out per lane: the march is the
// warp-masked one of march_loop.cuh, an invalid slot evaluates at its unmoved
// position with its stores masked (its outputs are the per-thread kernel's:
// the position, zeros), and the normals tail runs on every lane. Its planes
// are within the f32 tolerance of the per-thread kernel, not equal to it;
// march.cu's march_tc_kernel gives its planes 0-3 bit for bit.
// render_fwd_train_tc_kernel is the training configuration on the same
// march and tail: its 8 planes equal render_fwd_tc_kernel's, and its history
// the positions render_bwd.cu's TC instantiation recomputes and replays, bit
// for bit.
//
// The union short-circuit (a scene built with prune=True, SCENE_PRUNE):
// every kernel here computes scene_bounds once per thread and marches and
// evaluates the tail on scene_sdf_fwd (march_loop.cuh), which skips a
// guarded union child per thread where it cannot be the minimum: the same
// planes and training outputs, bit for bit. Without SCENE_PRUNE the bounds
// are empty and the SDF the plain one.
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

// Planes 0..7 of out from the terminal position, the distance there and at
// its four tetrahedral offsets: the normals and the Laplacian.
template <typename T>
__device__ __forceinline__ void store_planes(T* __restrict__ out,
                                             long long plane, long long i, T x,
                                             T y, T z, T d_centre,
                                             const T (&f)[4],
                                             const RenderConsts<T>& c) {
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

// Terminal distance, tetrahedral normals and Laplacian at (x, y, z):
// planes 0..7 of out. TC: every lane evaluates, an invalid one stores the
// pad outputs.
template <typename T, bool TC = false, typename Bounds = NoBounds>
__device__ __forceinline__ void store_hit(const T* __restrict__ P,
                                          const T* __restrict__ M,
                                          T* __restrict__ out, long long plane,
                                          long long i, T x, T y, T z,
                                          const RenderConsts<T>& c,
                                          bool valid = true,
                                          const Bounds& bounds = Bounds()) {
  const T d_centre = march_sdf<T, TC>(P, M, x, y, z, bounds);
  T f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = march_sdf<T, TC>(P, M, x + c.off[k][0], y + c.off[k][1],
                            z + c.off[k][2], bounds);
  }
  if (!valid) {
    store_pad<T>(out, plane, i, x, y, z);
    return;
  }
  store_planes<T>(out, plane, i, x, y, z, d_centre, f, c);
}

template <typename T>
__global__ void __launch_bounds__(256)
render_fwd_kernel(const T* __restrict__ P, const T* __restrict__ M,
                  const T* __restrict__ rays,
                  T* __restrict__ out, long long plane, int steps,
                  RenderConsts<T> c) {
  P = scene_params(P);
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
  const auto B = march_bounds<T>(P);
  NoObserver none;
  march_ray<T>(P, M, x, y, z, dx, dy, dz, steps, c.tau, none, true, B);
  store_hit<T>(P, M, out, plane, i, x, y, z, c, true, B);
}

// The serving configuration at tau > 0 with lane refill. With one thread per
// ray a warp marches until its slowest ray stops, and the lanes of rays that
// froze early idle (on the bulb at 1440x900, 64 steps, tau = 1e-4, warps of
// 32 slots use 74 % of their lanes' evaluations; PERF.md). Here persistent
// warps take ray slots from a global counter (next, one warp-aggregated
// atomicAdd per refill) and each lane holds one state: march step k of its
// ray, or tail evaluation j (0 the centre, 1..4 the offsets). Every pass of
// the loop evaluates the SDF once on every lane, at the point its state
// names, so the SDF call is uniform across the warp and only the
// bookkeeping diverges. A lane that ends its tail stores the 8 planes
// (store_planes, store_hit's arithmetic) and takes the next slot; a pad slot
// is stored at once. Each ray sees march_ray's and store_hit's op sequence,
// so the planes are render_fwd_kernel's bit for bit.
constexpr int REFILL_BLOCK = 128;

template <typename T>
__global__ void __launch_bounds__(REFILL_BLOCK)
render_fwd_refill_kernel(const T* __restrict__ P, const T* __restrict__ M,
                         const T* __restrict__ rays, T* __restrict__ out,
                         long long plane, int steps, RenderConsts<T> c,
                         unsigned int* __restrict__ next) {
  P = scene_params(P);
  const unsigned full = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  long long i = -1;   // the lane's ray slot; -1: it needs one
  bool done = false;  // no slot is left for the lane
  T x = static_cast<T>(0), y = x, z = x, dx = x, dy = x, dz = x;
  T dc = x, f0 = x, f1 = x, f2 = x;
  int k = 0;   // march step
  int j = -1;  // tail evaluation, -1 while marching
  const auto B = march_bounds<T>(P);
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
            j = steps > 0 ? -1 : 0;
          } else {
            store_pad<T>(out, plane, s, x, y, z);
          }
        }
      }
    }
    if (__all_sync(full, done)) break;
    // The point of the lane's state: the position, or an offset of it.
    const T o = static_cast<T>(0);
    const T px = j > 0 ? x + rm_pick5(j - 1, c.off[0][0], c.off[1][0],
                                      c.off[2][0], c.off[3][0], o)
                       : x;
    const T py = j > 0 ? y + rm_pick5(j - 1, c.off[0][1], c.off[1][1],
                                      c.off[2][1], c.off[3][1], o)
                       : y;
    const T pz = j > 0 ? z + rm_pick5(j - 1, c.off[0][2], c.off[1][2],
                                      c.off[2][2], c.off[3][2], o)
                       : z;
    const T d = march_sdf<T, false>(P, M, px, py, pz, B);
    if (done) continue;
    if (j < 0) {
      // march_ray's step at tau > 0: freeze without moving, or move.
      if (!march_step(x, y, z, dx, dy, dz, d, c.tau)) {
        j = 0;
      } else if (++k == steps) {
        j = 0;
      }
    } else if (j < 4) {
      dc = j == 0 ? d : dc;
      f0 = j == 1 ? d : f0;
      f1 = j == 2 ? d : f1;
      f2 = j == 3 ? d : f2;
      ++j;
    } else {
      const T f[4] = {f0, f1, f2, d};
      store_planes<T>(out, plane, i, x, y, z, dc, f, c);
      i = -1;
    }
  }
}

#ifdef SCENE_TC
// The serving configuration on the tensor cores; every ray slot of a warp
// takes part in every evaluation (plane is a multiple of 128).
__global__ void __launch_bounds__(128)
render_fwd_tc_kernel(const float* __restrict__ P, const float* __restrict__ M,
                     const float* __restrict__ rays, float* __restrict__ out,
                     long long plane, int steps, RenderConsts<float> c) {
  P = scene_params(P);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float x = rays[i];
  float y = rays[plane + i];
  float z = rays[2 * plane + i];
  const bool valid = rays[6 * plane + i] > 0.5f;
  const auto B = march_bounds<float>(P);
  NoObserver none;
  march_ray<float, NoObserver, true>(P, M, x, y, z, rays[3 * plane + i],
                                     rays[4 * plane + i], rays[5 * plane + i],
                                     steps, c.tau, none, valid, B);
  store_hit<float, true>(P, M, out, plane, i, x, y, z, c, valid, B);
}
#endif

template <typename T>
__global__ void __launch_bounds__(256)
render_fwd_train_kernel(const T* __restrict__ P, const T* __restrict__ M,
                        const T* __restrict__ rays,
                        T* __restrict__ out, long long plane, int steps,
                        RenderConsts<T> c, T big, TrainOuts<T> t) {
  P = scene_params(P);
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
  const auto B = march_bounds<T>(P);
  HistoryObserver<T, true> seen = {t.hist, plane, i, big, -1, x, y, z};
  const int s = march_ray<T>(P, M, x, y, z, dx, dy, dz, steps, c.tau, seen,
                             true, B);
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
  store_hit<T>(P, M, out, plane, i, x, y, z, c, true, B);
}

#ifdef SCENE_TC
// The training configuration on the tensor cores: render_fwd_tc_kernel's
// march and tail (the same planes, bit for bit) with the training outputs
// of render_fwd_train_kernel. An invalid slot never goes live, so its
// outputs are the per-thread kernel's: min_f the largest finite float,
// arg-min -1, its start as arg-min position and terminal history entry, no
// live step.
__global__ void __launch_bounds__(128)
render_fwd_train_tc_kernel(const float* __restrict__ P,
                           const float* __restrict__ M,
                           const float* __restrict__ rays,
                           float* __restrict__ out, long long plane,
                           int steps, RenderConsts<float> c, float big,
                           TrainOuts<float> t) {
  P = scene_params(P);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float x = rays[i];
  float y = rays[plane + i];
  float z = rays[2 * plane + i];
  const bool valid = rays[6 * plane + i] > 0.5f;
  const auto B = march_bounds<float>(P);
  HistoryObserver<float, true> seen = {t.hist, plane, i, big, -1, x, y, z};
  const int s = march_ray<float, HistoryObserver<float, true>, true>(
      P, M, x, y, z, rays[3 * plane + i], rays[4 * plane + i],
      rays[5 * plane + i], steps, c.tau, seen, valid, B);
  if (t.minf) t.minf[i] = seen.minf;
  if (t.amin) t.amin[i] = seen.amin;
  if (t.argpos) {
    t.argpos[i] = seen.ax;
    t.argpos[plane + i] = seen.ay;
    t.argpos[2 * plane + i] = seen.az;
  }
  if (t.hist) {
    float* h = t.hist + (long long)steps * (3 * plane);
    h[i] = x;
    h[plane + i] = y;
    h[2 * plane + i] = z;
  }
  if (t.nlive) t.nlive[i] = s;
  store_hit<float, true>(P, M, out, plane, i, x, y, z, c, valid, B);
}
#endif

// The serving configuration: lane refill at tau > 0 when the caller hands
// a zeroed counter (next; ops/render_kernel.py does for an SDF that is
// expensive enough), else one thread per ray slot. At tau = 0 every ray
// marches every step and the bookkeeping would only cost time.
template <typename T>
static int launch(const T* P, const T* M, const T* rays, T* out,
                  long long plane, int steps, const T* host_consts,
                  unsigned int* next, void* stream) {
  const RenderConsts<T> c = unpack_consts<T>(host_consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c.tau != static_cast<T>(0) && next != nullptr) {
    // Persistent blocks: as many as the SMs hold at the kernel's occupancy,
    // and no more than the slots need.
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, render_fwd_refill_kernel<T>, REFILL_BLOCK, 0);
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long need = (plane + REFILL_BLOCK - 1) / REFILL_BLOCK;
    if (grid > need) grid = need;
    if (grid < 1) grid = 1;
    return static_cast<int>(rm_launch_with_params(P, st, [&] {
      render_fwd_refill_kernel<T><<<(unsigned int)grid, REFILL_BLOCK, 0,
                                    st>>>(P, M, rays, out, plane, steps, c,
                                          next);
      return cudaGetLastError();
    }));
  }
  const int block = 256;
  const long long grid = (plane + block - 1) / block;
  return static_cast<int>(rm_launch_with_params(P, st, [&] {
    render_fwd_kernel<T><<<(unsigned int)grid, block, 0, st>>>(
        P, M, rays, out, plane, steps, c);
    return cudaGetLastError();
  }));
}

template <typename T, bool TC = false>
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
  const T big = std::numeric_limits<T>::max();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rm_launch_with_params(P, st, [&] {
#ifdef SCENE_TC
    if constexpr (TC) {
      const int block = 128;
      render_fwd_train_tc_kernel<<<(unsigned int)(plane / block), block, 0,
                                   st>>>(P, M, rays, out, plane, steps, c,
                                         big, t);
      return cudaGetLastError();
    }
#endif
    const int block = 256;
    const long long grid = (plane + block - 1) / block;
    render_fwd_train_kernel<T><<<(unsigned int)grid, block, 0, st>>>(
        P, M, rays, out, plane, steps, c, big, t);
    return cudaGetLastError();
  }));
}

#ifdef SCENE_TC
static int launch_tc(const float* P, const float* M, const float* rays,
                     float* out, long long plane, int steps,
                     const float* host_consts, void* stream) {
  const RenderConsts<float> c = unpack_consts<float>(host_consts);
  const int block = 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rm_launch_with_params(P, st, [&] {
    render_fwd_tc_kernel<<<(unsigned int)(plane / block), block, 0, st>>>(
        P, M, rays, out, plane, steps, c);
    return cudaGetLastError();
  }));
}
#endif

// Plain C interface (bound with ctypes). M is the packed matrix buffer, null
// for a scene without neural leaves. host_consts: 23 values of T on the
// host: offsets (4x3, row-major), inverse (3x3), 6/eps^2, tau. Returns the
// cudaError_t of the launch (0 on success). The serving entry points take
// next, a zeroed 4-byte counter of the caller's, for lane refill at tau > 0
// (null: one thread per ray). The training entry points take out with 9
// planes when track_min is set, and a null pointer for each extra output
// that is not wanted.
extern "C" int rm_render_fwd_f32(const float* P, const float* M,
                                 const float* rays, float* out,
                                 long long plane, int steps,
                                 const float* host_consts, unsigned int* next,
                                 void* stream) {
  return launch<float>(P, M, rays, out, plane, steps, host_consts, next,
                       stream);
}

extern "C" int rm_render_fwd_f64(const double* P, const double* M,
                                 const double* rays, double* out,
                                 long long plane, int steps,
                                 const double* host_consts, unsigned int* next,
                                 void* stream) {
  return launch<double>(P, M, rays, out, plane, steps, host_consts, next,
                        stream);
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

// The training configuration on the tensor cores, f32: arguments as
// rm_render_fwd_train_f32, M as rm_render_fwd_tc_f32, plane a multiple of
// 128.
extern "C" int rm_render_fwd_train_tc_f32(const float* P, const float* M,
                                          const float* rays, float* out,
                                          long long plane, int steps,
                                          const float* host_consts,
                                          int track_min, int* amin,
                                          float* argpos, float* hist,
                                          int* nlive, void* stream) {
  return launch_train<float, true>(P, M, rays, out, plane, steps,
                                   host_consts, track_min, amin, argpos, hist,
                                   nlive, stream);
}
#endif

// Registers a thread and blocks an SM (of 256 threads) of the per-thread
// serving (train = 0) or training (train = 1) kernel in f32 or f64.
extern "C" int rm_render_fwd_occupancy(int f64, int train, int* regs,
                                       int* blocks) {
  if (f64) {
    return train ? rm_occupancy(render_fwd_train_kernel<double>, 256, 0, regs,
                                blocks)
                 : rm_occupancy(render_fwd_kernel<double>, 256, 0, regs,
                                blocks);
  }
  return train ? rm_occupancy(render_fwd_train_kernel<float>, 256, 0, regs,
                              blocks)
               : rm_occupancy(render_fwd_kernel<float>, 256, 0, regs, blocks);
}
