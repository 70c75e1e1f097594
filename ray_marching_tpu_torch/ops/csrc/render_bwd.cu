// Backward of the fused march + normals kernel (render_fwd.cu) and of the
// march kernel (march.cu), for one scene whose SDF and its vector-Jacobian
// product are generated into scene_sdf.cuh.
//
// Replaces: ray_marching_tpu/ops/pallas_backward.py::_bwd_kernel and, as its
// TWO_LEVEL instantiation, ::_bwd_kernel_2l, both launched there by
// fused_backward. The MARCH_ONLY instantiation is the backward of
// pallas_march.py::_march_kernel, which the JAX package differentiates as a
// checkpointed scan outside any kernel (_core_bwd).
//
// Contract: rays (7, plane) as the forward took them; g (8 or 9, plane) the
// cotangents of x y z d nx ny nz lap and, with TRACK_MIN, of min_f (MARCH_ONLY:
// 4 planes, x y z d); out (6, plane) = the cotangents of x0 y0 z0 dx dy dz;
// partials (blocks, SCENE_N_SCALARS + SCENE_MAT_SIZE) = each block's share of
// the parameter cotangent (the flat scalars in compact order, then the packed
// matrices of the neural leaves), summed over the blocks by the caller.
// Invalid slots (valid <= 0.5) get zero cotangents and add nothing.
//
// What it computes, per ray:
//  1. the march positions, in one of three ways: read from the history the
//     forward wrote; recomputed here (the same op sequence, march_ray of
//     march_loop.cuh, so the same bits) into a scratch history the caller
//     allocated; or, TWO_LEVEL, recomputed keeping only every
//     CKPT_INTERVAL-th position in a scratch (steps / CKPT_INTERVAL, 3,
//     plane), each segment marched again from its checkpoint when the sweep
//     reaches it. The segment's CKPT_INTERVAL positions live in the thread's
//     local memory (an array the sweep indexes by its loop variable);
//  2. one VJP of the tail (terminal distance, 4 offset evaluations, 3x3
//     inverse, normalisation, Laplacian) into the terminal position;
//     MARCH_ONLY: the position cotangent plus one SDF VJP weighted by the
//     distance's cotangent, and nothing else (no normals, so no division by
//     their norm);
//  3. the reverse sweep over the steps x' = x + d(x) * v, in the order
//     steps-1 .. 0 whatever the source of the positions, each adding to the
//     parameter and direction cotangents. With tau > 0 the sweep covers the
//     ray's own live steps only: a frozen step is the identity map;
//  4. with TRACK_MIN the min_f cotangent is spread as autodiff of a chain of
//     minimum() would: going backwards, a tied step (d == min_f, not the
//     first attaining one) takes half of what is left, the first attaining
//     step takes the rest. A converged ray ties at every later step, so the
//     sweep then covers all steps, frozen ones at the terminal position.
//
// TWO_LEVEL runs at tau = 0 without TRACK_MIN only, and steps must be a
// multiple of CKPT_INTERVAL (the caller's rule, two_level_engages of
// ops/backward_kernel.py; the launch refuses anything else).
//
// Bound on an H100: with the forward's history, bytes by a small margin
// over operations; with the recompute or two levels, operations. Per valid
// ray and step it runs one scene_sdf_vjp (226 operations for test_scene2
// against 65 for the SDF alone, scene/codegen.py counts them) and reads 12
// bytes of history. With the history the start position planes of rays are
// never read: every position comes from the history.
//
// Design: one thread per ray slot, every plane access coalesced, the
// history and the checkpoints plane-major for the same reason. Each thread
// keeps the parameter cotangent of the scalars the scene really has in
// registers; a block sums them with warp shuffles and shared memory in a
// fixed order and writes one row of partials, so the result is the same from
// run to run and whichever way the positions were obtained (no atomics).
// The TPU kernels' tiles, VMEM history, VMEM checkpoint and replay scratch
// and unrolled sweep are not carried over.
//
// Scenes with neural leaves (SCENE_N_MLP > 0, chosen at compile time) run
// the block-synchronous variant: a matrix cotangent cannot live in a thread,
// so every SDF VJP hands its (a, δ) pairs to the block's sink (neural.cuh),
// which adds Σ_rays a ⊗ δ to the block's row in a fixed order between two
// barriers; the biases of the leaves go there too. Every thread of the
// block therefore walks the same sequence of VJPs: the tail's, then the
// steps from the block's longest sweep down to 0 (the forward march and the
// segment replays stay per thread: they have no barrier). A thread with
// nothing to add at a VJP (a pad slot, a step after its ray froze) is
// inactive there: it stages zeros, skips the MLP and adds nothing. The
// sequence is the same whichever way the positions are obtained, so the
// three ways stay bitwise equal. Bound on an H100: operations, the MLP's
// VJP (scene/codegen.py counts it: one forward, the slopes, W·δ, a ⊗ δ).
#include <cuda_runtime.h>

#include <limits>

#include "neural.cuh"
#include "march_loop.cuh"
#include "render_consts.cuh"

constexpr int BWD_BLOCK = 128;
#ifndef RM_CKPT_INTERVAL
#error "build with -DRM_CKPT_INTERVAL=<steps between checkpoints>"
#endif
constexpr int CKPT_INTERVAL = RM_CKPT_INTERVAL;
constexpr int N_ACC = SCENE_N_ACC > 0 ? SCENE_N_ACC : 1;
// The block-synchronous variant, for scenes with neural leaves.
constexpr bool SYNC = SCENE_N_MLP > 0;
// A row of partials: the scalars, then the packed matrices.
constexpr long long ROW = SCENE_N_SCALARS + SCENE_MAT_SIZE;
static_assert(!SYNC || BWD_BLOCK == RM_SINK_THREADS, "sink tiles");

template <typename T>
struct BwdArgs {
  const T* P;
  const T* M;  // packed matrices of the neural leaves (null: none)
  const T* rays;
  const T* g;
  T* hist;           // (steps + 1, 3, plane): the forward's, or scratch
  T* ckpt;           // TWO_LEVEL: (steps / CKPT_INTERVAL, 3, plane) scratch
  const T* minf;     // the forward's min_f plane (history given, TRACK_MIN)
  const int* amin;   // the forward's arg-min step (history given, TRACK_MIN)
  const int* nlive;  // the forward's live-step count (history given)
  T* out;            // (6, plane)
  T* partials;       // (blocks, ROW)
  long long plane;
  int steps;
  int recompute;  // 1: fill hist here instead of reading the forward's
};

// Keeps the position before every CKPT_INTERVAL-th step.
template <typename T>
struct CheckpointObserver {
  T* ckpt;
  long long plane;
  long long i;

  __device__ __forceinline__ void operator()(int s, T x, T y, T z, T) {
    if (s % CKPT_INTERVAL == 0) {
      T* c = ckpt + (s / CKPT_INTERVAL) * (3 * plane);
      c[i] = x;
      c[plane + i] = y;
      c[2 * plane + i] = z;
    }
  }
};

// Keeps a segment's positions in the thread's own arrays.
template <typename T>
struct ReplayObserver {
  T* rx;
  T* ry;
  T* rz;

  __device__ __forceinline__ void operator()(int s, T x, T y, T z, T) {
    rx[s] = x;
    ry[s] = y;
    rz[s] = z;
  }
};

// The SDF VJP of a scene with neural leaves, out of line: its call sites
// then share one frame for the hidden layers the MLP keeps (scene_sdf.cuh).
template <typename T>
__device__ __noinline__ T sdf_vjp_sync(const T* __restrict__ P,
                                       const T* __restrict__ M, T x, T y, T z,
                                       T g, T& gx, T& gy, T& gz, T* gP,
                                       const RmSink<T>& sink) {
  return scene_sdf_vjp<T>(P, M, x, y, z, g, gx, gy, gz, gP, sink);
}

// The scene's SDF VJP; with neural leaves it also feeds the block's sink.
template <typename T>
__device__ __forceinline__ T sdf_vjp(const T* __restrict__ P,
                                     const T* __restrict__ M, T x, T y, T z,
                                     T g, T& gx, T& gy, T& gz, T* gP,
                                     const RmSink<T>& sink) {
  if constexpr (SYNC) {
    return sdf_vjp_sync<T>(P, M, x, y, z, g, gx, gy, gz, gP, sink);
  } else {
    return scene_sdf_vjp<T>(P, M, x, y, z, g, gx, gy, gz, gP);
  }
}

// The largest v of the block (every thread calls it).
__device__ __forceinline__ int block_max(int v) {
  __shared__ int m;
  if (threadIdx.x == 0) m = 0;
  __syncthreads();
  atomicMax(&m, v);
  __syncthreads();
  return m;
}

// One step of the reverse sweep at the position (px, py, pz) the ray had
// before the step: gd is the cotangent of the distance there, (gx, gy, gz)
// the cotangent of the position after the step on entry and before it on
// return. A frozen step (live == false) moves nothing and only carries gd.
// An inactive thread (sink) changes nothing.
template <typename T>
__device__ __forceinline__ void sweep_step(const T* __restrict__ P,
                                           const T* __restrict__ M, T px, T py,
                                           T pz, T gd, bool live, T& gx, T& gy,
                                           T& gz, T& gvx, T& gvy, T& gvz,
                                           T* gP, const RmSink<T>& sink) {
  T sx, sy, sz;
  const T d = sdf_vjp<T>(P, M, px, py, pz, gd, sx, sy, sz, gP, sink);
  if constexpr (SYNC) {
    if (!sink.active) return;
  }
  if (live) {
    gvx = gvx + gx * d;
    gvy = gvy + gy * d;
    gvz = gvz + gz * d;
  }
  gx = gx + sx;
  gy = gy + sy;
  gz = gz + sz;
}

template <typename T, bool TRACK_MIN, bool TWO_LEVEL, bool MARCH_ONLY>
__global__ void __launch_bounds__(BWD_BLOCK)
render_bwd_kernel(BwdArgs<T> a, RenderConsts<T> c, T big) {
  const long long plane = a.plane;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const T zero = static_cast<T>(0);
  const T half = static_cast<T>(0.5);
  T gP[N_ACC];
#pragma unroll
  for (int k = 0; k < N_ACC; ++k) gP[k] = zero;
  const bool valid = i < plane && a.rays[6 * plane + i] > static_cast<T>(0.5);
  if (i < plane && !valid) {
    for (int k = 0; k < 6; ++k) a.out[k * plane + i] = zero;
  }
  // The block's matrix sink (SYNC only; otherwise every thread that runs a
  // VJP is active and nothing reads the rest).
  RmSink<T> sink = {nullptr, nullptr, nullptr, true};
  if constexpr (SYNC) {
    constexpr int SW = rm_sink_width<T>() + 1;
    __shared__ T sa[RM_SINK_THREADS * SW];
    __shared__ T sd[RM_SINK_THREADS * SW];
    sink.row = a.partials + (long long)blockIdx.x * ROW;
    sink.sa = sa;
    sink.sd = sd;
    // Ordered before the first addition by the sink's first barrier.
    for (long long k = threadIdx.x; k < ROW; k += BWD_BLOCK) {
      sink.row[k] = zero;
    }
  }
  // In SYNC every thread walks the body; skip marks an invalid one there.
  const bool skip = SYNC && !valid;
  if (valid || SYNC) {
    const long long p3 = 3 * plane;
    const int steps = a.steps;
    const T vx = a.rays[3 * plane + i];
    const T vy = a.rays[4 * plane + i];
    const T vz = a.rays[5 * plane + i];
    // The terminal position's slot of the history (not used by TWO_LEVEL).
    T* hend = TWO_LEVEL ? nullptr : a.hist + (long long)steps * p3;
    T x, y, z;  // terminal position
    T minf = big;
    int amin = -1;
    int nlive;
    if (TWO_LEVEL) {
      x = a.rays[i];
      y = a.rays[plane + i];
      z = a.rays[2 * plane + i];
      CheckpointObserver<T> keep = {a.ckpt, plane, i};
      nlive = skip ? 0
                   : march_ray<T>(a.P, a.M, x, y, z, vx, vy, vz, steps, zero,
                                  keep);
    } else if (a.recompute) {
      x = a.rays[i];
      y = a.rays[plane + i];
      z = a.rays[2 * plane + i];
      HistoryObserver<T, TRACK_MIN> seen = {a.hist, plane, i, big, -1,
                                            x,      y,     z};
      nlive = skip ? 0
                   : march_ray<T>(a.P, a.M, x, y, z, vx, vy, vz, steps, c.tau,
                                  seen);
      minf = seen.minf;
      amin = seen.amin;
      hend[i] = x;
      hend[plane + i] = y;
      hend[2 * plane + i] = z;
    } else {
      x = hend[i];
      y = hend[plane + i];
      z = hend[2 * plane + i];
      nlive = skip ? 0 : a.nlive[i];
      if (TRACK_MIN) {
        minf = a.minf[i];
        amin = a.amin[i];
      }
    }

    T gx = a.g[i];
    T gy = a.g[plane + i];
    T gz = a.g[2 * plane + i];
    sink.active = !skip;
    if (MARCH_ONLY) {
      // ---- the terminal distance's cotangent into the position ----
      T sx, sy, sz;
      sdf_vjp<T>(a.P, a.M, x, y, z, a.g[3 * plane + i], sx, sy, sz, gP,
                 sink);
      gx = gx + sx;
      gy = gy + sy;
      gz = gz + sz;
    } else {
      // ---- tail VJP into the terminal position ----
      T ox[5], oy[5], oz[5], gf[5];
      T f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ox[k] = c.off[k][0];
        oy[k] = c.off[k][1];
        oz[k] = c.off[k][2];
        f[k] = skip ? zero
                    : scene_sdf<T>(a.P, a.M, x + ox[k], y + oy[k], z + oz[k]);
      }
      ox[4] = zero;
      oy[4] = zero;
      oz[4] = zero;
      const T d1 = f[1] - f[0];
      const T d2 = f[2] - f[0];
      const T d3 = f[3] - f[0];
      const T nx = c.inv[0][0] * d1 + c.inv[0][1] * d2 + c.inv[0][2] * d3;
      const T ny = c.inv[1][0] * d1 + c.inv[1][1] * d2 + c.inv[1][2] * d3;
      const T nz = c.inv[2][0] * d1 + c.inv[2][1] * d2 + c.inv[2][2] * d3;
      const T norm = rm_sqrt(nx * nx + ny * ny + nz * nz);
      const T g4 = a.g[4 * plane + i];
      const T g5 = a.g[5 * plane + i];
      const T g6 = a.g[6 * plane + i];
      // n = N / norm: to N directly, and through norm = sqrt(N . N).
      const T gnorm = -(g4 * ((nx / norm) / norm) + g5 * ((ny / norm) / norm) +
                        g6 * ((nz / norm) / norm));
      const T gs = gnorm / (static_cast<T>(2) * norm);
      const T gnx = g4 / norm + (gs * nx + gs * nx);
      const T gny = g5 / norm + (gs * ny + gs * ny);
      const T gnz = g6 / norm + (gs * nz + gs * nz);
      const T gd1 = c.inv[0][0] * gnx + c.inv[1][0] * gny + c.inv[2][0] * gnz;
      const T gd2 = c.inv[0][1] * gnx + c.inv[1][1] * gny + c.inv[2][1] * gnz;
      const T gd3 = c.inv[0][2] * gnx + c.inv[1][2] * gny + c.inv[2][2] * gnz;
      // lap = (d_centre - mean4) * lap_scale, mean4 = (f0 + f1 + f2 + f3) / 4.
      const T glap = a.g[7 * plane + i] * c.lap_scale;
      const T gmean = -glap * static_cast<T>(0.25);
      gf[0] = gmean - (gd1 + gd2 + gd3);
      gf[1] = gmean + gd1;
      gf[2] = gmean + gd2;
      gf[3] = gmean + gd3;
      gf[4] = a.g[3 * plane + i] + glap;
#pragma unroll 1
      for (int k = 0; k < 5; ++k) {
        T sx, sy, sz;
        sdf_vjp<T>(a.P, a.M, x + ox[k], y + oy[k], z + oz[k], gf[k], sx, sy,
                   sz, gP, sink);
        gx = gx + sx;
        gy = gy + sy;
        gz = gz + sz;
      }
    }

    // ---- reverse sweep over the march ----
    T gvx = zero, gvy = zero, gvz = zero;
    if (TWO_LEVEL) {
#pragma unroll 1
      for (int seg = steps / CKPT_INTERVAL - 1; seg >= 0; --seg) {
        const T* ck = a.ckpt + seg * p3;
        T rx[CKPT_INTERVAL], ry[CKPT_INTERVAL], rz[CKPT_INTERVAL];
        T px = skip ? zero : ck[i];
        T py = skip ? zero : ck[plane + i];
        T pz = skip ? zero : ck[2 * plane + i];
        // The segment's last step is not marched: the sweep needs the
        // position before it, not after.
        ReplayObserver<T> replay = {rx, ry, rz};
        if (!skip) {
          march_ray<T>(a.P, a.M, px, py, pz, vx, vy, vz, CKPT_INTERVAL - 1,
                       zero, replay);
        }
        rx[CKPT_INTERVAL - 1] = px;
        ry[CKPT_INTERVAL - 1] = py;
        rz[CKPT_INTERVAL - 1] = pz;
#pragma unroll 1
        for (int j = CKPT_INTERVAL - 1; j >= 0; --j) {
          const T gd = gx * vx + gy * vy + gz * vz;
          sweep_step<T>(a.P, a.M, skip ? zero : rx[j], skip ? zero : ry[j],
                        skip ? zero : rz[j], gd, true, gx, gy, gz, gvx, gvy,
                        gvz, gP, sink);
        }
      }
    } else {
      T carry = TRACK_MIN ? a.g[8 * plane + i] : zero;
      const int n = TRACK_MIN ? (skip ? 0 : steps) : nlive;
      int n_sweep = n;
      if constexpr (SYNC) n_sweep = block_max(n);
#pragma unroll 1
      for (int s = n_sweep - 1; s >= 0; --s) {
        sink.active = !skip && s < n;
        const bool live = s < nlive;
        const T* h = live ? a.hist + s * p3 : hend;
        const T px = h[i];
        const T py = h[plane + i];
        const T pz = h[2 * plane + i];
        T gd = live ? gx * vx + gy * vy + gz * vz : zero;
        if (TRACK_MIN) {
          const T d = (!SYNC || sink.active)
                          ? scene_sdf<T>(a.P, a.M, px, py, pz)
                          : zero;
          const bool first = amin == s;
          const bool tie = d == minf && !first;
          gd = gd + (first ? carry : (tie ? half * carry : zero));
          carry = first ? zero : (tie ? half * carry : carry);
        }
        sweep_step<T>(a.P, a.M, px, py, pz, gd, live, gx, gy, gz, gvx, gvy,
                      gvz, gP, sink);
      }
    }
    if (!skip) {
      a.out[i] = gx;
      a.out[plane + i] = gy;
      a.out[2 * plane + i] = gz;
      a.out[3 * plane + i] = gvx;
      a.out[4 * plane + i] = gvy;
      a.out[5 * plane + i] = gvz;
    }
  }

  // ---- the block's share of the parameter cotangent, in a fixed order ----
  __shared__ T red[BWD_BLOCK / 32][N_ACC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N_ACC; ++k) {
    T v = gP[k];
    for (int off = 16; off > 0; off >>= 1) {
      v = v + __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < SCENE_N_ACC; k += BWD_BLOCK) {
    T s = red[0][k];
    for (int w = 1; w < BWD_BLOCK / 32; ++w) s = s + red[w][k];
    if constexpr (SYNC) {
      a.partials[(long long)blockIdx.x * ROW + SCENE_ACC_SCALAR[k]] = s;
    } else {
      a.partials[(long long)blockIdx.x * SCENE_N_SCALARS + k] = s;
    }
  }
}

enum BwdMode { BWD_FULL = 0, BWD_TWO_LEVEL = 1, BWD_MARCH_ONLY = 2 };

template <typename T>
static int launch(BwdArgs<T> a, int mode, int track_min, long long n_blocks,
                  long long n_cols, const RenderConsts<T>& c, void* stream) {
  const long long grid = (a.plane + BWD_BLOCK - 1) / BWD_BLOCK;
  if (n_cols != ROW || n_blocks != grid ||
      (a.M == nullptr) != (SCENE_N_MLP == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode != BWD_FULL && track_min) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == BWD_TWO_LEVEL &&
      (c.tau != static_cast<T>(0) || a.steps % CKPT_INTERVAL != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T big = std::numeric_limits<T>::max();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int g = (unsigned int)grid;
  if (mode == BWD_TWO_LEVEL) {
    render_bwd_kernel<T, false, true, false><<<g, BWD_BLOCK, 0, st>>>(a, c,
                                                                      big);
  } else if (mode == BWD_MARCH_ONLY) {
    render_bwd_kernel<T, false, false, true><<<g, BWD_BLOCK, 0, st>>>(a, c,
                                                                      big);
  } else if (track_min) {
    render_bwd_kernel<T, true, false, false><<<g, BWD_BLOCK, 0, st>>>(a, c,
                                                                      big);
  } else {
    render_bwd_kernel<T, false, false, false><<<g, BWD_BLOCK, 0, st>>>(a, c,
                                                                       big);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C interface (bound with ctypes). partials is (n_blocks, n_cols)
// with n_blocks = ceil(plane / rm_render_bwd_block()) and n_cols the
// scene's scalar count plus its packed matrix size; M is the packed matrix
// buffer, null exactly when the scene has no neural leaf; a mismatch
// returns cudaErrorInvalidValue. Every entry returns the cudaError_t of the
// launch (0 on success).
extern "C" int rm_render_bwd_block() { return BWD_BLOCK; }

// Backward of render_fwd.cu. g has 9 planes when track_min is set, else 8.
// hist is the forward's history (recompute = 0; then nlive and, with
// track_min, minf and amin are the forward's planes) or an uninitialised
// scratch of the same shape (recompute = 1; the three may be null). With
// two_level set, hist and the three are null and ckpt is an uninitialised
// scratch (steps / RM_CKPT_INTERVAL, 3, plane). host_consts as
// in render_fwd.cu.
#define RM_BWD_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* P, const T* M, const T* rays, const T* g,     \
                      int track_min, T* hist, int recompute, T* ckpt,        \
                      int two_level, const T* minf, const int* amin,         \
                      const int* nlive, T* out, T* partials,                 \
                      long long n_blocks, long long n_cols, long long plane, \
                      int steps, const T* host_consts, void* stream) {       \
    BwdArgs<T> a;                                                            \
    a.P = P;                                                                 \
    a.M = M;                                                                 \
    a.rays = rays;                                                           \
    a.g = g;                                                                 \
    a.hist = hist;                                                           \
    a.ckpt = ckpt;                                                           \
    a.minf = minf;                                                           \
    a.amin = amin;                                                           \
    a.nlive = nlive;                                                         \
    a.out = out;                                                             \
    a.partials = partials;                                                   \
    a.plane = plane;                                                         \
    a.steps = steps;                                                         \
    a.recompute = recompute;                                                 \
    return launch<T>(a, two_level ? BWD_TWO_LEVEL : BWD_FULL, track_min,     \
                     n_blocks, n_cols, unpack_consts<T>(host_consts),        \
                     stream);                                                \
  }

RM_BWD_ENTRY(rm_render_bwd_f32, float)
RM_BWD_ENTRY(rm_render_bwd_f64, double)

// Backward of march.cu: g has 4 planes (x y z d); hist is an uninitialised
// scratch (steps + 1, 3, plane) the kernel fills with its own recompute of
// the march. tau arrives as a double and is rounded to T here, as march.cu
// rounds it.
#define RM_MARCH_BWD_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* P, const T* M, const T* rays, const T* g,     \
                      T* hist, T* out, T* partials, long long n_blocks,      \
                      long long n_cols, long long plane, int steps,          \
                      double tau, void* stream) {                            \
    BwdArgs<T> a = {};                                                       \
    a.P = P;                                                                 \
    a.M = M;                                                                 \
    a.rays = rays;                                                           \
    a.g = g;                                                                 \
    a.hist = hist;                                                           \
    a.out = out;                                                             \
    a.partials = partials;                                                   \
    a.plane = plane;                                                         \
    a.steps = steps;                                                         \
    a.recompute = 1;                                                         \
    RenderConsts<T> c = {};                                                  \
    c.tau = static_cast<T>(tau);                                             \
    return launch<T>(a, BWD_MARCH_ONLY, 0, n_blocks, n_cols, c, stream);     \
  }

RM_MARCH_BWD_ENTRY(rm_march_bwd_f32, float)
RM_MARCH_BWD_ENTRY(rm_march_bwd_f64, double)
