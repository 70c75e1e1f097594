// The sphere-trace step x' = x + d(x) * v and its loop, written once for
// every kernel that marches (render_fwd.cu, march.cu, and the position
// recompute and segment replay of render_bwd.cu), so that their trajectories
// cannot drift apart: the backward's bitwise equality with the forward's
// history rests on all of them running this one op sequence. The lane-refill
// kernels (render_fwd.cu, march.cu) run march_step outside march_ray.
//
// An observer sees every step before the ray moves: (step index, position,
// distance there). Observers only store; none changes the arithmetic.
//
// P is the flat parameter vector, M the packed matrix buffer of the scene's
// neural leaves (null for an analytic scene).
//
// tau > 0: a ray leaves the loop once |d| < tau, which is the masked march
// of the JAX kernels (a frozen ray re-evaluates the same position and stays
// frozen). The test is !(|d| >= tau), so a NaN distance freezes the ray as
// jnp.abs(d) >= tau does. Returns the number of steps the ray moved.
//
// TC (the tensor-core entries of a scene with a tensor-core MLP leaf,
// SCENE_TC in the generated header: both forwards, the march and the
// backward's recompute, checkpoints and replays): the SDF is
// scene_sdf<T, true>,
// whose MLP needs every lane of the warp. The loop is then warp-masked: a
// lane that is frozen, or not live from the start (an invalid slot), keeps
// evaluating at its own unchanged position with its observer and its moves
// masked, and the warp leaves the loop when no lane is live or after steps.
// That is the JAX kernels' own semantics, and rows of the MLP's matrix
// products are independent, so every ray gets the bits of the per-ray
// break; the observer sees the same steps.
//
// Bounds (the union short-circuit, SCENE_PRUNE in the generated header of a
// program built with prune=True that has a guarded union child): a kernel
// computes scene_bounds(P) once per thread and hands it to its marches and
// evaluations, which then take scene_sdf_fwd, skipping a guarded child
// where its bounding sphere lies strictly beyond the running minimum (the
// same values; scene/codegen.py). NoBounds, the default, takes the plain
// scene_sdf: march.cu, the backward's march-only mode, segment replays,
// normals tail and min_f tie test, and every VJP keep it (render_bwd.cu says
// why the replays do). A guarded region makes no sink call, so the
// block-synchronous backward's order of sink calls does not change.
#pragma once

#include "scene_params.cuh"
#include "sdf_prims.cuh"
#include "scene_sdf.cuh"

struct NoBounds {};
#ifndef SCENE_PRUNE
template <typename T>
using SceneBounds = NoBounds;

template <typename T>
__device__ __forceinline__ NoBounds scene_bounds(const T* __restrict__) {
  return {};
}
#endif

// The bounds a kernel's marches take: scene_bounds(P), or NoBounds (the
// plain SDF) without PRUNE.
template <typename T, bool PRUNE = true>
__device__ __forceinline__ auto march_bounds(const T* __restrict__ P) {
  if constexpr (PRUNE) {
    return scene_bounds<T>(P);
  } else {
    return NoBounds{};
  }
}

template <typename T, bool TC>
__device__ __forceinline__ T march_sdf(const T* __restrict__ P,
                                       const T* __restrict__ M, T x, T y,
                                       T z, NoBounds = {}) {
#ifdef SCENE_TC
  return scene_sdf<T, TC>(P, M, x, y, z);
#else
  static_assert(!TC, "the scene has no tensor-core MLP leaf");
  return scene_sdf<T>(P, M, x, y, z);
#endif
}

#ifdef SCENE_PRUNE
template <typename T, bool TC>
__device__ __forceinline__ T march_sdf(const T* __restrict__ P,
                                       const T* __restrict__ M, T x, T y,
                                       T z, const SceneBounds<T>& B) {
#ifdef SCENE_TC
  return scene_sdf_fwd<T, TC>(P, M, B, x, y, z);
#else
  static_assert(!TC, "the scene has no tensor-core MLP leaf");
  return scene_sdf_fwd<T>(P, M, B, x, y, z);
#endif
}
#endif

struct NoObserver {
  template <typename T>
  __device__ __forceinline__ void operator()(int, T, T, T, T) {}
};

// Writes the position before each step into a plane-major history
// (steps + 1, 3, plane) when hist is not null, and with TRACK_MIN keeps the
// least distance, the first step that attains it (strict "<") and the
// position there.
template <typename T, bool TRACK_MIN>
struct HistoryObserver {
  T* hist;
  long long plane;
  long long i;
  T minf;
  int amin;
  T ax, ay, az;

  __device__ __forceinline__ void operator()(int s, T x, T y, T z, T d) {
    if (hist) {
      T* h = hist + s * (3 * plane);
      h[i] = x;
      h[plane + i] = y;
      h[2 * plane + i] = z;
    }
    if (TRACK_MIN && d < minf) {
      minf = d;
      amin = s;
      ax = x;
      ay = y;
      az = z;
    }
  }
};

// One march step from (x, y, z) with the distance d there, in two halves:
// the freeze test at tau > 0 (|d| not >= tau, so a NaN distance freezes the
// ray as jnp.abs(d) >= tau does) and the move x + d * v. march_ray runs the
// halves in its own loop shape (observe, test and break, move): written
// through march_step, the compiled loop changed and the bulb's training
// forward took 2.1 % longer (PERF.md). The lane-refill kernels
// (render_fwd.cu, march.cu) take march_step: freeze without moving (false),
// or move (true).
template <typename T>
__device__ __forceinline__ bool march_freezes(const T d, const T tau) {
  return !(rm_abs(d) >= tau);
}

template <typename T>
__device__ __forceinline__ void march_move(T& x, T& y, T& z, const T vx,
                                           const T vy, const T vz,
                                           const T d) {
  x = x + d * vx;
  y = y + d * vy;
  z = z + d * vz;
}

template <typename T>
__device__ __forceinline__ bool march_step(T& x, T& y, T& z, const T vx,
                                           const T vy, const T vz, const T d,
                                           const T tau) {
  if (march_freezes(d, tau)) return false;
  march_move(x, y, z, vx, vy, vz, d);
  return true;
}

// The march loop, with the freeze test at tau > 0 (FREEZE) or with none.
// march_ray takes the one with none where the launch's tau is 0, when the
// build sets RM_MARCH_TAU0_LOOP (ops/render_kernel.py scene_flags: an SDF
// without a rolled loop, whose body a second copy would double): fewer
// instructions a step, the same positions. The tensor-core entries keep the
// one loop.
#ifndef RM_MARCH_TAU0_LOOP
#define RM_MARCH_TAU0_LOOP 0
#endif
constexpr bool MARCH_TAU0_LOOP = RM_MARCH_TAU0_LOOP;

template <bool FREEZE, typename T, typename Observer, bool TC,
          typename Bounds>
__device__ __forceinline__ int march_loop(const T* __restrict__ P,
                                          const T* __restrict__ M, T& x,
                                          T& y, T& z, const T vx, const T vy,
                                          const T vz, const int steps,
                                          const T tau, Observer& observe,
                                          bool live, const Bounds& bounds) {
  const bool freeze = FREEZE && tau != static_cast<T>(0);
  int s = 0;
  for (int k = 0; k < steps; ++k) {
    if constexpr (TC) {
      if (!__any_sync(0xffffffffu, live)) break;
    }
    const T d = march_sdf<T, TC>(P, M, x, y, z, bounds);
    if (live) {
      observe(k, x, y, z, d);
      if (freeze && march_freezes(d, tau)) live = false;
    }
    if (!live) {
      if constexpr (TC) {
        continue;
      } else {
        break;
      }
    }
    march_move(x, y, z, vx, vy, vz, d);
    s = k + 1;
  }
  return s;
}

template <typename T, typename Observer, bool TC = false,
          typename Bounds = NoBounds>
__device__ __forceinline__ int march_ray(const T* __restrict__ P,
                                         const T* __restrict__ M, T& x, T& y,
                                         T& z, const T vx, const T vy,
                                         const T vz, const int steps,
                                         const T tau, Observer& observe,
                                         bool live = true,
                                         const Bounds& bounds = Bounds()) {
  if constexpr (!TC && MARCH_TAU0_LOOP) {
    if (tau == static_cast<T>(0)) {
      return march_loop<false, T, Observer, TC, Bounds>(
          P, M, x, y, z, vx, vy, vz, steps, tau, observe, live, bounds);
    }
  }
  return march_loop<true, T, Observer, TC, Bounds>(
      P, M, x, y, z, vx, vy, vz, steps, tau, observe, live, bounds);
}

// Registers a thread and blocks an SM of kernel at block threads and smem
// bytes of dynamic shared memory (cudaFuncGetAttributes and the occupancy
// query): the kernels' occupancy entries report them. Returns a
// cudaError_t.
template <typename K>
static int rm_occupancy(K kernel, int block, size_t smem, int* regs,
                        int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    *regs = attr.numRegs;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, block,
                                                        smem);
  }
  return static_cast<int>(err);
}
