// The sphere-trace loop x' = x + d(x) * v, written once for every kernel that
// marches (render_fwd.cu, march.cu, and the position recompute and segment
// replay of render_bwd.cu), so that their trajectories cannot drift apart:
// the backward's bitwise equality with the forward's history rests on all of
// them running this one op sequence.
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
// TC (the serving forward and the march of a scene with a tensor-core MLP
// leaf, SCENE_TC in the generated header): the SDF is scene_sdf<T, true>,
// whose MLP needs every lane of the warp. The loop is then warp-masked: a
// lane that is frozen, or not live from the start (an invalid slot), keeps
// evaluating at its own unchanged position with its observer and its moves
// masked, and the warp leaves the loop when no lane is live or after steps.
// That is the JAX kernels' own semantics, and rows of the MLP's matrix
// products are independent, so every ray gets the bits of the per-ray
// break; the observer sees the same steps.
#pragma once

#include "sdf_prims.cuh"
#include "scene_sdf.cuh"

template <typename T, bool TC>
__device__ __forceinline__ T march_sdf(const T* __restrict__ P,
                                       const T* __restrict__ M, T x, T y,
                                       T z) {
#ifdef SCENE_TC
  return scene_sdf<T, TC>(P, M, x, y, z);
#else
  static_assert(!TC, "the scene has no tensor-core MLP leaf");
  return scene_sdf<T>(P, M, x, y, z);
#endif
}

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

template <typename T, typename Observer, bool TC = false>
__device__ __forceinline__ int march_ray(const T* __restrict__ P,
                                         const T* __restrict__ M, T& x, T& y,
                                         T& z, const T vx, const T vy,
                                         const T vz, const int steps,
                                         const T tau, Observer& observe,
                                         bool live = true) {
  const bool freeze = tau != static_cast<T>(0);
  int s = 0;
  for (int k = 0; k < steps; ++k) {
    if constexpr (TC) {
      if (!__any_sync(0xffffffffu, live)) break;
    }
    const T d = march_sdf<T, TC>(P, M, x, y, z);
    if (live) {
      observe(k, x, y, z, d);
      if (freeze && !(rm_abs(d) >= tau)) live = false;
    }
    if (!live) {
      if constexpr (TC) {
        continue;
      } else {
        break;
      }
    }
    x = x + d * vx;
    y = y + d * vy;
    z = z + d * vz;
    s = k + 1;
  }
  return s;
}
