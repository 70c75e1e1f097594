// Constants both render kernels take by value, rounded to T once on the
// host (ops/render_kernel.py::_host_consts packs them: offsets 4x3
// row-major, inverse 3x3, 6/eps^2, tau).
#pragma once

template <typename T>
struct RenderConsts {
  T off[4][3];  // tetrahedral offsets, scaled by normals_eps
  T inv[3][3];  // inverse of the relative-offset matrix
  T lap_scale;  // 6 / eps^2
  T tau;        // early-exit threshold (0: march every step)
};

template <typename T>
static RenderConsts<T> unpack_consts(const T* host_consts) {
  RenderConsts<T> c;
  for (int k = 0; k < 12; ++k) c.off[k / 3][k % 3] = host_consts[k];
  for (int k = 0; k < 9; ++k) c.inv[k / 3][k % 3] = host_consts[12 + k];
  c.lap_scale = host_consts[21];
  c.tau = host_consts[22];
  return c;
}

// The k-th of five values by selects: a per-lane choice among registers (an
// array indexed by a loop variable or a lane's state would live in local
// memory).
template <typename T>
__device__ __forceinline__ T rm_pick5(int k, T a0, T a1, T a2, T a3, T a4) {
  return k == 0 ? a0 : (k == 1 ? a1 : (k == 2 ? a2 : (k == 3 ? a3 : a4)));
}
