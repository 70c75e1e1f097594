// Elementary device functions the generated scene SDF is built from.
//
// ray_marching_tpu_torch/scene/codegen.py lowers every primitive (sphere,
// box, plane, line, disk, torus) and combinator (affine, union, smooth
// union, rounding, onion) to a straight-line sequence of the operations
// below, in the order of the plain PyTorch SDF. Parity rules:
//  - min/max/clamp/relu are selects written as ternaries in the generated
//    code ("b < a ? b : a"), never fminf/fmaxf, which drop a NaN operand;
//  - the smooth-union max propagates NaN, as jnp.max / torch.maximum do;
//  - sqrt and division are the IEEE-rounded ones: the file is compiled
//    without --use_fast_math.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float rm_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double rm_sqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float rm_exp(float a) { return expf(a); }
__device__ __forceinline__ double rm_exp(double a) { return exp(a); }
__device__ __forceinline__ float rm_log(float a) { return logf(a); }
__device__ __forceinline__ double rm_log(double a) { return log(a); }
__device__ __forceinline__ float rm_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double rm_abs(double a) { return fabs(a); }

// Slope of abs: -1, 0 or 1 (0 at 0, as torch.sign and jnp.sign have it).
template <typename T>
__device__ __forceinline__ T rm_sign(T a) {
  return static_cast<T>((a > static_cast<T>(0)) - (a < static_cast<T>(0)));
}

// NaN-propagating max: a NaN in either operand gives NaN.
template <typename T>
__device__ __forceinline__ T rm_max_nan(T a, T b) {
  return (a > b || a != a) ? a : b;
}
