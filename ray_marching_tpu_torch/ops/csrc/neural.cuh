// The MLP of a NeuralSDF leaf, evaluated inside the kernels: one thread per
// ray, as scene_sdf runs everywhere else.
//
// Replaces: ray_marching_tpu/scene/neural.py::neural_sdf_matmul (and
// ::neural_sdf_componentwise), which the JAX package traces into the bodies
// of pallas_render.py::_render_kernel and pallas_march.py::_march_kernel,
// with the weight matrices as whole-array VMEM inputs. The generated
// scene_sdf.cuh (scene/codegen.py) holds one neural_leaf_<k> function per
// leaf that calls the templates below with the layer sizes, activation,
// impl and operand type as compile-time constants; P is the flat parameter
// vector (biases, radius), M the packed matrix buffer (ops/params.py
// pack_mats: each W (nin, nout) row-major in a 128-aligned segment).
//
// Bound on an H100: operations. One evaluation of the width-256 leaf is
// about 1.4e5 ray-dependent operations (codegen.py counts them) against
// 12 bytes of position: f32 multiply-adds at 67 TFLOP/s bound it. This
// design does not reach that: --fmad=false splits every multiply-add into
// two instructions, and each weight row is a load.
//
// Design: a hidden vector lives in a per-thread array of max(hidden) T,
// which sits in local memory (ptxas reports it as stack). Outputs are made in
// chunks of C accumulators in registers: for each input i, h[i] is read once
// and multiplied into a row of C weights of W[i], read through __ldg with
// 16-byte vector loads where the width allows. Every thread of a warp reads
// the same weight address, so each weight load is one broadcast transaction
// from L1/L2. The w256 weights are 264 KB in f32, more than a block's 227 KB
// of shared memory, which is why they stay in global memory. The last hidden
// layer is never stored: each chunk goes through its activation and straight
// into the output layer's dot product, so a leaf with two hidden layers keeps
// one hidden vector. There are no barriers, so the kernels keep their
// per-thread early exits (pad slots, the tau > 0 break). Tensor cores are a
// later redesign.
//
// Parity with the plain version (scene/neural.py), kept deliberately:
//  - matmul impl: the products summed over i from 0, then the bias, then the
//    activation of h * w0 (layer 0 of the sine variants); componentwise: from
//    the bias, adding each product in i order. The output is
//    (sqrt(x*x + y*y + z*z) - radius) + h, in that order (generated code);
//  - sin_fast: rint (round half to even, as jnp.round), the constants rounded
//    to T once (static_cast of the double literals below, which are the
//    Python floats of scene/neural.py; a CPU test holds them equal), Horner
//    p = p * r2 + c from the top coefficient down;
//  - sine is sin (not __sinf), tanh is tanh, softplus is JAX's
//    logaddexp(v, 0): max(v, 0) + log1p(exp(-|v|)), or v + 0 where v is NaN;
//  - bf16 operands (matmul impl, T = float only): W and h rounded with
//    __float2bfloat16_rn, products and sums in f32;
//  - the torch plain version sums a matrix product in its own order, so
//    kernel and plain version differ by rounding, not bit for bit.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "sdf_prims.cuh"

enum RmAct { RM_ACT_SINE = 0, RM_ACT_SINE_FAST = 1, RM_ACT_SOFTPLUS = 2,
             RM_ACT_TANH = 3 };

// sin_fast of scene/neural.py: 1 / (2 pi), the Cody-Waite split of 2 pi and
// the odd polynomial's coefficients c0 .. c5, as doubles.
#define RM_INV_TWO_PI 0x1.45f306dc9c883p-3
#define RM_TWO_PI_HI 0x1.92p+2
#define RM_TWO_PI_LO 0x1.fb54442d18000p-10
#define RM_SIN_C0 0x1.fffff293566f6p-1
#define RM_SIN_C1 -0x1.5554bc487bef7p-3
#define RM_SIN_C2 0x1.1109432aba133p-7
#define RM_SIN_C3 -0x1.9f6aca5d11afap-13
#define RM_SIN_C4 0x1.6a597d155011ep-19
#define RM_SIN_C5 -0x1.5dd219a43ad37p-26

__device__ __forceinline__ float rm_rint(float a) { return rintf(a); }
__device__ __forceinline__ double rm_rint(double a) { return rint(a); }
__device__ __forceinline__ float rm_sin(float a) { return sinf(a); }
__device__ __forceinline__ double rm_sin(double a) { return sin(a); }
__device__ __forceinline__ float rm_tanh(float a) { return tanhf(a); }
__device__ __forceinline__ double rm_tanh(double a) { return tanh(a); }
__device__ __forceinline__ float rm_log1p(float a) { return log1pf(a); }
__device__ __forceinline__ double rm_log1p(double a) { return log1p(a); }

template <typename T>
__device__ __forceinline__ T rm_sin_fast(T x) {
  const T k = rm_rint(x * static_cast<T>(RM_INV_TWO_PI));
  const T r = (x - k * static_cast<T>(RM_TWO_PI_HI)) -
              k * static_cast<T>(RM_TWO_PI_LO);
  const T r2 = r * r;
  T p = r2 * static_cast<T>(RM_SIN_C5) + static_cast<T>(RM_SIN_C4);
  p = p * r2 + static_cast<T>(RM_SIN_C3);
  p = p * r2 + static_cast<T>(RM_SIN_C2);
  p = p * r2 + static_cast<T>(RM_SIN_C1);
  p = p * r2 + static_cast<T>(RM_SIN_C0);
  return r * p;
}

template <typename T, int ACT>
__device__ __forceinline__ T rm_act(T v) {
  if constexpr (ACT == RM_ACT_SINE) {
    return rm_sin(v);
  } else if constexpr (ACT == RM_ACT_SINE_FAST) {
    return rm_sin_fast(v);
  } else if constexpr (ACT == RM_ACT_SOFTPLUS) {
    const T zero = static_cast<T>(0);
    const T amax = rm_max_nan(v, zero);
    const T delta = v - zero;
    return delta != delta ? v + zero
                          : amax + rm_log1p(rm_exp(-rm_abs(delta)));
  } else {
    return rm_tanh(v);
  }
}

// A matrix-product operand: rounded to bf16 for the bf16 variant in f32.
template <typename T, bool BF16>
__device__ __forceinline__ T rm_operand(T v) {
  if constexpr (BF16 && std::is_same<T, float>::value) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// The query point as the first layer's input vector.
template <typename T>
struct RmXyz {
  T v[3];
  __device__ __forceinline__ T operator[](int i) const { return v[i]; }
};

// Accumulators per chunk: the largest power of two up to 32 (f32) or 16
// (f64) that divides the layer's width.
template <typename T>
__host__ __device__ constexpr int rm_chunk(int nout) {
  int c = sizeof(T) == 4 ? 32 : 16;
  while (nout % c != 0) c /= 2;
  return c;
}

// C consecutive weights of one row, through the read-only path; 16-byte
// loads when VEC (the row offset is then a multiple of 16 bytes: segments
// are 128-aligned, NOUT and the chunk start are multiples of the vector).
template <typename T, int C, bool VEC>
__device__ __forceinline__ void rm_load_row(const T* __restrict__ p,
                                            T (&w)[C]) {
  if constexpr (VEC && std::is_same<T, float>::value) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else if constexpr (VEC && std::is_same<T, double>::value) {
#pragma unroll
    for (int q = 0; q < C / 2; ++q) {
      const double2 v = __ldg(reinterpret_cast<const double2*>(p) + q);
      w[2 * q] = v.x;
      w[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] = __ldg(p + c);
  }
}

template <typename T, int NOUT, int C, bool BF16, typename In>
__device__ __forceinline__ void rm_dense_step(const T* __restrict__ W,
                                              const In& h, int i, int j0,
                                              T (&acc)[C]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr bool VEC = NOUT % V == 0 && C % V == 0;
  const T hi = rm_operand<T, BF16>(h[i]);
  T w[C];
  rm_load_row<T, C, VEC>(W + i * NOUT + j0, w);
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = acc[c] + hi * rm_operand<T, BF16>(w[c]);
}

// Outputs j0 .. j0 + C - 1 of a dense layer NIN -> NOUT before the
// activation, in the association order of the impl (see the top).
template <typename T, int NIN, int NOUT, int C, bool MATMUL, bool BF16,
          typename In>
__device__ __forceinline__ void rm_dense_chunk(const T* __restrict__ b,
                                               const T* __restrict__ W,
                                               const In& h, int j0,
                                               T (&acc)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = MATMUL ? static_cast<T>(0) : __ldg(b + j0 + c);
  }
  if constexpr (NIN <= 16) {
#pragma unroll
    for (int i = 0; i < NIN; ++i) {
      rm_dense_step<T, NOUT, C, BF16>(W, h, i, j0, acc);
    }
  } else {
#pragma unroll 2
    for (int i = 0; i < NIN; ++i) {
      rm_dense_step<T, NOUT, C, BF16>(W, h, i, j0, acc);
    }
  }
  if constexpr (MATMUL) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = acc[c] + __ldg(b + j0 + c);
  }
}

// A hidden layer NIN -> NOUT into out[0 .. NOUT): act(v * w0) with SCALE
// (layer 0 of the sine variants), act(v) otherwise.
template <typename T, int NIN, int NOUT, int ACT, bool MATMUL, bool BF16,
          bool SCALE, typename In>
__device__ __forceinline__ void rm_mlp_layer(const T* __restrict__ b,
                                             const T* __restrict__ W, T w0,
                                             const In& h, T* out) {
  constexpr int C = rm_chunk<T>(NOUT);
#pragma unroll 1
  for (int j0 = 0; j0 < NOUT; j0 += C) {
    T acc[C];
    rm_dense_chunk<T, NIN, NOUT, C, MATMUL, BF16>(b, W, h, j0, acc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[j0 + c] = rm_act<T, ACT>(SCALE ? acc[c] * w0 : acc[c]);
    }
  }
}

// The last hidden layer NIN -> NH streamed into the output layer NH -> 1:
// each chunk of hidden units goes through its activation and into the
// output's dot product in unit order, so the hidden vector is never stored.
template <typename T, int NIN, int NH, int ACT, bool MATMUL, bool BF16,
          bool SCALE, typename In>
__device__ __forceinline__ T rm_mlp_last(const T* __restrict__ b,
                                         const T* __restrict__ W, T w0,
                                         const In& h,
                                         const T* __restrict__ bo,
                                         const T* __restrict__ Wo) {
  constexpr int C = rm_chunk<T>(NH);
  T o = MATMUL ? static_cast<T>(0) : __ldg(bo);
#pragma unroll 1
  for (int j0 = 0; j0 < NH; j0 += C) {
    T acc[C];
    rm_dense_chunk<T, NIN, NH, C, MATMUL, BF16>(b, W, h, j0, acc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T a = rm_act<T, ACT>(SCALE ? acc[c] * w0 : acc[c]);
      o = o + rm_operand<T, BF16>(a) * rm_operand<T, BF16>(__ldg(Wo + j0 + c));
    }
  }
  return MATMUL ? o + __ldg(bo) : o;
}
