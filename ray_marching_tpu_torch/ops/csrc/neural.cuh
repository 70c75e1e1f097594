// The MLP of a NeuralSDF leaf, evaluated inside the kernels: one thread per
// ray, as scene_sdf runs everywhere else; and, in the tensor-core entries
// of every kernel, warp-cooperative on the tensor cores (rm_mlp_tc and its
// VJP rm_mlp_tc_vjp, below).
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
// per-thread early exits (pad slots, the tau > 0 break). The tensor-core
// evaluation below replaces it in the tensor-core entries (f32).
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
__device__ __forceinline__ float rm_cos(float a) { return cosf(a); }
__device__ __forceinline__ double rm_cos(double a) { return cos(a); }
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

// The activation's slope at v, as its autograd backward forms it.
template <typename T, int ACT>
__device__ __forceinline__ T rm_act_slope(T v) {
  if constexpr (ACT == RM_ACT_SINE) {
    return rm_cos(v);
  } else if constexpr (ACT == RM_ACT_SINE_FAST) {
    const T k = rm_rint(v * static_cast<T>(RM_INV_TWO_PI));
    const T r = (v - k * static_cast<T>(RM_TWO_PI_HI)) -
                k * static_cast<T>(RM_TWO_PI_LO);
    const T r2 = r * r;
    T p = r2 * static_cast<T>(RM_SIN_C5) + static_cast<T>(RM_SIN_C4);
    p = p * r2 + static_cast<T>(RM_SIN_C3);
    p = p * r2 + static_cast<T>(RM_SIN_C2);
    p = p * r2 + static_cast<T>(RM_SIN_C1);
    p = p * r2 + static_cast<T>(RM_SIN_C0);
    T dp = r2 * static_cast<T>(5.0 * RM_SIN_C5) +
           static_cast<T>(4.0 * RM_SIN_C4);
    dp = dp * r2 + static_cast<T>(3.0 * RM_SIN_C3);
    dp = dp * r2 + static_cast<T>(2.0 * RM_SIN_C2);
    dp = dp * r2 + static_cast<T>(RM_SIN_C1);
    return p + static_cast<T>(2) * r2 * dp;
  } else if constexpr (ACT == RM_ACT_SOFTPLUS) {
    const T zero = static_cast<T>(0);
    const T e = rm_exp(-rm_abs(v));
    const T hinge = v > zero ? static_cast<T>(1)
                             : (v == zero ? static_cast<T>(0.5) : zero);
    return hinge + (-(e / (e + static_cast<T>(1)))) * rm_sign(v);
  } else {
    const T y = rm_tanh(v);
    return static_cast<T>(1) - y * y;
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

// ---------------------------------------------------------------------------
// The tensor-core evaluation, for the tensor-core entries (f32): the
// serving and training forwards (render_fwd.cu render_fwd_tc_kernel,
// render_fwd_train_tc_kernel), the march (march.cu march_tc_kernel) and the
// backward kernel's TC instantiation (its marches, and with KEEP its VJPs'
// primal evaluations), which all evaluate it with the same bits (with bf16
// operands, the primal's sums differ; see FRESH).
//
// Replaces, inside those kernels, the per-thread evaluation above for a
// matmul-impl leaf 3 -> N1 -> N2 -> 1 with N1 a multiple of 16 and N2 a
// multiple of 8 up to 256 (scene/codegen.py tc_leaf; the w256 field's
// 256 -> 256 layer is 65,536 of its 66,560 multiply-adds). Every other
// leaf and f64 keep the per-thread evaluation.
//
// Bound on an H100: the hidden layer's multiply-adds on the tensor cores
// (495 TFLOP/s TF32, three passes for f32 accuracy; 989 TFLOP/s bf16), the
// rest of the evaluation (layer 0, the activations, the output dot) at the
// f32 SIMT rate.
//
// Design: warp-cooperative. The 32 lanes evaluate their 32 rays together,
// so every lane of the warp must call (the masked march of march_loop.cuh
// keeps them converged). The rays are the rows of two 16-row m-tiles of
// mma.sync: one pass covers all 32 rows and NC = 128 of the N2 columns, so
// each B fragment loaded feeds both m-tiles (16 rows over all 256 columns
// per pass would load every B fragment twice per warp; it measured 8-9 %
// slower on an H100, PERF.md):
//  - layer 0 (3 -> N1, SIMT, in rm_mlp_layer's operation order) is computed
//    straight into the A fragments: each lane computes the entries it owns
//    (2 units x 4 rows per k-step) from the rays' positions, which one
//    __shfl_sync each brings; the hidden vector never goes to memory;
//  - the hidden layer N1 -> N2 runs on mma.sync: f32 in 3xTF32, each operand
//    split as hi = tf32(v), lo = tf32(v - hi) (cvt.rna) and each k-step's
//    product taken as lo*hi + hi*lo + hi*hi from zero and added to the
//    running sum in SIMT f32 (rm_mma_3xtf32; one TF32 pass keeps about 3
//    decimal digits: it moves the w256 distance by 4.8e-5, three by 2.4e-7,
//    tests/test_torch_neural_tc.py); bf16 operands
//    (matmul_dtype='bfloat16') one m16n8k16 pass, the operands rounded by
//    __float2bfloat16_rn as rm_operand rounds them;
//  - B (the weights) comes prepared by the wrapper in fragment order
//    (ops/params.py tc_fragments): one 16-byte load per lane, k-step and
//    n-tile (hi and lo of its two entries), 8 bytes for bf16, through the
//    read-only path, coalesced over the warp;
//  - the epilogue adds the bias, applies the activation to the accumulators
//    in registers (the m16n8 C layout: rows gid, gid + 8, columns 2 tig,
//    2 tig + 1), forms each lane's part of the output dot, sums the quad with
//    two shuffles and hands each ray's value to its lane. The last hidden
//    layer is never stored.
// Row r of an mma output depends only on row r of A, so a lane at a dummy or
// frozen position cannot change another ray's result, and a ray's bits do
// not depend on its warp's other rays.

#define RM_FULL_WARP 0xffffffffu

// cvt.rna.tf32.f32: 10 mantissa bits, round to nearest, ties away from zero;
// the mask clears the 13 bits below them, so the result is a float again.
__device__ __forceinline__ float rm_tf32(float v) {
  unsigned int r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

// Two floats rounded to bf16 in one register, the first in the low half.
__device__ __forceinline__ unsigned int rm_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&v);
}

// d += a b on one m16n8k8 tile, TF32 operands, f32 accumulators.
__device__ __forceinline__ void rm_mma_tf32(float (&d)[4], const float (&a)[4],
                                            float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d = a b on one m16n8k8 tile, TF32 operands: the accumulators start at
// zero (a constant C operand; no registers to clear).
__device__ __forceinline__ void rm_mma_tf32_z(float (&d)[4],
                                              const float (&a)[4], float b0,
                                              float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)), "f"(0.0f));
}

// d += a b on one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void rm_mma_bf16(float (&d)[4],
                                            const unsigned int (&a)[4],
                                            unsigned int b0, unsigned int b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// How an f32 (3xTF32) product on the tensor cores sums its k-steps. An
// mma adds its products to its C operand inside the tensor core, whose
// accumulation is not IEEE round-to-nearest: it truncates (Ootomo and
// Yokota, IJHPCA 2022, on Ampere). Chained through one accumulator tile
// over all three passes of every k-step (the first design: 96 truncations
// at the running sum's size for a 256-deep product), the w256 field's f32
// gradient lay 14x further from f64 than plain f32's. So the primal's
// hidden layer takes each k-step's three passes into a tile that starts at
// zero and adds it to the running sum in SIMT f32 (round to nearest), as
// the bf16 primal does (rm_mma_3xtf32); the VJP's W1·δ2 and the sink take
// hi·hi the same way and chain the two correction passes in a second tile,
// added at the end (rm_mma_3xtf32_split; it holds twice the accumulators,
// so a pass takes half the columns). Measured on the w256 field (H100;
// PERF.md §6 lists the other schemes tried, tools/torch_tc_variants.py
// accuracy rebuilds them): the training loss's gradient 5.7e-2 -> 8.9e-3
// from f64 (per thread 4.2e-3) for 1.32x the serving forward's time, the
// cheapest scheme to reach 1e-2; the VJP's and the sink's bring the
// converged pixels' gradient to the per-thread route's (4.4e-6 -> 2.5e-7)
// for 1.01x the backward's time, where the primal's would cost it 1.4x.

// One k-step of a 3xTF32 product on one m16n8k8 tile: lo(a)·hi(b) +
// hi(a)·lo(b) + hi(a)·hi(b) into a tile from zero, added to acc in SIMT
// f32.
__device__ __forceinline__ void rm_mma_3xtf32(float (&acc)[4],
                                              const float (&ahi)[4],
                                              const float (&alo)[4],
                                              float bhi0, float bhi1,
                                              float blo0, float blo1) {
  float t[4];
  rm_mma_tf32_z(t, alo, bhi0, bhi1);
  rm_mma_tf32(t, ahi, blo0, blo1);
  rm_mma_tf32(t, ahi, bhi0, bhi1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = acc[e] + t[e];
}

// The same k-step with the corrections lo(a)·hi(b) + hi(a)·lo(b) chained
// in cor and hi(a)·hi(b) from zero, added to acc in SIMT f32: the product
// is acc + cor after the last k-step.
__device__ __forceinline__ void rm_mma_3xtf32_split(float (&acc)[4],
                                                    float (&cor)[4],
                                                    const float (&ahi)[4],
                                                    const float (&alo)[4],
                                                    float bhi0, float bhi1,
                                                    float blo0, float blo1) {
  rm_mma_tf32(cor, alo, bhi0, bhi1);
  rm_mma_tf32(cor, ahi, blo0, blo1);
  float t[4];
  rm_mma_tf32_z(t, ahi, bhi0, bhi1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = acc[e] + t[e];
}

// Columns per pass: the largest multiple of 8 that divides n and keeps a
// lane's accumulators (cols over the two m-tiles) within cap.
__host__ __device__ constexpr int rm_tc_cols(int n, int cap = 128) {
  int c = cap;
  while (n % c != 0) c -= 8;
  return c;
}

// One unit of layer 0 at the point p before its activation, as rm_mlp_layer
// computes it (matmul impl): the products from 0 in input order, the bias,
// the scale. w = the unit's column of W0 and its bias.
template <bool BF16, bool SCALE>
__device__ __forceinline__ float rm_tc_pre0(const float (&w)[4], float w0,
                                            const float (&p)[3]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc = acc + rm_operand<float, BF16>(p[i]) * rm_operand<float, BF16>(w[i]);
  }
  acc = acc + w[3];
  return SCALE ? acc * w0 : acc;
}

// The unit's output: its activation.
template <int ACT, bool BF16, bool SCALE>
__device__ __forceinline__ float rm_tc_unit0(const float (&w)[4], float w0,
                                             const float (&p)[3]) {
  return rm_act<float, ACT>(rm_tc_pre0<BF16, SCALE>(w, w0, p));
}

template <int N1>
__device__ __forceinline__ void rm_tc_col0(const float* __restrict__ b0,
                                           const float* __restrict__ W0, int u,
                                           float (&w)[4]) {
  w[0] = __ldg(W0 + u);
  w[1] = __ldg(W0 + N1 + u);
  w[2] = __ldg(W0 + 2 * N1 + u);
  w[3] = __ldg(b0 + u);
}

// Index of the value a lane holds at (n-tile nt, m-tile mt, entry e) of a
// warp's (32 rays x N) matrix in the m16n8 C layout, in a lane's array of N.
__device__ __forceinline__ int rm_tc_ci(int nt, int mt, int e) {
  return (nt * 2 + mt) * 4 + e;
}

// The MLP 3 -> N1 -> N2 -> 1 of the 32 rays at the lanes' (x, y, z); returns
// this lane's. b0/W0, b1, b2/W2: biases and matrices as the per-thread
// evaluation reads them; F1 the prepared fragments of W1. SCALE: layer 0
// scaled by w0. Every lane of the warp must call. KEEP (the backward's
// primal evaluation): the lane's values of the last hidden layer before its
// activation go to keep[0, N2), at rm_tc_ci (keep 16-byte aligned); in
// f32 the returned distance has the same bits either way, with bf16
// operands only up to the mma's own accumulation (FRESH).
template <int N1, int N2, int ACT, bool BF16, bool SCALE, bool KEEP = false>
__device__ __forceinline__ float rm_mlp_tc(
    const float* __restrict__ b0, const float* __restrict__ W0,
    const float* __restrict__ b1, const float* __restrict__ F1,
    const float* __restrict__ b2, const float* __restrict__ W2, float w0,
    float x, float y, float z, float* keep = nullptr) {
  static_assert(N1 % 16 == 0 && N2 % 8 == 0 && N2 <= 256, "layer sizes");
  constexpr int KS = BF16 ? 16 : 8;          // k per mma
  constexpr int NC = rm_tc_cols(N2);         // columns per pass
  constexpr int NT = NC / 8;                 // n-tiles per pass
  constexpr int G = NT % 4 == 0 ? 4 : (NT % 2 == 0 ? 2 : 1);
  // bf16: each k-step's products into fresh accumulators, then added in f32
  // (round to nearest), rather than into the mma's running sum, whose own
  // accumulation truncates. The backward's primal (KEEP) needs it: there a
  // running sum drifts from the f32 sums of the plain version far enough to
  // flip the bf16 rounding of h2. Serving does not (it meets TOL_BF16
  // either way) and keeps the running sum, 15 % faster (PERF.md, PR 9).
  constexpr bool FRESH = KEEP;
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  float mine = 0.0f;
  // The rays of this lane's rows: gid and gid + 8 of each m-tile.
  float p[2][2][3];
  float o[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = mt * 16 + gid + 8 * h;
      p[mt][h][0] = __shfl_sync(RM_FULL_WARP, x, src);
      p[mt][h][1] = __shfl_sync(RM_FULL_WARP, y, src);
      p[mt][h][2] = __shfl_sync(RM_FULL_WARP, z, src);
      o[mt][h] = 0.0f;
    }
  }
#pragma unroll 1
  for (int np = 0; np < N2 / NC; ++np) {
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      }
    }
#pragma unroll 1
    for (int kt = 0; kt < N1 / KS; ++kt) {
      const long long frag = (long long)kt * (N2 / 8) + np * NT;
      if constexpr (BF16) {
        // A: rows gid / gid + 8, columns 2 tig + {0, 1} and + 8.
        unsigned int a[2][4];
        float w[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          rm_tc_col0<N1>(b0, W0, kt * 16 + 2 * tig + (c & 1) + 8 * (c >> 1),
                         w[c]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int h = r & 1;
            const int c = 2 * (r >> 1);
            a[mt][r] = rm_bf16x2(
                rm_tc_unit0<ACT, BF16, SCALE>(w[c], w0, p[mt][h]),
                rm_tc_unit0<ACT, BF16, SCALE>(w[c + 1], w0, p[mt][h]));
          }
        }
#pragma unroll
        for (int g = 0; g < NT; g += G) {
          uint2 b[G];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            b[j] = __ldg(reinterpret_cast<const uint2*>(F1) +
                         (frag + g + j) * 32 + lane);
          }
#pragma unroll
          for (int j = 0; j < G; ++j) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if constexpr (FRESH) {
                float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                rm_mma_bf16(t, a[mt], b[j].x, b[j].y);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[mt][g + j][e] = acc[mt][g + j][e] + t[e];
                }
              } else {
                rm_mma_bf16(acc[mt][g + j], a[mt], b[j].x, b[j].y);
              }
            }
          }
        }
      } else {
        // A: rows gid / gid + 8, columns tig and tig + 4, hi and lo.
        float ahi[2][4], alo[2][4];
        float w[2][4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          rm_tc_col0<N1>(b0, W0, kt * 8 + tig + 4 * c, w[c]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float v =
                rm_tc_unit0<ACT, false, SCALE>(w[r >> 1], w0, p[mt][r & 1]);
            ahi[mt][r] = rm_tf32(v);
            alo[mt][r] = rm_tf32(v - ahi[mt][r]);
          }
        }
#pragma unroll
        for (int g = 0; g < NT; g += G) {
          float4 b[G];  // hi of rows tig, tig + 4; lo of the same
#pragma unroll
          for (int j = 0; j < G; ++j) {
            b[j] = __ldg(reinterpret_cast<const float4*>(F1) +
                         (frag + g + j) * 32 + lane);
          }
#pragma unroll
          for (int j = 0; j < G; ++j) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              rm_mma_3xtf32(acc[mt][g + j], ahi[mt], alo[mt], b[j].x, b[j].y,
                            b[j].z, b[j].w);
            }
          }
        }
      }
    }
    // Bias, activation and this lane's part of the output dot, in column
    // order.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = (np * NT + nt) * 8 + 2 * tig;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + col));
      const float wo[2] = {rm_operand<float, BF16>(__ldg(W2 + col)),
                           rm_operand<float, BF16>(__ldg(W2 + col + 1))};
      float kv[8];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = acc[mt][nt][e] + (e & 1 ? bb.y : bb.x);
          const float a = rm_act<float, ACT>(v);
          kv[mt * 4 + e] = v;
          o[mt][e >> 1] = o[mt][e >> 1] + rm_operand<float, BF16>(a) * wo[e & 1];
        }
      }
      if constexpr (KEEP) {  // rm_tc_ci order: two 16-byte stores
        float4* const k4 = reinterpret_cast<float4*>(keep) + 2 * (np * NT + nt);
        k4[0] = make_float4(kv[0], kv[1], kv[2], kv[3]);
        k4[1] = make_float4(kv[4], kv[5], kv[6], kv[7]);
      }
    }
  }
  // The quad's sum (the same bits in its four lanes), the output bias,
  // and each ray's value to its lane.
  const float bo = __ldg(b2);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] = o[mt][h] + __shfl_xor_sync(RM_FULL_WARP, o[mt][h], 1);
      s[h] = s[h] + __shfl_xor_sync(RM_FULL_WARP, s[h], 2);
      s[h] = s[h] + bo;
    }
    const int r = lane & 15;
    const float lo = __shfl_sync(RM_FULL_WARP, s[0], 4 * (r & 7));
    const float hi = __shfl_sync(RM_FULL_WARP, s[1], 4 * (r & 7));
    if ((lane >> 4) == mt) mine = r < 8 ? lo : hi;
  }
  return mine;
}

// ---------------------------------------------------------------------------
// The MLP's vector-Jacobian product, for the backward kernel (render_bwd.cu).
//
// Replaces: the jax.vjp through neural_sdf_matmul (and _componentwise) that
// pallas_backward.py::_bwd_kernel and ::_bwd_kernel_2l trace into their
// bodies, with the per-tile matrix cotangents of their loop carry.
//
// The per-thread route (f64, a leaf outside tc_leaf's shape, and f32 on
// route "thread"); the tensor-core one is rm_mlp_tc_vjp at the end.
// Per thread, as the forward, in two calls: the SDF VJP's primal evaluation
// runs the forward once, keeping every hidden layer's output and its
// activation's slope in local memory (rm_mlp_layer_keep, rm_mlp_out, the
// same operations in the same order as rm_mlp_layer and rm_mlp_last, so the
// distance is the forward kernel's to the bit); once the cotangent g of the
// MLP's output is known, the VJP walks the kept layers back without
// recomputing any: δ_L = (g·Wo) ⊙ act' for the last hidden layer, then
// δ_l = (W_l·δ_{l+1}) ⊙ act', times w0 for the first layer of the sine
// variants. It returns the cotangent of the query point through the MLP
// (W0·δ1); the skip term's is generated code.
//
// Per block: the cotangent of a matrix is Σ over rays and evaluations of
// a ⊗ δ (a the layer's input), of a bias Σ δ. A thread cannot hold 66k
// entries, so every (a, δ) pair is handed to the block's sink: each thread
// stages its tile of a and δ in shared memory, and every entry of the tile
// is owned by one thread, which sums the block's rays in their order and
// adds the sum to the block's row of partials in device memory (the caller
// sums the rows over the blocks in their order). No atomics: the bits repeat
// from run to run. The sink synchronises the block, so every thread of the
// block must make the same calls in the same order: a thread with nothing to
// add (a pad slot, a step its ray never took) is inactive and stages exact
// zeros, and skips the arithmetic.
//
// Parity with the plain version (scene/neural.py mlp_vjp and autograd): the
// activation slopes are those of the autograd backwards (sin_fast's exact
// polynomial derivative in its Horner order, cos, 1 - y*y, the two branches
// of softplus with the tie of max split in half), each multiplied by the
// incoming cotangent, then by w0. Sums run in other orders than torch's,
// so kernel and plain version differ by rounding. bf16 operands (f32), the
// port's one rule (scene/neural.py): the cotangent of a layer's input is
// W_bf16·δ rounded to bf16, as the plain version's cast of the input
// differentiates; a ⊗ δ takes the bf16-rounded a and its sums stay f32,
// never rounded, in the kernel and the plain version alike.

template <typename T>
struct RmVec3 {
  T v[3];
};

// Threads per block of the backward kernel, which the sink's tiles assume.
constexpr int RM_SINK_THREADS = 128;

// Tile rows and columns staged per thread: the largest chunk of rm_chunk.
template <typename T>
__host__ __device__ constexpr int rm_sink_width() {
  return sizeof(T) == 4 ? 32 : 16;
}

// A block's matrix sink: its row of partials (the scene's scalars, then the
// packed matrices), the shared staging (RM_SINK_THREADS x (width + 1) each,
// padded against bank conflicts) and whether this thread's current
// evaluation adds anything.
template <typename T>
struct RmSink {
  T* row;
  T* sa;
  T* sd;
  bool active;
  T* tc;  // the tensor-core VJP's shared memory (rm_mlp_tc_vjp), or null
};

// Adds Σ_r A_r[i0 + ii] · D_r[jj] to w[(i0 + ii) * ld + j0 + jj] for ii < ni
// and jj < NJ, r over the block's threads in order, and when b is given and
// i0 == 0, Σ_r D_r[jj] to b[j0 + jj]. ni <= rm_sink_width<T>(). BF16: A is
// a matrix product's operand, rounded to bf16 (f32 only).
template <typename T, int NJ, bool BF16, typename A, typename D>
__device__ __forceinline__ void rm_sink_tile(const RmSink<T>& s, const A& a,
                                             int i0, int ni, const D& d,
                                             T* w, int ld, int j0, T* b) {
  constexpr int SW = rm_sink_width<T>();
  constexpr int G = RM_SINK_THREADS / NJ;
  constexpr int K = (SW + G - 1) / G;
  static_assert(NJ <= SW && RM_SINK_THREADS % NJ == 0, "tile width");
  const int t = threadIdx.x;
  const T zero = static_cast<T>(0);
  __syncthreads();
  T* sa = s.sa + t * (SW + 1);
  T* sd = s.sd + t * (SW + 1);
#pragma unroll
  for (int ii = 0; ii < SW; ++ii) {
    if (ii < ni) sa[ii] = s.active ? rm_operand<T, BF16>(a[i0 + ii]) : zero;
  }
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) sd[jj] = s.active ? d[jj] : zero;
  __syncthreads();
  const int jj = t % NJ;
  const int grp = t / NJ;
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = zero;
#pragma unroll 4
  for (int r = 0; r < RM_SINK_THREADS; ++r) {
    const T dv = s.sd[r * (SW + 1) + jj];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ii = grp + k * G;
      if (ii < ni) acc[k] = acc[k] + s.sa[r * (SW + 1) + ii] * dv;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ii = grp + k * G;
    if (ii < ni) {
      T* e = w + (long long)(i0 + ii) * ld + j0 + jj;
      *e = *e + acc[k];
    }
  }
  if (b != nullptr && i0 == 0 && grp == 0) {
    T sum = zero;
    for (int r = 0; r < RM_SINK_THREADS; ++r) {
      sum = sum + s.sd[r * (SW + 1) + jj];
    }
    b[j0 + jj] = b[j0 + jj] + sum;
  }
}

// Every tile of the rows 0 .. NIN of A against one column chunk D.
template <typename T, int NIN, int NJ, bool BF16, typename A, typename D>
__device__ __forceinline__ void rm_sink_rows(const RmSink<T>& s, const A& a,
                                             const D& d, T* w, int ld,
                                             int j0, T* b) {
  constexpr int SW = rm_sink_width<T>();
#pragma unroll 1
  for (int i0 = 0; i0 < NIN; i0 += SW) {
    rm_sink_tile<T, NJ, BF16>(s, a, i0, NIN - i0 < SW ? NIN - i0 : SW, d, w,
                              ld, j0, b);
  }
}

// A hidden layer NIN -> NOUT of the VJP's forward, as rm_mlp_layer: its
// output into out and its activation's slope into slope (both NOUT long).
template <typename T, int NIN, int NOUT, int ACT, bool MATMUL, bool BF16,
          bool SCALE, typename In>
__device__ __forceinline__ void rm_mlp_layer_keep(const T* __restrict__ b,
                                                  const T* __restrict__ W,
                                                  T w0, const In& h, T* out,
                                                  T* slope) {
  constexpr int C = rm_chunk<T>(NOUT);
#pragma unroll 1
  for (int j0 = 0; j0 < NOUT; j0 += C) {
    T acc[C];
    rm_dense_chunk<T, NIN, NOUT, C, MATMUL, BF16>(b, W, h, j0, acc);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T v = SCALE ? acc[c] * w0 : acc[c];
      out[j0 + c] = rm_act<T, ACT>(v);
      slope[j0 + c] = rm_act_slope<T, ACT>(v);
    }
  }
}

// The output layer NH -> 1 of the VJP's forward on the kept last hidden
// layer a: rm_mlp_last's dot product, in its order.
template <typename T, int NH, bool MATMUL, bool BF16>
__device__ __forceinline__ T rm_mlp_out(const T* __restrict__ bo,
                                        const T* __restrict__ Wo, const T* a) {
  T o = MATMUL ? static_cast<T>(0) : __ldg(bo);
#pragma unroll 4
  for (int j = 0; j < NH; ++j) {
    o = o + rm_operand<T, BF16>(a[j]) * rm_operand<T, BF16>(__ldg(Wo + j));
  }
  return MATMUL ? o + __ldg(bo) : o;
}

// gh[i] += Σ_c W[i, j0 + c] · dl[c] over a chunk of C columns (BF16: W
// rounded to bf16).
template <typename T, int NIN, int NOUT, int C, bool BF16, typename G>
__device__ __forceinline__ void rm_back_chunk(const T* __restrict__ W,
                                              const T (&dl)[C], int j0,
                                              G& gh) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr bool VEC = NOUT % V == 0 && C % V == 0;
#pragma unroll 2
  for (int i = 0; i < NIN; ++i) {
    T w[C];
    rm_load_row<T, C, VEC>(W + i * NOUT + j0, w);
    T sum = gh[i];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum = sum + rm_operand<T, BF16>(w[c]) * dl[c];
    }
    gh[i] = sum;
  }
}

// The cotangent of a matrix product's input, complete: rounded to bf16
// (BF16, f32 only), as the plain version's operand cast differentiates.
template <typename T, int N, bool BF16, typename G>
__device__ __forceinline__ void rm_round_cotangent(G& gh) {
  if constexpr (BF16 && std::is_same<T, float>::value) {
#pragma unroll 4
    for (int i = 0; i < N; ++i) gh[i] = rm_operand<T, true>(gh[i]);
  }
}

// δ of the last hidden layer from the output's cotangent g, into slope (NH
// long): the cotangent of the output product's operand, Wo·g (rounded to
// bf16 with BF16, as the plain version's operand cast differentiates),
// times the slope, times w0 with SCALE.
template <typename T, int NH, bool BF16, bool SCALE>
__device__ __forceinline__ void rm_mlp_delta_out(const T* __restrict__ Wo,
                                                 T g, T* slope, T w0) {
#pragma unroll 4
  for (int j = 0; j < NH; ++j) {
    const T ga = rm_operand<T, BF16>(rm_operand<T, BF16>(__ldg(Wo + j)) * g);
    const T dz = ga * slope[j];
    slope[j] = SCALE ? dz * w0 : dz;
  }
}

// A kept layer NIN -> NOUT backwards: delta (NOUT) is δ of its output, h
// (NIN) its input; gh (NIN, zeroed by the caller) receives W·δ.
template <typename T, int NIN, int NOUT, bool BF16, typename In, typename G>
__device__ __forceinline__ void rm_mlp_vjp_dense(const T* __restrict__ W,
                                                 const In& h, const T* delta,
                                                 G& gh, const RmSink<T>& s,
                                                 T* dW, T* db) {
  constexpr int C = rm_chunk<T>(NOUT);
#pragma unroll 1
  for (int j0 = 0; j0 < NOUT; j0 += C) {
    T dl[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dl[c] = s.active ? delta[j0 + c] : static_cast<T>(0);
    }
    if (s.active) rm_back_chunk<T, NIN, NOUT, C, BF16>(W, dl, j0, gh);
    rm_sink_rows<T, NIN, C, BF16>(s, h, dl, dW, NOUT, j0, db);
  }
  if (s.active) rm_round_cotangent<T, NIN, BF16>(gh);
}

// δ = (g ⊙ slope) · w0 (SCALE) into slope, N long.
template <typename T, int N, bool SCALE>
__device__ __forceinline__ void rm_mlp_delta(const T* g, T* slope, T w0) {
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    const T dz = g[j] * slope[j];
    slope[j] = SCALE ? dz * w0 : dz;
  }
}

// ---------------------------------------------------------------------------
// The MLP's VJP on the tensor cores, for the backward kernel's tensor-core
// instantiations (render_bwd.cu, TC: a scene with a tensor-core leaf, f32).
//
// Replaces, inside those instantiations, the per-thread VJP and the scalar
// tile sink above for a leaf of codegen.py's tc_leaf shape. The backward's
// primal evaluation is rm_mlp_tc with KEEP (in f32 the same bits as the
// forward's evaluation), which leaves each lane's values of the last hidden layer's
// pre-activation in the m16n8 C layout (rm_tc_ci; N2 floats a lane: a
// third of a block's resident lanes' keep arrays, 35 MB at 2 blocks an SM,
// fits the H100's L2, where h2 and s2 both did not). Once the cotangent g
// of the MLP's output is known, one call, made by every thread of the block
// in the same order (the block's 4 warps, 128 rays), does:
//  1. h2 and its slope s2 again from the kept pre-activation (the same
//     bits), δ2 = op(op(Wo)·g)·s2 kept in its place and h2·g, zeroed by a
//     select (not a product) for an inactive lane, whose values may be NaN;
//  2. db1 = Σ δ2, dW2 = Σ op(h2)·g, db2 = Σ g over the block's rays: each
//     column staged in shared memory and summed by one thread in ray order;
//  3. the point's cotangent: W1·δ2 on mma.sync, δ2 as the A operand straight
//     from its C layout (its columns 2 tig, 2 tig + 1 sit where A wants
//     columns tig, tig + 4; the wrapper prepares Wᵀ in that k order,
//     ops/params.py tc_bwd_fragments), 128 columns of N1 per pass; then, per
//     column, δ1 = (op(W1·δ2)·s1)·w0 with layer 0 evaluated again at the
//     lane's rays (rm_tc_pre0: the primal's bits), the lane's part of
//     W0·δ1, and δ1 staged for db0 = Σ δ1 and dW0 = Σ op(x) ⊗ δ1 (summed as
//     in 2);
//  4. the sink: dW1 += h1ᵀ·δ2, a product whose K dimension is the block's
//     128 rays, on mma.sync. h1 (layer 0 again, op-rounded, zeroed for an
//     inactive ray) is staged RM_TC_IC units and δ2 RM_TC_JC columns at a
//     time; each output tile belongs to one warp (m-tiles warp, warp + 4 of
//     a chunk), which adds it to the block's row: no atomics, and the
//     hardware's fixed order inside an mma, so the bits repeat;
//  5. the quad's sum of the point's cotangent, handed to each ray's lane
//     (rounded to bf16 for bf16 operands).
// Precision: every product with δ runs in TF32 with δ split as hi + lo
// (cvt.rna), so δ is never rounded to TF32 or bf16: f32 takes lo·hi + hi·lo +
// hi·hi (3xTF32, summed as rm_mma_3xtf32_split); bf16 operands (exact in TF32) take op·lo +
// op·hi, which keeps the bf16 rule (scene/neural.py): a and W rounded to
// bf16, δ and the a ⊗ δ sums f32, the input cotangents rounded.
// Bound on an H100: the three 256 x 256 products per evaluation on the
// tensor cores (495/3 TFLOP/s), the rest at the f32 SIMT rate.

// The staging of the block's sink, in floats: bufH (RM_SINK_THREADS rays x
// RM_TC_LDH: h1's chunk, or a pass of δ1, or δ2 and h2·g side by side), bufD
// (RM_SINK_THREADS x RM_TC_LDD: δ2's chunk) and the rays (x y z, their
// operands, g and whether active). Row strides of 8 mod 32 floats keep the
// fragment reads (rows tig, columns gid) free of bank conflicts.
constexpr int RM_TC_IC = 128;
constexpr int RM_TC_JC = 32;
constexpr int RM_TC_LDH = RM_TC_IC + 8;
constexpr int RM_TC_LDD = RM_TC_JC + 8;
constexpr int RM_TC_RAY = 8;
constexpr int RM_TC_SMEM_FLOATS =
    RM_SINK_THREADS * (RM_TC_LDH + RM_TC_LDD + RM_TC_RAY);
static_assert(2 * RM_SINK_THREADS * (rm_sink_width<float>() + 1) <=
                  RM_SINK_THREADS * RM_TC_LDH,
              "the scalar sink's staging fits in bufH");

// *dst += Σ over the block's rays of buf[r * ld + c], r in order.
__device__ __forceinline__ void rm_tc_col_add(const float* buf, int ld,
                                              int c, float* dst) {
  float s = 0.0f;
#pragma unroll 8
  for (int r = 0; r < RM_SINK_THREADS; ++r) s = s + buf[r * ld + c];
  *dst = *dst + s;
}

// A lane's 8 kept values of n-tile nt (both m-tiles): two 16-byte loads
// (kept is 16-byte aligned, scene_sdf_vjp's keep array).
__device__ __forceinline__ void rm_tc_load8(const float* __restrict__ kept,
                                            int nt, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(kept)[2 * nt];
  const float4 b = reinterpret_cast<const float4*>(kept)[2 * nt + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// This lane's values of n-tiles nt0 .. nt0 + cnt of its warp's (32 x N)
// matrix, kept at rm_tc_ci, into buf's rows of the warp's rays at columns
// col0 + (nt - nt0) * 8 + (the entry's column in its tile). Up to 4
// n-tiles are loaded before any is stored, so the loads overlap.
__device__ __forceinline__ void rm_tc_stage(const float* __restrict__ kept,
                                            int nt0, int cnt,
                                            float* __restrict__ buf, int ld,
                                            int col0) {
  const int lane = threadIdx.x & 31;
  float* const base = buf + ((threadIdx.x >> 5) * 32 + (lane >> 2)) * ld +
                      col0 + 2 * (lane & 3);
#pragma unroll 1
  for (int q0 = 0; q0 < cnt; q0 += 4) {
    float v[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q0 + q < cnt) rm_tc_load8(kept, nt0 + q0 + q, v[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q0 + q >= cnt) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int mt = k >> 2, e = k & 3;
        base[(mt * 16 + 8 * (e >> 1)) * ld + (q0 + q) * 8 + (e & 1)] =
            v[q][k];
      }
    }
  }
}

// v as TF32 hi + lo.
__device__ __forceinline__ void rm_tf32_split(float v, float& hi, float& lo) {
  hi = rm_tf32(v);
  lo = rm_tf32(v - hi);
}

// The VJP of the MLP 3 -> N1 -> N2 -> 1 at this lane's (x, y, z) for the
// cotangent g of its output, after rm_mlp_tc<..., KEEP> filled keep (N2):
// returns the point's cotangent and adds the block's matrix and bias
// cotangents to dW0 .. db2 in its row. B1: W1ᵀ's fragments (ops/params.py
// tc_bwd_fragments). Every thread of the block must call, in the same order.
template <int N1, int N2, int ACT, bool BF16, bool SCALE>
__device__ __forceinline__ RmVec3<float> rm_mlp_tc_vjp(
    const float* __restrict__ b0, const float* __restrict__ W0,
    const float* __restrict__ B1, const float* __restrict__ W2, float w0,
    float x, float y, float z, float g, float* keep,
    const RmSink<float>& s, float* dW0, float* db0, float* dW1, float* db1,
    float* dW2, float* db2) {
  static_assert(N1 % 16 == 0 && N2 % 8 == 0 && N2 <= 256, "layer sizes");
  // Columns of δ1 per pass (f32 holds a second tile, cor, for each).
  constexpr int NC = rm_tc_cols(N1, BF16 ? 128 : 64);
  constexpr int NT = NC / 8;
  constexpr int G = NT % 4 == 0 ? 4 : (NT % 2 == 0 ? 2 : 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int t = threadIdx.x;
  float* const bufH = s.tc;
  float* const bufD = bufH + RM_SINK_THREADS * RM_TC_LDH;
  float* const rays = bufD + RM_SINK_THREADS * RM_TC_LDD;

  __syncthreads();  // whoever used the staging before is done
  {
    float* const r = rays + t * RM_TC_RAY;
    const bool a = s.active;
    r[0] = x;
    r[1] = y;
    r[2] = z;
    r[3] = a ? rm_operand<float, BF16>(x) : 0.0f;
    r[4] = a ? rm_operand<float, BF16>(y) : 0.0f;
    r[5] = a ? rm_operand<float, BF16>(z) : 0.0f;
    r[6] = a ? g : 0.0f;
    r[7] = a ? 1.0f : 0.0f;
  }
  // The cotangent and activity of this lane's rows (gid, gid + 8 of each
  // m-tile).
  float gr[2][2];
  bool ar[2][2];
  {
    const float gs = s.active ? g : 0.0f;
    const int as = s.active ? 1 : 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int src = mt * 16 + gid + 8 * h;
        gr[mt][h] = __shfl_sync(RM_FULL_WARP, gs, src);
        ar[mt][h] = __shfl_sync(RM_FULL_WARP, as, src) != 0;
      }
    }
  }
  __syncthreads();  // the rays are staged
  // ---- 1-2. Per 64 columns: h2 and s2 again from the kept pre-activation
  // v, δ2 (kept in v's place) and h2·g, both staged side by side for db1
  // and dW2; db2 ----
#pragma unroll 1
  for (int c0 = 0; c0 < N2; c0 += 64) {
    const int cw = N2 - c0 < 64 ? N2 - c0 : 64;
    float* const base = bufH + (warp * 32 + gid) * RM_TC_LDH + 2 * tig;
#pragma unroll 1
    for (int q0 = 0; q0 < cw / 8; q0 += 2) {
      float vv[2][8];  // 2 n-tiles loaded before any store
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q0 + q < cw / 8) rm_tc_load8(keep, c0 / 8 + q0 + q, vv[q]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q0 + q >= cw / 8) continue;
        const int nt = c0 / 8 + q0 + q;
        const int col = nt * 8 + 2 * tig;
        const float wo[2] = {rm_operand<float, BF16>(__ldg(W2 + col)),
                             rm_operand<float, BF16>(__ldg(W2 + col + 1))};
        float dv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int mt = k >> 2, h = (k & 3) >> 1;
          const float v = vv[q][k];
          const float ga = rm_operand<float, BF16>(wo[k & 1] * gr[mt][h]);
          const float hg =
              rm_operand<float, BF16>(rm_act<float, ACT>(v)) * gr[mt][h];
          dv[k] = ar[mt][h] ? ga * rm_act_slope<float, ACT>(v) : 0.0f;
          float* const e = base + (mt * 16 + 8 * h) * RM_TC_LDH +
                           (q0 + q) * 8 + (k & 1);
          e[0] = dv[k];
          e[64] = ar[mt][h] ? hg : 0.0f;
        }
        float4* const kd = reinterpret_cast<float4*>(keep) + 2 * nt;
        kd[0] = make_float4(dv[0], dv[1], dv[2], dv[3]);
        kd[1] = make_float4(dv[4], dv[5], dv[6], dv[7]);
      }
    }
    __syncthreads();
    if (t < cw) {
      rm_tc_col_add(bufH, RM_TC_LDH, t, db1 + c0 + t);
    } else if (t >= 64 && t - 64 < cw) {
      rm_tc_col_add(bufH, RM_TC_LDH, t, dW2 + c0 + t - 64);
    }
    if (c0 == 0 && t == RM_SINK_THREADS - 1) {
      rm_tc_col_add(rays, RM_TC_RAY, 6, db2);
    }
    __syncthreads();
  }
  // ---- 3. W1·δ2 on the tensor cores, δ1, W0·δ1, db0 and dW0 ----
  float p[2][2][3];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* r = rays + (warp * 32 + mt * 16 + gid + 8 * h) * RM_TC_RAY;
      p[mt][h][0] = r[0];
      p[mt][h][1] = r[1];
      p[mt][h][2] = r[2];
    }
  }
  float gin[2][2][3];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 3; ++i) gin[mt][h][i] = 0.0f;
    }
  }
#pragma unroll 1
  for (int np = 0; np < N1 / NC; ++np) {
    float acc[2][NT][4], cor[2][BF16 ? 1 : NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][nt][e] = 0.0f;
          if constexpr (!BF16) cor[mt][nt][e] = 0.0f;
        }
      }
    }
    float next[8];  // δ2's n-tile kt, loaded one k-step ahead
    rm_tc_load8(keep, 0, next);
#pragma unroll 1
    for (int kt = 0; kt < N2 / 8; ++kt) {
      // A: δ2's n-tile kt, its C entries 0 2 1 3 as A's rows gid / gid + 8
      // at columns tig / tig + 4.
      float ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = (r & 1) * 2 + (r >> 1);
          rm_tf32_split(next[mt * 4 + e], ahi[mt][r], alo[mt][r]);
        }
      }
      if (kt + 1 < N2 / 8) rm_tc_load8(keep, kt + 1, next);
      const long long frag = (long long)kt * (N1 / 8) + np * NT;
#pragma unroll
      for (int g0 = 0; g0 < NT; g0 += G) {
        if constexpr (BF16) {
          float2 b[G];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            b[j] = __ldg(reinterpret_cast<const float2*>(B1) +
                         (frag + g0 + j) * 32 + lane);
          }
          // As the primal's bf16 layer: each k-step in fresh accumulators,
          // added in f32, since W1·δ2 is rounded to bf16 next.
#pragma unroll
          for (int j = 0; j < G; ++j) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              rm_mma_tf32(t, alo[mt], b[j].x, b[j].y);
              rm_mma_tf32(t, ahi[mt], b[j].x, b[j].y);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[mt][g0 + j][e] = acc[mt][g0 + j][e] + t[e];
              }
            }
          }
        } else {
          float4 b[G];  // hi of k rows 2 tig, 2 tig + 1; lo of the same
#pragma unroll
          for (int j = 0; j < G; ++j) {
            b[j] = __ldg(reinterpret_cast<const float4*>(B1) +
                         (frag + g0 + j) * 32 + lane);
          }
#pragma unroll
          for (int j = 0; j < G; ++j) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              rm_mma_3xtf32_split(acc[mt][g0 + j], cor[mt][g0 + j], ahi[mt],
                                  alo[mt], b[j].x, b[j].y, b[j].z, b[j].w);
            }
          }
        }
      }
    }
    // δ1 per column, the lane's part of W0·δ1, and δ1 staged.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int u = np * NC + nt * 8 + 2 * tig + c;
        float w[4];
        rm_tc_col0<N1>(b0, W0, u, w);
        const float wi[3] = {rm_operand<float, BF16>(w[0]),
                             rm_operand<float, BF16>(w[1]),
                             rm_operand<float, BF16>(w[2])};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float sum = acc[mt][nt][2 * h + c];
            if constexpr (!BF16) sum = sum + cor[mt][nt][2 * h + c];
            const float gh = rm_operand<float, BF16>(sum);
            const float v = rm_tc_pre0<BF16, SCALE>(w, w0, p[mt][h]);
            const float dz = gh * rm_act_slope<float, ACT>(v);
            const float d1 = ar[mt][h] ? (SCALE ? dz * w0 : dz) : 0.0f;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              gin[mt][h][i] = gin[mt][h][i] + wi[i] * d1;
            }
            bufH[(warp * 32 + mt * 16 + gid + 8 * h) * RM_TC_LDH + nt * 8 +
                 2 * tig + c] = d1;
          }
        }
      }
    }
    __syncthreads();
    if (t < NC) {
      const int u = np * NC + t;
      float sb = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
      for (int r = 0; r < RM_SINK_THREADS; ++r) {
        const float d = bufH[r * RM_TC_LDH + t];
        const float* q = rays + r * RM_TC_RAY;
        sb = sb + d;
        s0 = s0 + q[3] * d;
        s1 = s1 + q[4] * d;
        s2 = s2 + q[5] * d;
      }
      db0[u] = db0[u] + sb;
      dW0[u] = dW0[u] + s0;
      dW0[N1 + u] = dW0[N1 + u] + s1;
      dW0[2 * N1 + u] = dW0[2 * N1 + u] + s2;
    }
    __syncthreads();
  }
  // ---- 4. the sink: dW1 += h1ᵀ·δ2, K = the block's rays ----
#pragma unroll 1
  for (int i0 = 0; i0 < N1; i0 += RM_TC_IC) {
    const int iw = N1 - i0 < RM_TC_IC ? N1 - i0 : RM_TC_IC;
    // h1 of the warp's rays at units i0 .. i0 + iw, one unit per lane.
#pragma unroll 1
    for (int uu = lane; uu < iw; uu += 32) {
      float w[4];
      rm_tc_col0<N1>(b0, W0, i0 + uu, w);
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        const float* q = rays + (warp * 32 + r) * RM_TC_RAY;
        const float pp[3] = {q[0], q[1], q[2]};
        const float h = rm_operand<float, BF16>(
            rm_tc_unit0<ACT, BF16, SCALE>(w, w0, pp));
        bufH[(warp * 32 + r) * RM_TC_LDH + uu] = q[7] != 0.0f ? h : 0.0f;
      }
    }
    const int mts = iw / 16;
#pragma unroll 1
    for (int j0 = 0; j0 < N2; j0 += RM_TC_JC) {
      const int jw = N2 - j0 < RM_TC_JC ? N2 - j0 : RM_TC_JC;
      const int nts = jw / 8;
      rm_tc_stage(keep, j0 / 8, nts, bufD, RM_TC_LDD, 0);
      __syncthreads();
      float acc[2][RM_TC_JC / 8][4], cor[2][BF16 ? 1 : RM_TC_JC / 8][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int nt = 0; nt < RM_TC_JC / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[q][nt][e] = 0.0f;
            if constexpr (!BF16) cor[q][nt][e] = 0.0f;
          }
        }
      }
#pragma unroll 1
      for (int kt = 0; kt < RM_SINK_THREADS / 8; ++kt) {
        const float* h0 = bufH + (kt * 8 + tig) * RM_TC_LDH;
        const float* h1 = h0 + 4 * RM_TC_LDH;
        const float* d0 = bufD + (kt * 8 + tig) * RM_TC_LDD;
        const float* d1 = d0 + 4 * RM_TC_LDD;
        // B: δ2 at rays (k) tig / tig + 4, column (n) gid of each n-tile.
        float bhi[RM_TC_JC / 8][2], blo[RM_TC_JC / 8][2];
#pragma unroll
        for (int nt = 0; nt < RM_TC_JC / 8; ++nt) {
          if (nt < nts) {
            rm_tf32_split(d0[nt * 8 + gid], bhi[nt][0], blo[nt][0]);
            rm_tf32_split(d1[nt * 8 + gid], bhi[nt][1], blo[nt][1]);
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int mt = warp + 4 * q;
          if (mt >= mts) continue;
          // A: h1ᵀ, units (m) gid / gid + 8 at rays (k) tig / tig + 4.
          const float a[4] = {h0[mt * 16 + gid], h0[mt * 16 + gid + 8],
                              h1[mt * 16 + gid], h1[mt * 16 + gid + 8]};
          // Each pass over the independent tiles before the next.
          if constexpr (BF16) {
#pragma unroll
            for (int nt = 0; nt < RM_TC_JC / 8; ++nt) {
              if (nt < nts) {
                rm_mma_tf32(acc[q][nt], a, blo[nt][0], blo[nt][1]);
              }
            }
#pragma unroll
            for (int nt = 0; nt < RM_TC_JC / 8; ++nt) {
              if (nt < nts) {
                rm_mma_tf32(acc[q][nt], a, bhi[nt][0], bhi[nt][1]);
              }
            }
          } else {
            float ahi[4], alo[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) rm_tf32_split(a[r], ahi[r], alo[r]);
#pragma unroll
            for (int nt = 0; nt < RM_TC_JC / 8; ++nt) {
              if (nt < nts) {
                rm_mma_3xtf32_split(acc[q][nt], cor[q][nt], ahi, alo,
                                    bhi[nt][0], bhi[nt][1], blo[nt][0],
                                    blo[nt][1]);
              }
            }
          }
        }
      }
      // Every old value of the warp's tiles is loaded before any store.
      float old[2][RM_TC_JC / 8][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int mt = warp + 4 * q;
#pragma unroll
        for (int nt = 0; nt < RM_TC_JC / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (mt < mts && nt < nts) {
              old[q][nt][e] = dW1[(long long)(i0 + mt * 16 + gid +
                                              8 * (e >> 1)) * N2 +
                                  j0 + nt * 8 + 2 * tig + (e & 1)];
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int mt = warp + 4 * q;
#pragma unroll
        for (int nt = 0; nt < RM_TC_JC / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (mt < mts && nt < nts) {
              float sum = acc[q][nt][e];
              if constexpr (!BF16) sum = sum + cor[q][nt][e];
              dW1[(long long)(i0 + mt * 16 + gid + 8 * (e >> 1)) * N2 + j0 +
                  nt * 8 + 2 * tig + (e & 1)] = old[q][nt][e] + sum;
            }
          }
        }
      }
      __syncthreads();  // bufD (and, last, bufH) free again
    }
  }
  // ---- 5. the point's cotangent: the quad's sum, to each ray's lane ----
  RmVec3<float> out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float mine = 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float sv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sv[h] = gin[mt][h][i] + __shfl_xor_sync(RM_FULL_WARP, gin[mt][h][i], 1);
        sv[h] = sv[h] + __shfl_xor_sync(RM_FULL_WARP, sv[h], 2);
      }
      const int r = lane & 15;
      const float lo = __shfl_sync(RM_FULL_WARP, sv[0], 4 * (r & 7));
      const float hi = __shfl_sync(RM_FULL_WARP, sv[1], 4 * (r & 7));
      if ((lane >> 4) == mt) mine = r < 8 ? lo : hi;
    }
    out.v[i] = rm_operand<float, BF16>(mine);
  }
  return out;
}
