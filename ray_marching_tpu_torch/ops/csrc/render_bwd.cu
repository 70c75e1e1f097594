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
// partials (blocks, SCENE_N_SCALARS + SCENE_MAT_SIZE) = each ray block's
// share of the parameter cotangent (the flat scalars in compact order, then
// the packed matrices of the neural leaves), summed over the blocks by the
// caller. Invalid slots (valid <= 0.5) get zero cotangents and add nothing.
//
// What it computes, per ray:
//  1. the march positions, in one of three ways: read from the history the
//     forward wrote; recomputed here (the same op sequence, march_ray of
//     march_loop.cuh, so the same bits) into the block's scratch slot; or,
//     TWO_LEVEL, recomputed keeping only every CKPT_INTERVAL-th position in
//     the block's slot, each segment marched again from its checkpoint when
//     the sweep reaches it. The segment's CKPT_INTERVAL positions live in
//     the thread's local memory (an array the sweep indexes by its loop
//     variable);
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
// never read: every position comes from the history. What binds the
// per-thread f32 kernel is neither: a sweep step is one VJP, about 450 SASS
// instructions on test_scene2 in a dependent chain through its IEEE square
// roots and divisions (13 MUFU, --fmad=false), and at five blocks an SM its
// loops issued about half the card's rate (PERF.md §6): the latency
// of that chain, which only more warps hide.
//
// Design: one thread per ray slot, every plane access coalesced. Each
// thread keeps the parameter cotangent of the scalars the scene really has
// in registers; a block sums them with warp shuffles and shared memory in a
// fixed order and writes its ray block's row of partials, so the result is
// the same from run to run and whichever way the positions were obtained
// (no atomics).
//
// Scratch (the TPU kernels' per-tile VMEM history and checkpoints): a launch
// that recomputes (the recompute, TWO_LEVEL and MARCH_ONLY) runs a
// persistent grid, as many blocks as the SMs hold at the instantiation's
// occupancy (rm_render_bwd_resident) and no more than there are ray blocks;
// block b walks the ray blocks b, b + gridDim.x, ... and owns slot b of
// the caller's scratch, (steps + 1, 3, BWD_BLOCK) positions or, TWO_LEVEL,
// (steps / CKPT_INTERVAL, 3, BWD_BLOCK) checkpoints, lane-minor, so every
// access stays coalesced and the scratch of a launch (33.5 MB at 1080p,
// 32 steps, f32) lives mostly in the 50 MB L2, whatever the frame size. The
// forward's history stays plane-major (steps + 1, 3, plane); the sweep reads
// either through a base and a component stride. Every thread of a block
// runs the same trips, so the block's barriers hold. With the forward's
// history there is no scratch and the grid is one block per ray block. The
// TPU kernels' unrolled sweep is not carried over.
//
// Per-thread instantiations: the launch bounds fit the registers to
// more blocks an SM for an SDF without a rolled loop (bwd_min_blocks, from
// the build): the f32 history path to RM_BWD_HIST_BLOCKS, the recompute and
// the march-only mode to RM_BWD_OWN_BLOCKS, one fewer with TRACK_MIN, with
// no spill. What makes the room: the scene's parameters come from the
// constant bank (scene_params.cuh; through a pointer the compiler holds
// them in registers, 14 on test_scene2), and the sweep loads each step's
// position right before its VJP (the prefetch of the next one took three
// registers; more warps hide the load). On the bank the two-level
// instantiation ran 17 % slower, so it keeps the pointer and BWD_MIN_BLOCKS;
// so does a rolled loop, whose VJP needs 128 registers (PERF.md). Unrolled
// by two (the next step's primal beside this step's adjoint) the sweep
// measured slower; the tail's offsets and cotangents stay in small local
// arrays indexed by its loop (80 B of stack; selects in their place
// measured no faster and the two-level mode 1.8 % slower, PERF.md). A scene
// whose SDF holds a rolled loop (the bulb's iterations) brings a
// checkpointed VJP (scene/codegen.py): a 10 x 5-value tape per thread and
// one copy of the body's recompute and adjoint, where the unrolled VJP held
// every primal value of ten iterations live at once (255 registers and
// ~1.7 KB of spill stores a thread before).
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
//
// The union short-circuit (SCENE_PRUNE): the recompute and the two-level
// checkpoints march on scene_sdf_fwd with scene_bounds computed just before
// the march (march_loop.cuh), so they give the pruned forward's positions,
// which are the unpruned ones; the history path computes no bounds. The
// segment replays, the tail's evaluations, the min_f tie test, every VJP
// and the march-only mode keep the plain SDF: pruned replays inside the
// sweep made the two-level backward 2.4 % slower on test_scene2 at 1080p,
// where plain ones make it 0.7 % faster than the unpruned kernel (PERF.md,
// tools/torch_prune_variants.py).
//
// TC (f32, a scene with a tensor-core MLP leaf, SCENE_TC): the same kernel
// with the MLP on the tensor cores (neural.cuh): every march (the
// recompute, the two-level checkpoints and segment replays) is the
// warp-masked one of march_loop.cuh on rm_mlp_tc, so its positions are the
// tensor-core forwards' (render_fwd_train_tc_kernel, march_tc_kernel) bit
// for bit, and an invalid lane marches masked where it stands; every SDF
// evaluation of the tail and the min_f ties takes the same MLP; every VJP
// is rm_mlp_tc_vjp, whose matrix sink (h1ᵀ·δ2 over the block's rays) runs
// on mma.sync out of RM_TC_SMEM_FLOATS of dynamic shared memory, which the
// scalar sink of any per-thread leaf shares. Every lane of the block
// takes part in every evaluation and VJP. Bound on an H100: the VJP's
// three 256 x 256 products per evaluation on the tensor cores.
#include <cuda_runtime.h>

#include <limits>
#include <type_traits>

// The scene's parameters in the constant bank on the constant route
// (scene_params.cuh), but for the two-level instantiation. The marches keep
// the one loop at tau = 0 (march_loop.cuh): the second one cost the
// marching instantiations registers and no time (PERF.md).
#define RM_P_BANK 1
#undef RM_MARCH_TAU0_LOOP
#include "neural.cuh"
#include "march_loop.cuh"
#include "render_consts.cuh"

constexpr int BWD_BLOCK = 128;
// Blocks of BWD_BLOCK threads an SM must hold for the per-thread (neither
// SYNC nor TC) instantiations in f64, the two-level one and those of an SDF
// with a rolled loop: ptxas fits their registers to it, 128 at most, which
// the bulb's checkpointed VJP (its body's recompute and adjoint live at
// once) needs to run without a spill; at five (96 registers) it spills. The
// SYNC and TC ones leave it to ptxas.
constexpr int BWD_MIN_BLOCKS = 4;
// The same for the other per-thread f32 instantiations, of an SDF without a
// rolled loop, from the build (ops/render_kernel.py scene_flags):
// RM_BWD_HIST_BLOCKS for the history path, RM_BWD_OWN_BLOCKS for the
// recompute and the march-only mode, one fewer with TRACK_MIN (the min_f
// tie test's evaluation and carry). On the constant bank they fit without
// a spill, and the latency of each step's VJP chain hides behind more warps
// (PERF.md).
#ifndef RM_BWD_HIST_BLOCKS
#define RM_BWD_HIST_BLOCKS BWD_MIN_BLOCKS
#endif
#ifndef RM_BWD_OWN_BLOCKS
#define RM_BWD_OWN_BLOCKS BWD_MIN_BLOCKS
#endif
// Whether the per-thread instantiations' reverse sweep loads the next step's
// history position before the current step's VJP (a register double buffer;
// the same bits). Its three registers cost more than it hides once an SM
// holds more blocks (PERF.md).
constexpr bool BWD_PREFETCH = false;
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
  // The forward's (steps + 1, 3, plane), or (OWN, not TWO_LEVEL) the
  // scratch slots (grid, steps + 1, 3, BWD_BLOCK).
  T* hist;
  T* ckpt;           // TWO_LEVEL: (grid, steps / CKPT_INTERVAL, 3, BWD_BLOCK)
  const T* minf;     // the forward's min_f plane (history given, TRACK_MIN)
  const int* amin;   // the forward's arg-min step (history given, TRACK_MIN)
  const int* nlive;  // the forward's live-step count (history given)
  T* out;            // (6, plane)
  T* partials;       // (blocks, ROW)
  long long plane;
  int steps;
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
// TC: the tensor-core MLP and its VJP (every thread of the block calls).
template <typename T, bool TC>
__device__ __noinline__ T sdf_vjp_sync(const T* __restrict__ P,
                                       const T* __restrict__ M, T x, T y, T z,
                                       T g, T& gx, T& gy, T& gz, T* gP,
                                       const RmSink<T>& sink) {
#ifdef SCENE_TC
  return scene_sdf_vjp<T, TC>(P, M, x, y, z, g, gx, gy, gz, gP, sink);
#else
  static_assert(!TC, "the scene has no tensor-core MLP leaf");
  return scene_sdf_vjp<T>(P, M, x, y, z, g, gx, gy, gz, gP, sink);
#endif
}

// The scene's SDF VJP; with neural leaves it also feeds the block's sink.
template <typename T, bool TC>
__device__ __forceinline__ T sdf_vjp(const T* __restrict__ P,
                                     const T* __restrict__ M, T x, T y, T z,
                                     T g, T& gx, T& gy, T& gz, T* gP,
                                     const RmSink<T>& sink) {
  if constexpr (SYNC) {
    return sdf_vjp_sync<T, TC>(P, M, x, y, z, g, gx, gy, gz, gP, sink);
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
template <typename T, bool TC>
__device__ __forceinline__ void sweep_step(const T* __restrict__ P,
                                           const T* __restrict__ M, T px, T py,
                                           T pz, T gd, bool live, T& gx, T& gy,
                                           T& gz, T& gvx, T& gvy, T& gvz,
                                           T* gP, const RmSink<T>& sink) {
  T sx, sy, sz;
  const T d = sdf_vjp<T, TC>(P, M, px, py, pz, gd, sx, sy, sz, gP, sink);
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

// The blocks an SM an instantiation's launch bounds ask for.
template <typename T, bool TRACK_MIN, bool TWO_LEVEL, bool TC, bool OWN>
constexpr int bwd_min_blocks() {
  if (SYNC || TC) return 1;
  if (TWO_LEVEL || sizeof(T) != 4) return BWD_MIN_BLOCKS;
  const int blocks = OWN ? RM_BWD_OWN_BLOCKS : RM_BWD_HIST_BLOCKS;
  return TRACK_MIN && blocks > BWD_MIN_BLOCKS ? blocks - 1 : blocks;
}

// OWN: the positions are marched here into the block's scratch slot (the
// recompute, TWO_LEVEL, MARCH_ONLY) and the grid is persistent; otherwise
// they are the forward's history and the grid is one block per ray block,
// so the loop over ray blocks runs once. Two instantiations, so that the
// history path's addressing is fixed at compile time: chosen at run time it
// takes more registers, and an SM then holds one block fewer.
template <typename T, bool TRACK_MIN, bool TWO_LEVEL, bool MARCH_ONLY, bool TC,
          bool OWN>
__global__ void __launch_bounds__(
    BWD_BLOCK, bwd_min_blocks<T, TRACK_MIN, TWO_LEVEL, TC, OWN>())
render_bwd_kernel(BwdArgs<T> a, RenderConsts<T> c, T big) {
  static_assert(OWN || !(TWO_LEVEL || MARCH_ONLY), "they march their own");
  a.P = scene_params<T, !TWO_LEVEL>(a.P);
  const long long plane = a.plane;
  const long long n_blocks = (plane + BWD_BLOCK - 1) / BWD_BLOCK;
  const T zero = static_cast<T>(0);
  const T half = static_cast<T>(0.5);
#pragma unroll 1
  for (long long blk = blockIdx.x; blk < n_blocks;
       blk += OWN ? gridDim.x : n_blocks) {
    // The previous ray block's readers of shared memory (the block sum below,
    // the sink, block_max) are done before this one writes it.
    if (OWN && blk != blockIdx.x) __syncthreads();
    const long long i = blk * BWD_BLOCK + threadIdx.x;
    T gP[N_ACC];
#pragma unroll
    for (int k = 0; k < N_ACC; ++k) gP[k] = zero;
    const bool valid = i < plane && a.rays[6 * plane + i] > static_cast<T>(0.5);
    if (i < plane && !valid) {
      for (int k = 0; k < 6; ++k) a.out[k * plane + i] = zero;
    }
    // The block's matrix sink (SYNC only; otherwise every thread that runs a
    // VJP is active and nothing reads the rest).
    RmSink<T> sink = {nullptr, nullptr, nullptr, true, nullptr};
    if constexpr (SYNC) {
      constexpr int SW = rm_sink_width<T>() + 1;
      if constexpr (TC) {
        // The tensor-core VJP's staging, dynamic (RM_TC_SMEM_FLOATS); the
        // scalar sink of any per-thread leaf stages at its start.
        extern __shared__ __align__(16) unsigned char rm_tc_smem[];
        T* const dyn = reinterpret_cast<T*>(rm_tc_smem);
        sink.sa = dyn;
        sink.sd = dyn + RM_SINK_THREADS * SW;
        sink.tc = dyn;
      } else {
        __shared__ T sa[RM_SINK_THREADS * SW];
        __shared__ T sd[RM_SINK_THREADS * SW];
        sink.sa = sa;
        sink.sd = sd;
      }
      sink.row = a.partials + blk * ROW;
      // Ordered before the first addition by the sink's first barrier.
      for (long long k = threadIdx.x; k < ROW; k += BWD_BLOCK) {
        sink.row[k] = zero;
      }
    }
    // In SYNC every thread walks the body; skip marks an invalid one there.
    const bool skip = SYNC && !valid;
    if (valid || SYNC) {
      const int steps = a.steps;
      const T vx = a.rays[3 * plane + i];
      const T vy = a.rays[4 * plane + i];
      const T vz = a.rays[5 * plane + i];
      // This block's scratch slot: n_pos positions (3, BWD_BLOCK) each, the
      // history with recompute, the checkpoints with TWO_LEVEL.
      const long long n_pos = TWO_LEVEL ? steps / CKPT_INTERVAL : steps + 1;
      T* const slot =
          (TWO_LEVEL ? a.ckpt : a.hist) + blockIdx.x * (n_pos * 3 * BWD_BLOCK);
      // Where the positions live: the forward's history, plane-major, at ray
      // i; or the slot, lane-minor, at the thread's lane. hs is a
      // component's stride, 3 * hs a step's.
      constexpr bool IN_SLOT = OWN && !TWO_LEVEL;
      const long long hs = IN_SLOT ? BWD_BLOCK : plane;
      const long long hi = IN_SLOT ? (long long)threadIdx.x : i;
      T* const hbase = IN_SLOT ? slot : a.hist;
      // The terminal position's entry of the history (not used by TWO_LEVEL).
      T* hend = TWO_LEVEL ? nullptr : hbase + steps * 3 * hs;
      T x, y, z;  // terminal position
      T minf = big;
      int amin = -1;
      int nlive;
      if (TWO_LEVEL) {
        x = a.rays[i];
        y = a.rays[plane + i];
        z = a.rays[2 * plane + i];
        CheckpointObserver<T> keep = {slot, BWD_BLOCK, threadIdx.x};
        const auto B = march_bounds<T>(a.P);
        if constexpr (TC) {
          nlive = march_ray<T, CheckpointObserver<T>, true>(
              a.P, a.M, x, y, z, vx, vy, vz, steps, zero, keep, !skip, B);
        } else {
          nlive = skip ? 0
                       : march_ray<T>(a.P, a.M, x, y, z, vx, vy, vz, steps,
                                      zero, keep, true, B);
        }
      } else if (OWN) {
        x = a.rays[i];
        y = a.rays[plane + i];
        z = a.rays[2 * plane + i];
        HistoryObserver<T, TRACK_MIN> seen = {hbase, hs, hi, big, -1,
                                              x,     y,  z};
        // The march-only mode keeps march.cu's plain SDF.
        const auto B = march_bounds<T, !MARCH_ONLY>(a.P);
        if constexpr (TC) {
          nlive = march_ray<T, HistoryObserver<T, TRACK_MIN>, true>(
              a.P, a.M, x, y, z, vx, vy, vz, steps, c.tau, seen, !skip, B);
        } else {
          nlive = skip ? 0
                       : march_ray<T>(a.P, a.M, x, y, z, vx, vy, vz, steps,
                                      c.tau, seen, true, B);
        }
        minf = seen.minf;
        amin = seen.amin;
        hend[hi] = x;
        hend[hs + hi] = y;
        hend[2 * hs + hi] = z;
      } else {
        x = hend[hi];
        y = hend[hs + hi];
        z = hend[2 * hs + hi];
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
        sdf_vjp<T, TC>(a.P, a.M, x, y, z, a.g[3 * plane + i], sx, sy, sz, gP,
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
          if constexpr (TC) {
            const T v = march_sdf<T, true>(a.P, a.M, x + ox[k], y + oy[k],
                                           z + oz[k]);
            f[k] = skip ? zero : v;
          } else {
            f[k] = skip ? zero
                        : scene_sdf<T>(a.P, a.M, x + ox[k], y + oy[k],
                                       z + oz[k]);
          }
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
        const T gnorm =
            -(g4 * ((nx / norm) / norm) + g5 * ((ny / norm) / norm) +
              g6 * ((nz / norm) / norm));
        const T gs = gnorm / (static_cast<T>(2) * norm);
        const T gnx = g4 / norm + (gs * nx + gs * nx);
        const T gny = g5 / norm + (gs * ny + gs * ny);
        const T gnz = g6 / norm + (gs * nz + gs * nz);
        const T gd1 = c.inv[0][0] * gnx + c.inv[1][0] * gny + c.inv[2][0] * gnz;
        const T gd2 = c.inv[0][1] * gnx + c.inv[1][1] * gny + c.inv[2][1] * gnz;
        const T gd3 = c.inv[0][2] * gnx + c.inv[1][2] * gny + c.inv[2][2] * gnz;
        // lap = (d_centre - mean4) * lap_scale,
        // mean4 = (f0 + f1 + f2 + f3) / 4.
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
          sdf_vjp<T, TC>(a.P, a.M, x + ox[k], y + oy[k], z + oz[k], gf[k], sx,
                         sy, sz, gP, sink);
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
          const T* ck = slot + seg * (3 * BWD_BLOCK);
          T rx[CKPT_INTERVAL], ry[CKPT_INTERVAL], rz[CKPT_INTERVAL];
          const int t = threadIdx.x;
          T px = skip ? zero : ck[t];
          T py = skip ? zero : ck[BWD_BLOCK + t];
          T pz = skip ? zero : ck[2 * BWD_BLOCK + t];
          // The segment's last step is not marched: the sweep needs the
          // position before it, not after. The replay keeps the plain SDF
          // (the head comment says why); the positions are the same.
          ReplayObserver<T> replay = {rx, ry, rz};
          if constexpr (TC) {
            march_ray<T, ReplayObserver<T>, true>(a.P, a.M, px, py, pz, vx, vy,
                                                  vz, CKPT_INTERVAL - 1, zero,
                                                  replay, !skip);
          } else if (!skip) {
            march_ray<T>(a.P, a.M, px, py, pz, vx, vy, vz, CKPT_INTERVAL - 1,
                         zero, replay);
          }
          rx[CKPT_INTERVAL - 1] = px;
          ry[CKPT_INTERVAL - 1] = py;
          rz[CKPT_INTERVAL - 1] = pz;
#pragma unroll 1
          for (int j = CKPT_INTERVAL - 1; j >= 0; --j) {
            const T gd = gx * vx + gy * vy + gz * vz;
            sweep_step<T, TC>(a.P, a.M, skip ? zero : rx[j],
                              skip ? zero : ry[j], skip ? zero : rz[j], gd,
                              true, gx, gy, gz, gvx, gvy, gvz, gP, sink);
          }
        }
      } else {
        T carry = TRACK_MIN ? a.g[8 * plane + i] : zero;
        const int n = TRACK_MIN ? (skip ? 0 : steps) : nlive;
        int n_sweep = n;
        if constexpr (SYNC) n_sweep = block_max(n);
        // The position before step s: the history's, or the terminal one for
        // a step after the ray froze (the lane's entries, 3 * hs apart a
        // step from hl; the terminal one steps on, computed where it is
        // read: a pointer held through the loop cost registers).
        const T* const hl = hbase + hi;
        auto at = [&](int s) {
          return hl + (s < nlive ? s : steps) * (3 * hs);
        };
        constexpr bool PREFETCH = BWD_PREFETCH && !SYNC && !TC;
        T px = zero, py = zero, pz = zero;
        if (PREFETCH && n_sweep > 0) {
          const T* h = at(n_sweep - 1);
          px = h[0];
          py = h[hs];
          pz = h[2 * hs];
        }
#pragma unroll 1
        for (int s = n_sweep - 1; s >= 0; --s) {
          sink.active = !skip && s < n;
          const bool live = s < nlive;
          T qx, qy, qz;  // the next step's position, loaded ahead of this VJP
          {
            const T* h = at(PREFETCH ? (s > 0 ? s - 1 : 0) : s);
            qx = h[0];
            qy = h[hs];
            qz = h[2 * hs];
          }
          if (!PREFETCH) {
            px = qx;
            py = qy;
            pz = qz;
          }
          T gd = live ? gx * vx + gy * vy + gz * vz : zero;
          if (TRACK_MIN) {
            T d;
            if constexpr (TC) {
              const T v = march_sdf<T, true>(a.P, a.M, px, py, pz);
              d = sink.active ? v : zero;
            } else {
              d = (!SYNC || sink.active) ? scene_sdf<T>(a.P, a.M, px, py, pz)
                                         : zero;
            }
            const bool first = amin == s;
            const bool tie = d == minf && !first;
            gd = gd + (first ? carry : (tie ? half * carry : zero));
            carry = first ? zero : (tie ? half * carry : carry);
          }
          sweep_step<T, TC>(a.P, a.M, px, py, pz, gd, live, gx, gy, gz, gvx,
                            gvy, gvz, gP, sink);
          px = qx;
          py = qy;
          pz = qz;
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
        a.partials[blk * ROW + SCENE_ACC_SCALAR[k]] = s;
      } else {
        a.partials[blk * SCENE_N_SCALARS + k] = s;
      }
    }
  }
}

enum BwdMode { BWD_FULL = 0, BWD_TWO_LEVEL = 1, BWD_MARCH_ONLY = 2 };

// One instantiation's kernel and its dynamic shared memory: TC ones take
// the tensor-core VJP's, which the kernel is allowed here.
template <typename T, bool TRACK_MIN, bool TWO_LEVEL, bool MARCH_ONLY, bool TC,
          bool OWN>
static cudaError_t prepare(void (**kernel)(BwdArgs<T>, RenderConsts<T>, T),
                           size_t* smem) {
  *kernel = render_bwd_kernel<T, TRACK_MIN, TWO_LEVEL, MARCH_ONLY, TC, OWN>;
  *smem = 0;
#ifdef SCENE_TC
  if constexpr (TC) {
    *smem = RM_TC_SMEM_FLOATS * sizeof(float);
    return cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
#endif
  return cudaSuccess;
}

// One instantiation's launch on grid blocks.
template <typename T, bool TRACK_MIN, bool TWO_LEVEL, bool MARCH_ONLY, bool TC,
          bool OWN>
static void launch_one(unsigned int grid, BwdArgs<T> a,
                       const RenderConsts<T>& c, T big, cudaStream_t st) {
  void (*kernel)(BwdArgs<T>, RenderConsts<T>, T);
  size_t smem;
  const cudaError_t err =
      prepare<T, TRACK_MIN, TWO_LEVEL, MARCH_ONLY, TC, OWN>(&kernel, &smem);
  if (err != cudaSuccess) return;  // cudaGetLastError reports it
  kernel<<<grid, BWD_BLOCK, smem, st>>>(a, c, big);
}

// The blocks of one instantiation the card holds at once: its SMs times the
// blocks an SM holds at the instantiation's registers and shared memory
// (dynamic included). A launch that needs scratch takes at most as many.
template <typename T, bool TRACK_MIN, bool TWO_LEVEL, bool MARCH_ONLY, bool TC,
          bool OWN>
static cudaError_t resident_one(long long* blocks) {
  void (*kernel)(BwdArgs<T>, RenderConsts<T>, T);
  size_t smem;
  cudaError_t err =
      prepare<T, TRACK_MIN, TWO_LEVEL, MARCH_ONLY, TC, OWN>(&kernel, &smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        BWD_BLOCK, smem);
  }
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// Calls f(TRACK_MIN, TWO_LEVEL, MARCH_ONLY, OWN) with the flags of the
// instantiation that runs mode (as std::bool_constant values); own: the
// full mode recomputes (the other modes always do).
template <typename F>
static auto by_mode(int mode, int track_min, int own, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (mode == BWD_TWO_LEVEL) return f(N{}, Y{}, N{}, Y{});
  if (mode == BWD_MARCH_ONLY) return f(N{}, N{}, Y{}, Y{});
  if (track_min) return own ? f(Y{}, N{}, N{}, Y{}) : f(Y{}, N{}, N{}, N{});
  return own ? f(N{}, N{}, N{}, Y{}) : f(N{}, N{}, N{}, N{});
}

template <typename T, bool TC>
static int launch(BwdArgs<T> a, int mode, int track_min, int recompute,
                  long long n_blocks, long long grid, long long n_cols,
                  const RenderConsts<T>& c, void* stream) {
  if (n_cols != ROW || n_blocks != (a.plane + BWD_BLOCK - 1) / BWD_BLOCK ||
      (a.M == nullptr) != (SCENE_N_MLP == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The forward's history: one block per ray block. Scratch: at most one
  // slot per ray block.
  const bool scratch = mode != BWD_FULL || recompute;
  if (grid < 1 || grid > n_blocks || (!scratch && grid != n_blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode != BWD_FULL && track_min) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == BWD_TWO_LEVEL &&
      (c.tau != static_cast<T>(0) || a.steps % CKPT_INTERVAL != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (TC && a.plane % BWD_BLOCK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T big = std::numeric_limits<T>::max();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rm_launch_with_params(a.P, st, [&] {
    by_mode(mode, track_min, recompute, [&](auto tm, auto tl, auto mo,
                                             auto own) {
      launch_one<T, decltype(tm)::value, decltype(tl)::value,
                 decltype(mo)::value, TC, decltype(own)::value>(
          (unsigned int)grid, a, c, big, st);
      return 0;
    });
    return cudaGetLastError();
  }, mode != BWD_TWO_LEVEL));
}

// Plain C interface (bound with ctypes). partials is (n_blocks, n_cols)
// with n_blocks = ceil(plane / rm_render_bwd_block()) and n_cols the
// scene's scalar count plus its packed matrix size; M is the packed matrix
// buffer, null exactly when the scene has no neural leaf. grid is the
// number of blocks to launch: n_blocks with the forward's history; with
// scratch (the recompute, two levels, the march-only mode) 1 .. n_blocks,
// as a rule min(n_blocks, rm_render_bwd_resident), and the scratch holds
// grid slots. A mismatch returns cudaErrorInvalidValue. Every entry returns
// the cudaError_t of the launch (0 on success).
extern "C" int rm_render_bwd_block() { return BWD_BLOCK; }
#ifdef SCENE_TC
// Dynamic shared memory of the tensor-core instantiations, bytes per block.
extern "C" int rm_render_bwd_tc_smem() {
  return RM_TC_SMEM_FLOATS * (int)sizeof(float);
}
#endif

// The blocks the current device holds at once of the instantiation that
// marches again in mode (0 the recompute, 1 two levels, 2 the march-only
// mode) with track_min, in f64 or f32, on the tensor cores (tc, f32 only):
// written to *blocks. Returns a cudaError_t (0 on success).
extern "C" int rm_render_bwd_resident(int f64, int tc, int mode,
                                      int track_min, long long* blocks) {
  if (mode < BWD_FULL || mode > BWD_MARCH_ONLY ||
      (mode != BWD_FULL && track_min)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(by_mode(mode, track_min, 1, [&](auto tm, auto tl,
                                                         auto mo, auto) {
    constexpr bool TM = decltype(tm)::value, TL = decltype(tl)::value,
                   MO = decltype(mo)::value;
#ifdef SCENE_TC
    if (tc) {
      return f64 ? cudaErrorInvalidValue
                 : resident_one<float, TM, TL, MO, true, true>(blocks);
    }
#else
    if (tc) return cudaErrorInvalidValue;
#endif
    return f64 ? resident_one<double, TM, TL, MO, false, true>(blocks)
               : resident_one<float, TM, TL, MO, false, true>(blocks);
  }));
}

// Registers a thread and blocks an SM (of BWD_BLOCK threads) of the
// per-thread instantiation that runs mode (0 the full backward, 1 two
// levels, 2 the march-only mode) with track_min, own (the full backward:
// its recompute; otherwise the forward's history), in f64 or f32. Returns a
// cudaError_t (0 on success).
extern "C" int rm_render_bwd_occupancy(int f64, int mode, int track_min,
                                       int own, int* regs, int* blocks) {
  if (mode < BWD_FULL || mode > BWD_MARCH_ONLY ||
      (mode != BWD_FULL && track_min)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return by_mode(mode, track_min, own, [&](auto tm, auto tl, auto mo,
                                           auto ow) {
    constexpr bool TM = decltype(tm)::value, TL = decltype(tl)::value,
                   MO = decltype(mo)::value, OW = decltype(ow)::value;
    void (*k32)(BwdArgs<float>, RenderConsts<float>, float);
    void (*k64)(BwdArgs<double>, RenderConsts<double>, double);
    size_t smem;
    cudaError_t err =
        f64 ? prepare<double, TM, TL, MO, false, OW>(&k64, &smem)
            : prepare<float, TM, TL, MO, false, OW>(&k32, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return f64 ? rm_occupancy(k64, BWD_BLOCK, smem, regs, blocks)
               : rm_occupancy(k32, BWD_BLOCK, smem, regs, blocks);
  });
}

// Backward of render_fwd.cu. g has 9 planes when track_min is set, else 8.
// hist is the forward's history (steps + 1, 3, plane) (recompute = 0; then
// nlive and, with track_min, minf and amin are the forward's planes) or an
// uninitialised scratch of grid slots (grid, steps + 1, 3, BWD_BLOCK)
// (recompute = 1; the three may be null). With two_level set, hist and the
// three are null and ckpt is an uninitialised scratch (grid, steps /
// RM_CKPT_INTERVAL, 3, BWD_BLOCK). host_consts as in render_fwd.cu.
#define RM_BWD_ENTRY(NAME, T, TC)                                            \
  extern "C" int NAME(const T* P, const T* M, const T* rays, const T* g,     \
                      int track_min, T* hist, int recompute, T* ckpt,        \
                      int two_level, const T* minf, const int* amin,         \
                      const int* nlive, T* out, T* partials,                 \
                      long long n_blocks, long long grid, long long n_cols,  \
                      long long plane, int steps, const T* host_consts,      \
                      void* stream) {                                        \
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
    return launch<T, TC>(a, two_level ? BWD_TWO_LEVEL : BWD_FULL,            \
                         track_min, recompute, n_blocks, grid, n_cols,       \
                         unpack_consts<T>(host_consts), stream);             \
  }

RM_BWD_ENTRY(rm_render_bwd_f32, float, false)
RM_BWD_ENTRY(rm_render_bwd_f64, double, false)
#ifdef SCENE_TC
// The same on the tensor cores (f32): M is the packed matrix buffer followed
// by the forward's and the backward's tensor-core fragments (ops/params.py
// pack_tc with backward); plane a multiple of 128.
RM_BWD_ENTRY(rm_render_bwd_tc_f32, float, true)
#endif

// Backward of march.cu: g has 4 planes (x y z d); hist is an uninitialised
// scratch of grid slots (grid, steps + 1, 3, BWD_BLOCK) the kernel fills
// with its own recompute of the march. tau arrives as a double and is
// rounded to T here, as march.cu rounds it.
#define RM_MARCH_BWD_ENTRY(NAME, T, TC)                                      \
  extern "C" int NAME(const T* P, const T* M, const T* rays, const T* g,     \
                      T* hist, T* out, T* partials, long long n_blocks,      \
                      long long grid, long long n_cols, long long plane,     \
                      int steps, double tau, void* stream) {                 \
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
    RenderConsts<T> c = {};                                                  \
    c.tau = static_cast<T>(tau);                                             \
    return launch<T, TC>(a, BWD_MARCH_ONLY, 0, 1, n_blocks, grid, n_cols, c, \
                         stream);                                            \
  }

RM_MARCH_BWD_ENTRY(rm_march_bwd_f32, float, false)
RM_MARCH_BWD_ENTRY(rm_march_bwd_f64, double, false)
#ifdef SCENE_TC
RM_MARCH_BWD_ENTRY(rm_march_bwd_tc_f32, float, true)
#endif
