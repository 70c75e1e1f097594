// The scene's flat parameters where the kernels read them: in the constant
// bank, or through the caller's device pointer.
//
// The TPU kernels hold the flat parameters as one (1, p) VMEM block with a
// constant index map (pallas_render.py, pallas_backward.py): loaded once,
// read by every lane. Every read of the generated SDF and its VJP is P[k]
// with k a compile-time constant, the same address on every lane, which on
// Hopper is what the constant bank serves: a parameter is an operand of the
// FP instruction or a uniform load, and takes no vector register. Through a
// pointer the compiler loads the parameters once and keeps them in vector
// registers (14 on test_scene2).
//
// The constant route (RM_P_CONST defined, the flat vector's length, set by
// the build for a scene whose parameters fit and whose SDF holds no rolled
// loop: ops/render_kernel.py param_route; taken by a kernel source that
// defines RM_P_BANK, the backward's): the source holds a __constant__ copy
// per type, and its C entry fills it right before the launch with a
// device-to-device copy on the launch's stream, so the parameters stay
// device tensors and nothing waits on the host. The copy is ordered after
// the previous launch of the same source on any stream (an event recorded
// after each launch, which the next copy waits on, under a lock), so two
// streams cannot race on it. The kernels take scene_params(P): the copy's
// address on this route, P otherwise. Called out of line (the neural
// leaves' functions), the copy's address is a generic pointer into the
// bank's backing memory, read as global memory was before. What the bank
// buys is registers, and through them blocks an SM; it costs a uniform load
// where the compiler does not fold a parameter into its instruction, and
// the copy before each launch (about 10 µs on an H100; PERF.md).
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <type_traits>

#if defined(RM_P_CONST) && defined(RM_P_BANK)
#define RM_P_IN_BANK 1
__constant__ float rm_P_f32[RM_P_CONST];
__constant__ double rm_P_f64[RM_P_CONST];
#endif

// The parameters a kernel reads: the bank's copy on the constant route,
// where the kernel takes it (BANK), else P.
template <typename T, bool BANK = true>
__device__ __forceinline__ const T* scene_params(const T* P) {
#ifdef RM_P_IN_BANK
  if constexpr (BANK && std::is_same<T, float>::value) {
    return rm_P_f32;
  } else if constexpr (BANK) {
    return rm_P_f64;
  }
#endif
  return P;
}

#ifdef RM_P_IN_BANK
// One kernel source's lock and, per device, the event of its last launch.
constexpr int RM_P_MAX_DEVICES = 64;
struct RmParamBank {
  std::mutex mu;
  cudaEvent_t done[RM_P_MAX_DEVICES] = {};
};

template <typename T>
static RmParamBank& rm_param_bank() {
  static RmParamBank bank;
  return bank;
}
#endif

// Runs launch() (one kernel launch on st; returns the cudaError_t of the
// launch) with the scene's parameters P (device memory, RM_P_CONST values
// of T) in the constant bank on the constant route, where the kernel takes
// them (fill); launch() alone otherwise. Returns the first error.
template <typename T, typename F>
static cudaError_t rm_launch_with_params(const T* P, cudaStream_t st,
                                         F&& launch, bool fill = true) {
#ifdef RM_P_IN_BANK
  if (!fill) return launch();
  RmParamBank& bank = rm_param_bank<T>();
  std::lock_guard<std::mutex> lock(bank.mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= RM_P_MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaEvent_t& done = bank.done[dev];
  err = done ? cudaStreamWaitEvent(st, done, 0)
             : cudaEventCreateWithFlags(&done, cudaEventDisableTiming);
  if (err != cudaSuccess) return err;
  const void* symbol;
  if constexpr (std::is_same<T, float>::value) {
    symbol = rm_P_f32;
  } else {
    symbol = rm_P_f64;
  }
  err = cudaMemcpyToSymbolAsync(symbol, P, RM_P_CONST * sizeof(T), 0,
                                cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  err = launch();
  if (err != cudaSuccess) return err;
  return cudaEventRecord(done, st);
#else
  return launch();
#endif
}
