// Support shared by the speculative chunk-parallel FSM kernels
// (peak_fsm.cu, fastrak_fsm.cu): int32 arithmetic that wraps, the warp's
// lane masks and its exchange of a whole state, the opt-in to dynamic
// shared memory above 48 KB, and the launch of the passes in order with
// their error checks. Each FSM keeps its step, its check of a guess and
// its record layout in its own file.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace spec_fsm {

constexpr unsigned kAll = 0xffffffffu;

// int32 addition and subtraction that wrap, as the JAX package's do
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// lanes lo..hi-1 of a warp
__device__ __forceinline__ unsigned lanes(int lo, int hi) {
  const unsigned below_hi = hi >= 32 ? kAll : (1u << hi) - 1u;
  return below_hi & ~((1u << lo) - 1u);
}

__device__ __forceinline__ int top_lane(unsigned m) { return 31 - __clz(m); }

// a value of 4-byte words (a scalar or an FSM's state) from lane `src`,
// word by word; every lane of the warp takes part
template <typename T>
__device__ __forceinline__ T from_lane(const T& v, int src) {
  static_assert(sizeof(T) % 4 == 0, "a value of 4-byte words");
  int w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 4); ++i)
    w[i] = __shfl_sync(kAll, w[i], src);
  T r;
  memcpy(&r, w, sizeof(T));
  return r;
}

// the same from the lane below (lane 0 keeps its own)
template <typename T>
__device__ __forceinline__ T from_lane_below(const T& v) {
  static_assert(sizeof(T) % 4 == 0, "a value of 4-byte words");
  int w[sizeof(T) / 4];
  memcpy(w, &v, sizeof(T));
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 4); ++i)
    w[i] = __shfl_up_sync(kAll, w[i], 1);
  T r;
  memcpy(&r, w, sizeof(T));
  return r;
}

// dynamic shared memory above 48 KB is opted into on every launch that
// needs it; above the 227 KB a block may hold is refused
template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// each pass (a callable that launches one kernel) in turn, stopped at the
// first launch error; returns the CUDA error code
template <typename... Pass>
int launch_passes(Pass&&... pass) {
  cudaError_t e = cudaSuccess;
  auto run = [&e](auto& launch) {
    if (e != cudaSuccess) return;
    launch();
    e = cudaGetLastError();
  };
  (run(pass), ...);
  return static_cast<int>(e);
}

}  // namespace spec_fsm
