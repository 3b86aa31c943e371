// The block scan of csrc/acars_fsm.cu and csrc/manchester_fsm.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bscan {

constexpr unsigned kFull = 0xFFFFFFFFu;

// The exclusive prefix sum of every thread's `v` in thread order, over a
// block of `threads` threads (a multiple of 32, at most 1024); `total`
// gets the sum. `scratch` holds 33 ints of shared memory. Every thread of
// the block calls it; it ends with the block synchronised.
__device__ __forceinline__ int exclusive_sum(int v, int* scratch, int threads,
                                             int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int warps = threads >> 5;
    int t = lane < warps ? scratch[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    scratch[lane] = t;          // inclusive over warps
    if (lane == 31) scratch[32] = t;
  }
  __syncthreads();
  const int before = warp ? scratch[warp - 1] : 0;
  total = scratch[32];
  __syncthreads();
  return before + x - v;
}

}  // namespace bscan
