// The WBFM audio tail, one launch a Block: the fixed-ratio MMSE fractional
// resampler's step (FractionalResampler.apply) and the FM deemphasis
// (FMDeemphasis.apply). Their plain versions (ops/resampler.py
// resample_step_plain over resample_block, ops/demod.py deemphasis_plain over
// iir.onepole_scan) launch ~33 and ~66 small PyTorch kernels a block; the
// arithmetic is microseconds at the audio rate, so the host's launches were
// the whole cost.
//
// resample_kernel: output k interpolates frame[idx_k .. idx_k + 7] (frame =
// the carried 7-sample tail, then the new block, read in place) with the
// 8-tap MMSE row of its phase bin, at the exact 32.32 position
//     full_k = mu_frac + k * inc_frac   (unsigned 64-bit, exact for k < 2^32)
//     idx_k  = mu_int + k * inc_int + (full_k >> 32),  frac_k = u32(full_k)
//     bin_k  = ((frac_k >> 1) + 2^23) >> 24
// as exact.fixed_positions and exact.frac_to_phase_bin compute them. Output
// k is valid iff its window fits the valid samples, idx_k <= n_valid - 1
// (n_valid = min(count, n)); the invalid slots are zeros. The positions
// never decrease (inc >= 0: ratio_to_fixed refuses a ratio <= 0), so the
// valid outputs are a prefix and the one thread at its end writes the count
// n_out and the next position (idx_{n_out} - n, frac_{n_out}); with no valid
// output thread 0 writes them from position 0. One thread an output, a grid
// that follows the capacity; the taps table (129 x 8 floats) is staged in
// shared memory by each block; block 0 also writes the new tail (the frame's
// last 7 samples).
//
// deemphasis_kernel: y[n] = b0 x[n] + b1 x[n-1] + a y[n-1] (x[-1] = x_prev,
// y[-1] = y_prev; b0, b1 and the pole rounded to float32 as the plain
// version does) over a count-prefix block: the samples from `count` on take
// y[count-1], and a block of count 0 holds both states. One block of 1024
// threads walks the valid samples in tiles of 8192, each staged in shared
// memory by coalesced loads; each thread takes 8 consecutive samples of the
// tile: pass 1 folds them into the affine map y -> A y + B (A = a^8), the
// maps are scanned over the block (warp shuffles, then the 32 warp totals
// in shared memory), pass 2 runs the samples again from the state entering
// them and leaves y in shared memory, and coalesced stores write it out;
// the tile's whole map carries the state into the next tile. At the WBFM
// chains' 17478 samples a launch takes 9.6 us on an H100; a thread reading
// its chunk straight from global memory took 20 us (each load of a warp
// touched a line a lane). Either is far below the host's ~1 ms of launches
// it replaces.
// Every product and sum is float32 (FMA in the recurrence); the plain
// version's log-step doubling scan sums in another order.
//
// Plain C interface (bound from Python with ctypes): each entry point
// returns the CUDA error code of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 8;
constexpr int kHist = kTaps - 1;
constexpr int kBins = 129;   // phase bins 0..128, the last the next sample
constexpr int kShift = 24;   // 32 - log2(128) - 1
constexpr int kResThreads = 256;
constexpr int kDeThreads = 1024;
constexpr int kWarps = kDeThreads / 32;
constexpr int kRun = 8;   // consecutive samples a thread scans in a tile
constexpr int kTile = kDeThreads * kRun;
constexpr int kTileSlots = kTile + kTile / 32;  // with a pad every 32
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T frame_at(const T* __restrict__ tail,
                                      const T* __restrict__ x, long long p) {
  return p < kHist ? tail[p] : x[p - kHist];
}

__device__ __forceinline__ float mac(float acc, float v, float t) {
  return __fmaf_rn(v, t, acc);
}

__device__ __forceinline__ float2 mac(float2 acc, float2 v, float t) {
  return make_float2(__fmaf_rn(v.x, t, acc.x), __fmaf_rn(v.y, t, acc.y));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }

// the exact position of output k: its window start, and its fraction
__device__ __forceinline__ long long position(long long k, long long mu_int,
                                              unsigned long long mu_frac,
                                              long long inc_int,
                                              unsigned long long inc_frac,
                                              unsigned* frac) {
  const unsigned long long full =
      mu_frac + static_cast<unsigned long long>(k) * inc_frac;
  *frac = static_cast<unsigned>(full & 0xffffffffull);
  return mu_int + k * inc_int + static_cast<long long>(full >> 32);
}

template <typename T>
__global__ void __launch_bounds__(kResThreads)
    resample_kernel(const T* __restrict__ x, const T* __restrict__ tail, int n,
                    const int* __restrict__ count,
                    const int* __restrict__ mu_int,
                    const long long* __restrict__ mu_frac,
                    const int* __restrict__ inc_int,
                    const long long* __restrict__ inc_frac,
                    const float* __restrict__ taps, int cap,
                    T* __restrict__ y, int* __restrict__ n_out,
                    int* __restrict__ new_mu_int,
                    long long* __restrict__ new_mu_frac,
                    T* __restrict__ new_tail) {
  __shared__ float s_taps[kBins * kTaps];
  for (int i = threadIdx.x; i < kBins * kTaps; i += blockDim.x)
    s_taps[i] = taps[i];
  if (blockIdx.x == 0 && threadIdx.x < kHist)
    new_tail[threadIdx.x] =
        frame_at(tail, x, n + static_cast<int>(threadIdx.x));
  const long long n_valid = min(*count, n);
  const long long mi = *mu_int, ii = *inc_int;
  const unsigned long long mf = static_cast<unsigned long long>(*mu_frac) &
                                0xffffffffull;
  const unsigned long long fi = static_cast<unsigned long long>(*inc_frac) &
                                0xffffffffull;
  __syncthreads();
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (k >= cap) return;
  unsigned frac;
  const long long idx = position(k, mi, mf, ii, fi, &frac);
  const bool valid = idx <= n_valid - 1;
  T acc = zero<T>();
  if (valid) {
    const unsigned bin = ((frac >> 1) + (1u << (kShift - 1))) >> kShift;
    const float* t = s_taps + kTaps * bin;
    const long long base = idx < 0 ? 0 : (idx > n - 1 ? n - 1 : idx);
#pragma unroll
    for (int i = 0; i < kTaps; ++i) acc = mac(acc, frame_at(tail, x, base + i),
                                              t[i]);
  }
  y[k] = acc;
  unsigned frac1;
  const long long idx1 = position(k + 1, mi, mf, ii, fi, &frac1);
  const bool next_valid = k + 1 < cap && idx1 <= n_valid - 1;
  if (valid && !next_valid) {
    *n_out = static_cast<int>(k + 1);
    *new_mu_int = static_cast<int>(idx1 - n);
    *new_mu_frac = static_cast<long long>(frac1);
  } else if (k == 0 && !valid) {
    *n_out = 0;
    *new_mu_int = static_cast<int>(idx - n);
    *new_mu_frac = static_cast<long long>(frac);
  }
}

// the map y -> a2 (a1 y + b1) + b2 of (a1, b1) then (a2, b2), into (a2, b2)
__device__ __forceinline__ void after(float a1, float b1, float& a2,
                                      float& b2) {
  b2 = __fmaf_rn(a2, b1, b2);
  a2 = __fmul_rn(a1, a2);
}

// inclusive scan of the lanes' maps over the warp, lane 0 first
__device__ __forceinline__ void warp_scan(float& a, float& b, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const float pa = __shfl_up_sync(kFull, a, d);
    const float pb = __shfl_up_sync(kFull, b, d);
    if (lane >= d) after(pa, pb, a, b);
  }
}

__device__ __forceinline__ float feed(float b0, float b1, float xi,
                                      float prev) {
  return __fadd_rn(__fmul_rn(b0, xi), __fmul_rn(b1, prev));
}

// sample i of a tile in shared memory, a padding slot after every 32: the
// warp's 32 lanes then hit 32 distinct banks both where each lane reads its
// own kRun consecutive samples and where the lanes read 32 consecutive ones
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kDeThreads)
    deemphasis_kernel(const float* __restrict__ x, int n,
                      const int* __restrict__ count,
                      const float* __restrict__ y_prev,
                      const float* __restrict__ x_prev, float b0, float b1,
                      float a, float* __restrict__ y,
                      float* __restrict__ new_y_prev,
                      float* __restrict__ new_x_prev) {
  __shared__ float s_x[kTileSlots];
  __shared__ float s_a[kWarps], s_b[kWarps];
  __shared__ float s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = max(min(*count, n), 0);
  const float y0 = *y_prev, xp = *x_prev;
  float carry = y0;  // the state entering the tile, the same in every thread
  for (int t0 = 0; t0 < cnt; t0 += kTile) {
    const int m = min(kTile, cnt - t0);  // the tile's valid samples
    for (int i = tid; i < m; i += kDeThreads) s_x[padded(i)] = x[t0 + i];
    __syncthreads();
    // pass 1: the thread's samples [lo, hi) of the tile as one map
    const int lo = min(tid * kRun, m), hi = min(lo + kRun, m);
    const float prev0 =
        lo > 0 ? s_x[padded(lo - 1)] : (t0 > 0 ? x[t0 - 1] : xp);
    float ca = 1.f, cb = 0.f, prev = prev0;
    for (int i = lo; i < hi; ++i) {
      const float xi = s_x[padded(i)];
      cb = __fmaf_rn(a, cb, feed(b0, b1, xi, prev));
      ca = __fmul_rn(ca, a);
      prev = xi;
    }
    warp_scan(ca, cb, lane);
    // the lanes before this one, as one map (identity for lane 0)
    float ea = __shfl_up_sync(kFull, ca, 1), eb = __shfl_up_sync(kFull, cb, 1);
    if (lane == 0) {
      ea = 1.f;
      eb = 0.f;
    }
    if (lane == 31) {
      s_a[warp] = ca;
      s_b[warp] = cb;
    }
    __syncthreads();
    if (warp == 0) {
      float wa = s_a[lane], wb = s_b[lane];
      warp_scan(wa, wb, lane);
      s_a[lane] = wa;
      s_b[lane] = wb;
    }
    __syncthreads();
    // pass 2 from the state entering the thread's samples: the carry through
    // the warps before, then the lanes before; y over x in shared memory
    float z = warp > 0 ? __fmaf_rn(s_a[warp - 1], carry, s_b[warp - 1])
                       : carry;
    z = __fmaf_rn(ea, z, eb);
    prev = prev0;
    for (int i = lo; i < hi; ++i) {
      const float xi = s_x[padded(i)];
      z = __fmaf_rn(a, z, feed(b0, b1, xi, prev));
      s_x[padded(i)] = z;
      prev = xi;
    }
    if (t0 + hi == cnt && lo < hi) s_last = z;
    carry = __fmaf_rn(s_a[kWarps - 1], carry, s_b[kWarps - 1]);
    __syncthreads();
    for (int i = tid; i < m; i += kDeThreads) y[t0 + i] = s_x[padded(i)];
    __syncthreads();
  }
  const float last = cnt > 0 ? s_last : y0;
  for (int i = cnt + tid; i < n; i += kDeThreads) y[i] = last;
  if (tid == 0) {
    *new_y_prev = last;
    *new_x_prev = cnt > 0 ? x[cnt - 1] : xp;
  }
}
}  // namespace

extern "C" int fractional_resample(const void* x, const void* tail,
                                   int is_complex, int n, const int* count,
                                   const int* mu_int,
                                   const long long* mu_frac,
                                   const int* inc_int,
                                   const long long* inc_frac,
                                   const float* taps, int cap, void* y,
                                   int* n_out, int* new_mu_int,
                                   long long* new_mu_frac, void* new_tail,
                                   void* stream) {
  if (n < 1 || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((cap + kResThreads - 1) /
                                                kResThreads);
  if (is_complex) {
    resample_kernel<float2><<<blocks, kResThreads, 0, s>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(tail), n,
        count, mu_int, mu_frac, inc_int, inc_frac, taps, cap,
        static_cast<float2*>(y), n_out, new_mu_int, new_mu_frac,
        static_cast<float2*>(new_tail));
  } else {
    resample_kernel<float><<<blocks, kResThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(tail), n,
        count, mu_int, mu_frac, inc_int, inc_frac, taps, cap,
        static_cast<float*>(y), n_out, new_mu_int, new_mu_frac,
        static_cast<float*>(new_tail));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fm_deemphasis(const float* x, int n, const int* count,
                             const float* y_prev, const float* x_prev,
                             float b0, float b1, float a, float* y,
                             float* new_y_prev, float* new_x_prev,
                             void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  deemphasis_kernel<<<1, kDeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, count, y_prev, x_prev, b0, b1, a, y, new_y_prev, new_x_prev);
  return static_cast<int>(cudaGetLastError());
}
