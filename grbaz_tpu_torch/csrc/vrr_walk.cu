// Ratio-stream resampler: the exact 32.32 position walk and the 8-tap MMSE
// interpolation of VariableRatioResampler, one block a call.
//
// Replaces the per-output lax.scan of VariableRatioResampler.apply
// (grbaz_tpu/ops/resampler.py:315, the scan at :397). Output k
// interpolates frame[q_k .. q_k + 7] (frame = the carried 7-sample tail,
// then the new block) with the taps of the phase bin of mu_k, then the
// walk reads the ratio stream AT the window start: inc = rr[q_k],
// ip = floor(inc), fr = u32((inc - ip) * 2^32), and (q, mu) += (ip, fr)
// with the carry out of mu. The walk stops at the first slot whose window
// does not fit the valid samples (q + 8 > count + 7); the JAX scan holds
// q from there, so the later slots are zeros.
//
// What bounds it: not the bytes (x and rr read once, y written once:
// about 1 MB for a 2^16-sample f32 block, 0.3 us) but the walk. Its
// increment is read at the position it produces, so no prefix sum or
// speculation gives the positions (the walk neither forgets nor runs
// over a fixed sequence): one thread walks them, one dependent step an
// output. This design keeps that step short and lets the rest run beside
// it:
//   * the ratio stream is turned into 64-bit steps (ip << 32) + fr, a tile
//     of 4096 at a time, in shared memory, with explicit floorf,
//     __fsub_rn, __fmul_rn and __float2uint_rz so that nvcc contracts
//     nothing: the position (q << 32) + mu then advances by one 64-bit add
//     of a shared-memory word, the add carrying mu's overflow into q
//     exactly as the JAX scan's compare does;
//   * thread 0 walks, writing each output's window start and phase bin to
//     one of two output buffers in shared memory, until the position
//     leaves the tile, the buffer fills, or the window no longer fits.
//     Where the tile's largest step (reduced while its table is built)
//     shows that the next eight positions stay in the tile and in the
//     valid samples, it takes them without a check, and the chain is the
//     load and the add alone;
//   * meanwhile warps 1-7 interpolate the other output buffer (taps from a
//     shared copy of the 129 x 8 table) and build the next tile's table in
//     the other table buffer; a step that jumps past the next tile has
//     its tile built by the whole block before the walk goes on.
// So the time is about (outputs) x (one dependent step from shared
// memory), plus one barrier a phase. `vrr_chain_probe` times that step
// alone.
//
// Inputs: x (float or float2 by `is_complex`) [n] and its tail [7], rr
// float [n] and its tail [7], the state q (int32) and mu (uint32 in an
// int64) and the block's count (int32), all on the card. Outputs: y
// [cap], out int [4] = (count, new q = max(q_end - n, 0), mu bits,
// overran = q_end < n), the new tails (the frame's last 7 samples).
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 8;
constexpr int kHist = kTaps - 1;
constexpr int kBins = 129;   // phase bins 0..128, the last the next sample
constexpr int kShift = 24;   // 32 - log2(128) - 1
constexpr int kThreads = 256;
constexpr int kPosTile = 4096;  // ratio samples a tile
constexpr int kOutTile = 4096;  // outputs a tile
constexpr int kRun = 8;         // steps the walker takes without a check

struct Smem {
  float taps[kBins * kTaps];
  long long step[2][kPosTile];     // two tiles of the ratio stream's steps
  long long step_max[2], step_min[2];
  int tile[2];                     // the tile each table holds
  int q[2][kOutTile];              // two buffers of walked outputs
  int bin[2][kOutTile];
  int walked[2], first[2];         // their count and first output's index
  long long pos;                   // the walker's position, between phases
  int done;
  int pending;                     // the other table awaits its tile's steps
};

// the phase bin of a 32-bit fraction, rounded as exact.frac_to_phase_bin
__device__ __forceinline__ int bin_of(unsigned mu) {
  return static_cast<int>(((mu >> 1) + (1u << (kShift - 1))) >> kShift);
}

template <typename T>
__device__ __forceinline__ T frame_at(const T* __restrict__ tail,
                                      const T* __restrict__ x, int p) {
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

// the 64-bit step of one ratio sample: (floor(inc) << 32) + the fraction's
// 32 bits, as the JAX scan computes them in float32
__device__ __forceinline__ long long step_of(float inc) {
  const float ip = floorf(inc);
  const unsigned fr = __float2uint_rz(__fmul_rn(__fsub_rn(inc, ip),
                                                4294967296.f));
  return (static_cast<long long>(__float2int_rz(ip)) << 32) +
         static_cast<long long>(fr);
}

// the steps of tile `tile` (positions base + tile * kPosTile on) into
// table `b`, with their largest and smallest step, by threads [t0, t0 + nt)
__device__ __forceinline__ void build_tile(Smem& sm, int b, int tile,
                                           int base, int frame_n,
                                           const float* __restrict__ rr,
                                           const float* __restrict__ rr_tail,
                                           int t0, int nt) {
  const int tid = threadIdx.x - t0;
  const int p0 = base + tile * kPosTile;
  long long smax = LLONG_MIN, smin = LLONG_MAX;
  for (int i = tid; i < kPosTile; i += nt) {
    const int p = p0 + i;
    if (p >= 0 && p < frame_n) {
      const long long st = step_of(frame_at(rr_tail, rr, p));
      sm.step[b][i] = st;
      smax = max(smax, st);
      smin = min(smin, st);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
    smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
  }
  if ((tid & 31) == 0) {
    atomicMax(&sm.step_max[b], smax);
    atomicMin(&sm.step_min[b], smin);
  }
}

// interpolate buffer `ob`'s walked outputs into y, threads [t0, t0 + nt)
template <typename T>
__device__ __forceinline__ void interpolate(const Smem& sm, int ob,
                                            const T* __restrict__ x,
                                            const T* __restrict__ tail,
                                            T* __restrict__ y, int t0,
                                            int nt) {
  const int k0 = sm.first[ob], walked = sm.walked[ob];
  for (int j = threadIdx.x - t0; j < walked; j += nt) {
    const int q = sm.q[ob][j];
    const float* t = sm.taps + kTaps * sm.bin[ob][j];
    T acc = zero<T>();
#pragma unroll
    for (int i = 0; i < kTaps; ++i) acc = mac(acc, frame_at(tail, x, q + i), t[i]);
    y[k0 + j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vrr_kernel(const T* __restrict__ x, const T* __restrict__ tail,
               const float* __restrict__ rr,
               const float* __restrict__ rr_tail, int n,
               const int* __restrict__ q0, const long long* __restrict__ mu0,
               const int* __restrict__ count, int cap,
               const float* __restrict__ taps, T* __restrict__ y,
               int* __restrict__ out, T* __restrict__ new_tail,
               float* __restrict__ new_rr_tail) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int frame_n = kHist + n;
  const int hi = frame_n - kTaps;               // the last window start
  const int limit = min(max(count[0], 0), n) + kHist;
  const int base = min(max(q0[0], 0), max(hi, 0));  // tile 0's first position
  for (int i = tid; i < kBins * kTaps; i += kThreads) sm.taps[i] = taps[i];
  if (tid < kHist) {
    new_tail[tid] = frame_at(tail, x, frame_n - kHist + tid);
    new_rr_tail[tid] = frame_at(rr_tail, rr, frame_n - kHist + tid);
  }
  if (tid == 0) {
    sm.pos = (static_cast<long long>(q0[0]) << 32) + (mu0[0] & 0xFFFFFFFFll);
    for (int b = 0; b < 2; ++b) {
      sm.tile[b] = b;  // table 1 is built for tile 1 in the first phase
      sm.step_max[b] = LLONG_MIN;
      sm.step_min[b] = LLONG_MAX;
      sm.walked[b] = 0;
      sm.first[b] = 0;
    }
    sm.done = 0;
    sm.pending = 1;
  }
  __syncthreads();
  build_tile(sm, 0, 0, base, frame_n, rr, rr_tail, 0, kThreads);
  __syncthreads();
  // phases: thread 0 walks the current table's tile into one output buffer
  // while warps 1.. interpolate the other buffer and build the next tile's
  // table
  int cb = 0, ob = 0, k = 0;
  while (true) {
    if (tid == 0) {
      const int lo = base + sm.tile[cb] * kPosTile;
      long long rel = sm.pos - (static_cast<long long>(lo) << 32);
      // kRun steps at a time without checks while they surely stay in
      // the tile and in the valid samples: the walk's chain is then a
      // shared-memory load and a 64-bit add an output
      const long long smax = sm.step_max[cb], smin = sm.step_min[cb];
      const bool forward = smin >= 0 && smax >= smin;
      const long long reach = (kRun - 1) * ((smax >> 32) + 1);
      const long long qmax = min(limit - kTaps, lo + kPosTile - 1) - lo;
      const long long* step = sm.step[cb];
      int* oq = sm.q[ob];
      int* obin = sm.bin[ob];
      int j = 0;
      bool done = false;
      while (true) {
        const int qr = static_cast<int>(rel >> 32);
        if (forward && qr >= 0 && qr + reach <= qmax &&
            j + kRun <= kOutTile && k + j + kRun <= cap) {
#pragma unroll
          for (int u = 0; u < kRun; ++u) {
            const int q = static_cast<int>(rel >> 32);
            oq[j + u] = lo + q;
            obin[j + u] = bin_of(static_cast<unsigned>(rel));
            rel += step[q];
          }
          j += kRun;
          continue;
        }
        if (j >= kOutTile || k + j >= cap) break;
        const int q = lo + qr;
        if (q + kTaps > limit) {
          done = true;
          break;
        }
        const int qc = min(max(q, 0), hi);
        if (qc < lo || qc >= lo + kPosTile) break;
        oq[j] = qc;
        obin[j] = bin_of(static_cast<unsigned>(rel));
        rel += step[qc - lo];
        ++j;
      }
      sm.pos = rel + (static_cast<long long>(lo) << 32);
      sm.walked[ob] = j;
      sm.first[ob] = k;
      sm.done = done || k + j >= cap;
    } else if (tid >= 32) {
      interpolate(sm, ob ^ 1, x, tail, y, 32, kThreads - 32);
      if (sm.pending)
        build_tile(sm, cb ^ 1, sm.tile[cb ^ 1], base, frame_n, rr, rr_tail,
                   32, kThreads - 32);
    }
    __syncthreads();
    k += sm.walked[ob];
    if (sm.done) break;
    // the walker's tile: the current one (its output buffer filled), the
    // next (built meanwhile) or another, built now
    const int q = min(max(static_cast<int>(sm.pos >> 32), 0), max(hi, 0));
    const int d = q - base;
    const int tile =
        d >= 0 ? d / kPosTile : -((-d + kPosTile - 1) / kPosTile);
    if (tile != sm.tile[cb]) {
      if (tile != sm.tile[cb ^ 1]) {
        __syncthreads();
        if (tid == 0) {
          sm.tile[cb ^ 1] = tile;
          sm.step_max[cb ^ 1] = LLONG_MIN;
          sm.step_min[cb ^ 1] = LLONG_MAX;
        }
        __syncthreads();
        build_tile(sm, cb ^ 1, tile, base, frame_n, rr, rr_tail, 0,
                   kThreads);
      }
      cb ^= 1;
    }
    __syncthreads();
    if (tid == 0) {
      // the other table is to hold the tile after the walker's
      const int next = sm.tile[cb] + 1;
      sm.pending = sm.tile[cb ^ 1] != next;
      if (sm.pending) {
        sm.tile[cb ^ 1] = next;
        sm.step_max[cb ^ 1] = LLONG_MIN;
        sm.step_min[cb ^ 1] = LLONG_MAX;
      }
    }
    ob ^= 1;
    __syncthreads();
  }
  // the last buffer walked (the one before it was interpolated meanwhile),
  // and the slots past the walk
  interpolate(sm, ob, x, tail, y, 0, kThreads);
  for (int j = k + tid; j < cap; j += kThreads) y[j] = zero<T>();
  if (tid == 0) {
    const int q_end = static_cast<int>(sm.pos >> 32);
    out[0] = k;
    out[1] = max(q_end - n, 0);
    out[2] = static_cast<int>(static_cast<unsigned>(sm.pos));
    out[3] = q_end - n < 0 ? 1 : 0;
  }
}

// a benchmark hook, not part of the resampler: the walker's dependent
// step alone, `steps` adds of a shared-memory word read at the position
// the last add produced, one thread (timed for the walk's chain bound)
__global__ void chain_probe_kernel(int steps, long long* out) {
  __shared__ long long tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = (1ll << 32) + 0x9E3779B9ll + i;
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long pos = 0;
  for (int s = 0; s < steps; ++s) pos += tab[(pos >> 32) & 1023];
  out[0] = pos;
}

}  // namespace

extern "C" int vrr_walk(const void* x, const void* tail, int is_complex,
                        const float* rr, const float* rr_tail, int n,
                        const int* q0, const long long* mu0,
                        const int* count, int cap, const float* taps,
                        void* y, int* out, void* new_tail,
                        float* new_rr_tail, void* stream) {
  if (n < kTaps || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(Smem);
  cudaError_t e;
  if (is_complex) {
    e = cudaFuncSetAttribute(vrr_kernel<float2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    vrr_kernel<float2><<<1, kThreads, smem, s>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(tail), rr,
        rr_tail, n, q0, mu0, count, cap, taps, static_cast<float2*>(y), out,
        static_cast<float2*>(new_tail), new_rr_tail);
  } else {
    e = cudaFuncSetAttribute(vrr_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    vrr_kernel<float><<<1, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(tail), rr,
        rr_tail, n, q0, mu0, count, cap, taps, static_cast<float*>(y), out,
        static_cast<float*>(new_tail), new_rr_tail);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vrr_chain_probe(int steps, long long* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(steps,
                                                                      out);
  return static_cast<int>(cudaGetLastError());
}
