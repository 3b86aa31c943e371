// Frequency-translating decimating FIR (rotate, then filter), complex64.
//
// Replaces the TPU kernels of grbaz_tpu/ops/pallas/wbfm_frontend.py:
//   * xlating_fir_block_pallas_xal (_run_xal / _kernel_xal): the WBFM
//     channelizer -- entry point xlating_fir_block below;
//   * xlating_fir_frame_pallas_rtf (_run_rtf / _kernel_rtf): the same
//     math under the frame convention -- entry point xlating_fir_frame_rtf.
// Both entry points launch the one kernel; only the input addressing
// differs.
//
// With i the sample index relative to the first NEW sample x[0] (negative
// over the tpad-1 samples of history), every sample is rotated by
//     lo(i) = exp(j * 2pi * u32(phase0 + i*inc) / 2^32)
// and the rotated samples are filtered with the real reversed taps:
//     y[k] = sum_{t < tpad} h_rev_pad[t] * s(k*decim + t - (tpad-1)) * lo(...)
// The uint32 phase wraps exactly (i is cast to uint32, so negative i wraps
// modulo 2^32); the angle is __uint2float_rn(ph) * (2pi/2^32) in float32,
// the same rounding as grbaz_tpu/ops/exact.py: turns_u32_to_radians; sin/cos
// are the accurate sincosf. Sums are float32 FMAs, so the kernel is at
// least as accurate as the JAX 'highest' path.
//
// Bound on an H100 at the WBFM shape (2^20 samples in, decim 8, 104
// taps): memory. It reads 8 MiB and writes 1 MiB; its ~60 MFLOP and one
// sincosf per sample are far below the card's arithmetic rate. So each
// input sample is read from device memory once per tile (tiles overlap by
// the tpad-1 halo, ~10% at TILE=128) and rotated ONCE into shared memory;
// each thread then does the tpad-term dot for one output from shared
// memory, with the same conflict-free padded layout as fir_decimate.cu
// (slot j + j/decim). The TPU kernel's row x lane outer-product LO
// factorisation is not used: it saved Mosaic transcendentals, which are
// not the limit here.
//
// The phase and the increment arrive as POINTERS to 0-d int64 device
// tensors (uint32 values), so a launch never reads device state back to
// the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // outputs (= threads) per block
constexpr float TO_RAD = 0x1.921fb6p-30f;  // float32(2pi / 2^32)

// hist: value of sample i < 0 is hist[tpad + i]; body: sample i >= 0 is
// body[i]. For the frame convention hist = frame - 1, body = frame+tpad-1.
__global__ void __launch_bounds__(TILE)
xlating_fir_kernel(const float2* __restrict__ hist,
                   const float2* __restrict__ body, int64_t n,
                   const float* __restrict__ h,
                   const int64_t* __restrict__ phase0_p,
                   const int64_t* __restrict__ inc_p,
                   float2* __restrict__ y, int n_out, int tpad, int decim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* xs = reinterpret_cast<float2*>(smem);
  const int stride = decim + 1;
  const int span = TILE * decim + tpad - 1;
  const int span_slots = span + span / decim + 1;
  float* hs = reinterpret_cast<float*>(xs + span_slots);

  const uint32_t phase0 = (uint32_t)(*phase0_p);
  const uint32_t inc = (uint32_t)(*inc_p);
  const int64_t k0 = (int64_t)blockIdx.x * TILE;
  // sample index (relative to x[0]) of staged slot 0
  const int64_t i0 = k0 * decim - (tpad - 1);

  for (int t = threadIdx.x; t < tpad; t += TILE) hs[t] = h[t];
  for (int j = threadIdx.x; j < span; j += TILE) {
    const int64_t i = i0 + j;
    float2 v = make_float2(0.f, 0.f);
    if (i < n) v = i < 0 ? hist[tpad + i] : body[i];
    const uint32_t ph = phase0 + (uint32_t)i * inc;
    float s, c;
    sincosf(__uint2float_rn(ph) * TO_RAD, &s, &c);
    xs[j + j / decim] = make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
  }
  __syncthreads();

  const int64_t k = k0 + threadIdx.x;
  if (k >= n_out) return;
  const int n_phases = tpad / decim;
  float ar = 0.f, ai = 0.f;
  for (int m = 0; m < n_phases; ++m) {
    const float2* row = xs + (threadIdx.x + m) * stride;
    const float* hm = hs + m * decim;
    for (int p = 0; p < decim; ++p) {
      const float2 v = row[p];
      ar = fmaf(hm[p], v.x, ar);
      ai = fmaf(hm[p], v.y, ai);
    }
  }
  y[k] = make_float2(ar, ai);
}

int launch(const float2* hist, const float2* body, int64_t n, const float* h,
           const int64_t* phase0, const int64_t* inc, void* y, int n_out,
           int tpad, int decim, cudaStream_t stream) {
  if (n_out <= 0) return 0;
  const int span = TILE * decim + tpad - 1;
  const size_t smem = sizeof(float2) * (size_t)(span + span / decim + 1)
                      + sizeof(float) * (size_t)tpad;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        xlating_fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_out + TILE - 1) / TILE;
  xlating_fir_kernel<<<blocks, TILE, smem, stream>>>(
      hist, body, n, h, phase0, inc, static_cast<float2*>(y), n_out, tpad,
      decim);
  return (int)cudaGetLastError();
}

}  // namespace

// New block x[n] with the carried tail[tpad] (tail[1:] is the history).
extern "C" int xlating_fir_block(const void* x, const void* tail, int64_t n,
                                 const float* h, const int64_t* phase0,
                                 const int64_t* inc, void* y, int n_out,
                                 int tpad, int decim, void* stream) {
  return launch(static_cast<const float2*>(tail),
                static_cast<const float2*>(x), n, h, phase0, inc, y, n_out,
                tpad, decim, static_cast<cudaStream_t>(stream));
}

// frame[tpad-1+n] = concat(tail[1:], x); phase0 is the phase of frame
// sample tpad-1 (the first new sample).
extern "C" int xlating_fir_frame_rtf(const void* frame, int64_t n,
                                     const float* h, const int64_t* phase0,
                                     const int64_t* inc, void* y, int n_out,
                                     int tpad, int decim, void* stream) {
  const float2* f = static_cast<const float2*>(frame);
  return launch(f - 1, f + (tpad - 1), n, h, phase0, inc, y, n_out, tpad,
                decim, static_cast<cudaStream_t>(stream));
}
