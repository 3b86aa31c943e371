// Frequency-translating decimating FIR with rotated complex taps,
// UNROTATED output, complex64.
//
// Replaces the TPU kernel xlating_fir_frame_pallas of
// grbaz_tpu/ops/pallas/wbfm_frontend.py (_kernel / _run), which carries
// the fused WBFM front end (WBFMFrontend). With the complex taps
//     g[t] = h_rev_pad[t] * exp(j * ang(u32((t - (tpad-1)) * inc)))
// it computes, for a frame whose first tpad-1 samples are raw history,
//     yf[k] = sum_{t < tpad} g[t] * frame[k*decim + t]
// and leaves the output-side rotation to the caller (the FM
// discriminator folds it into a constant phase step). The angle of a
// uint32 turn is __uint2float_rn(ph) * (2pi/2^32) in float32, rounded as
// grbaz_tpu/ops/exact.py: turns_u32_to_radians rounds it; sin/cos are the
// accurate sincosf. Sums are float32 FMAs with separate real and
// imaginary accumulators, at least as accurate as the JAX 'high' path.
//
// Bound on an H100 at the WBFM shape (2^20 samples in, decim 8, 104
// taps): memory. It reads 8 MiB and writes 1 MiB (~2.8 us at 3.35 TB/s);
// its ~109 MFLOP of complex FMAs take ~1.6 us at 67 TFLOP/s. So each
// input sample is read from device memory once per tile (tiles overlap
// by the tpad-1 halo) and staged RAW into shared memory -- the LO lives
// in the taps, so no sample is rotated -- with the conflict-free padded
// layout of xlating_fir.cu (slot j + j/decim). Each block builds the
// tpad complex taps in shared memory itself (tpad sincosf), from the
// real taps and a POINTER to the 0-d increment tensor, so a launch
// needs no host-built taps and never reads device state back to the
// host. One thread computes one output. The TPU kernel's block-diagonal
// packed tap matrices, MXU dots and lane-roll band alignment are not
// used: they are Mosaic layout machinery.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // outputs (= threads) per block
constexpr float TO_RAD = 0x1.921fb6p-30f;  // float32(2pi / 2^32)

// hist: value of sample i < 0 is hist[tpad + i]; body: sample i >= 0 is
// body[i]; samples at i >= n read as zero. For the frame convention
// hist = frame - 1, body = frame + tpad - 1.
__global__ void __launch_bounds__(TILE)
xlating_fir_ctaps_kernel(const float2* __restrict__ hist,
                         const float2* __restrict__ body, int64_t n,
                         const float* __restrict__ h,
                         const int64_t* __restrict__ inc_p,
                         float2* __restrict__ y, int n_out, int tpad,
                         int decim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* xs = reinterpret_cast<float2*>(smem);
  const int stride = decim + 1;
  const int span = TILE * decim + tpad - 1;
  const int span_slots = span + span / decim + 1;
  float2* gs = xs + span_slots;

  const uint32_t inc = (uint32_t)(*inc_p);
  const int64_t k0 = (int64_t)blockIdx.x * TILE;
  // sample index (relative to the first new sample) of staged slot 0
  const int64_t i0 = k0 * decim - (tpad - 1);

  for (int t = threadIdx.x; t < tpad; t += TILE) {
    const uint32_t rel = (uint32_t)(t - (tpad - 1)) * inc;
    float s, c;
    sincosf(__uint2float_rn(rel) * TO_RAD, &s, &c);
    const float ht = h[t];
    gs[t] = make_float2(ht * c, ht * s);
  }
  for (int j = threadIdx.x; j < span; j += TILE) {
    const int64_t i = i0 + j;
    float2 v = make_float2(0.f, 0.f);
    if (i < n) v = i < 0 ? hist[tpad + i] : body[i];
    xs[j + j / decim] = v;
  }
  __syncthreads();

  const int64_t k = k0 + threadIdx.x;
  if (k >= n_out) return;
  const int n_phases = tpad / decim;
  float ar = 0.f, ai = 0.f;
  for (int m = 0; m < n_phases; ++m) {
    const float2* row = xs + (threadIdx.x + m) * stride;
    const float2* gm = gs + m * decim;
    for (int p = 0; p < decim; ++p) {
      const float2 v = row[p];
      const float2 g = gm[p];
      ar = fmaf(g.x, v.x, ar);
      ar = fmaf(-g.y, v.y, ar);
      ai = fmaf(g.x, v.y, ai);
      ai = fmaf(g.y, v.x, ai);
    }
  }
  y[k] = make_float2(ar, ai);
}

int launch(const float2* hist, const float2* body, int64_t n, const float* h,
           const int64_t* inc, void* y, int n_out, int tpad, int decim,
           cudaStream_t stream) {
  if (n_out <= 0) return 0;
  const int span = TILE * decim + tpad - 1;
  const size_t smem = sizeof(float2) * (size_t)(span + span / decim + 1)
                      + sizeof(float2) * (size_t)tpad;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        xlating_fir_ctaps_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_out + TILE - 1) / TILE;
  xlating_fir_ctaps_kernel<<<blocks, TILE, smem, stream>>>(
      hist, body, n, h, inc, static_cast<float2*>(y), n_out, tpad, decim);
  return (int)cudaGetLastError();
}

}  // namespace

// New block x[n] with the carried raw tail[tpad] (tail[1:] is the
// history): what WBFMFrontend launches, with no concatenation.
extern "C" int xlating_fir_ctaps_block(const void* x, const void* tail,
                                       int64_t n, const float* h,
                                       const int64_t* inc, void* y,
                                       int n_out, int tpad, int decim,
                                       void* stream) {
  return launch(static_cast<const float2*>(tail),
                static_cast<const float2*>(x), n, h, inc, y, n_out, tpad,
                decim, static_cast<cudaStream_t>(stream));
}

// frame[tpad-1+n]: tpad-1 samples of raw history, then n new samples
// (the signature of the JAX kernel).
extern "C" int xlating_fir_ctaps_frame(const void* frame, int64_t n,
                                       const float* h, const int64_t* inc,
                                       void* y, int n_out, int tpad,
                                       int decim, void* stream) {
  const float2* f = static_cast<const float2*>(frame);
  return launch(f - 1, f + (tpad - 1), n, h, inc, y, n_out, tpad, decim,
                static_cast<cudaStream_t>(stream));
}
