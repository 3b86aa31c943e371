// Frequency-translating decimating FIR (the WBFM channelizer), complex64,
// ROTATED output.
//
// Replaces the TPU kernels of grbaz_tpu/ops/pallas/wbfm_frontend.py:
//   * xlating_fir_block_pallas_xal (_run_xal / _kernel_xal): the WBFM
//     channelizer -- entry point xlating_fir_block below;
//   * xlating_fir_frame_pallas_rtf (_run_rtf / _kernel_rtf): the same
//     math under the frame convention -- entry point xlating_fir_frame_rtf.
// Both launch the one kernel; only the input addressing differs.
//
// With i the sample index relative to the first NEW sample x[0] (negative
// over the tpad-1 samples of history), rotate-then-filter is
//     y[k] = sum_{t < tpad} h_rev_pad[t] * s(k*decim + t - (tpad-1))
//                           * lo(phase0 + (k*decim + t - (tpad-1))*inc)
// with lo(ph) = exp(j*2pi*u32(ph)/2^32). The uint32 phase of that sample
// is u32(phase0 + k*decim*inc) + u32((t - (tpad-1))*inc) mod 2^32,
// exactly, so the LO leaves the sample path:
//     y[k] = lo(phase0 + k*decim*inc) * sum_t g[t] * s(k*decim + t - (tpad-1))
// with B2's rotated taps g[t] = h_rev_pad[t] * lo((t - (tpad-1))*inc)
// (csrc/xlating_fir_ctaps.cu). This is the polyphase core of
// polyphase_fir.cuh with complex taps built per block (one sincosf each) and
// an epilogue that rotates each output (one sincosf per output). Angles
// are __uint2float_rn(ph) * float32(2pi/2^32), rounded as
// grbaz_tpu/ops/exact.py: turns_u32_to_radians; sin/cos are the accurate
// sincosf.
//
// Bound on an H100 at the WBFM shape (2^20 samples in, decim 8, 104
// taps): memory. It reads 8 MiB and writes 1 MiB, 2.8 us at 3.35 TB/s;
// its 54.5 M FFMA take ~1.6 us spread over 132 SMs.
//
// What held the one-output-per-thread kernel back (14.0 us on an H100,
// PERF.md), and what this design does about it:
//   * one sincosf per staged sample (1.15 M per launch, the halo
//     included) on the staging path -> one per output (131072) plus
//     tpad (104) per block for the taps, after the block's copies left;
//   * staging through registers, a load and a store per sample -> one
//     cp.async per sample, all of a tile's issued before any is waited
//     on, so the staging runs at the card's copy rate;
//   * 3 shared-memory wavefronts per output-tap of a warp -> 0.60: 8
//     outputs per lane group slide a register window down a phase
//     plane, conflict-free by the plane and tap strides
//     (polyphase_fir.cuh).
// What still holds it (10.1 us; the ablation in PERF.md): the copies
// (~3.0 us) and the dot (~3.2 us) do not overlap, since every block of
// the one wave loads, then computes; and the launch, the per-block set-up
// and the epilogue take ~4.1 us with neither.
//
// Registers and shared memory (nvcc -Xptxas=-v, sm_90a): 64 registers at
// R = 8 (40 at R = 4, 32 at R = 2 and 1), no spills, a 32-byte stack
// frame (sincosf's slow path, never taken for angles in [0, 2pi)); at
// the WBFM shape 39296 bytes of shared memory per block (527 rows x 8
// phase planes of 596 slots, and 8 x 18 complex taps), 256 blocks of
// 256 threads.
//
// The phase and the increment arrive as POINTERS to 0-d int64 device
// tensors (uint32 values), so a launch never reads device state back to
// the host.

#include "polyphase_fir.cuh"

using pfir::Geometry;
using pfir::Problem;

namespace {

int launch(const float2* hist, const float2* body, int64_t n, const float* h,
           const int64_t* phase0, const int64_t* inc, void* y, int n_out,
           int tpad, int decim, const Geometry& geo, cudaStream_t stream) {
  const Problem pr{hist, body, n, h, phase0, inc, y, n_out, tpad, decim};
  return pfir::launch<float2, pfir::RotatedTaps, pfir::StoreRotated>(
      pr, geo, stream);
}

}  // namespace

// New block x[n] with the carried tail[tpad] (tail[1:] is the history).
extern "C" int xlating_fir_block(const void* x, const void* tail, int64_t n,
                                 const float* h, const int64_t* phase0,
                                 const int64_t* inc, void* y, int n_out,
                                 int tpad, int decim, Geometry geo,
                                 void* stream) {
  return launch(static_cast<const float2*>(tail),
                static_cast<const float2*>(x), n, h, phase0, inc, y, n_out,
                tpad, decim, geo, static_cast<cudaStream_t>(stream));
}

// frame[tpad-1+n] = concat(tail[1:], x); phase0 is the phase of frame
// sample tpad-1 (the first new sample).
extern "C" int xlating_fir_frame_rtf(const void* frame, int64_t n,
                                     const float* h, const int64_t* phase0,
                                     const int64_t* inc, void* y, int n_out,
                                     int tpad, int decim, Geometry geo,
                                     void* stream) {
  const float2* f = static_cast<const float2*>(frame);
  return launch(f - 1, f + (tpad - 1), n, h, phase0, inc, y, n_out, tpad,
                decim, geo, static_cast<cudaStream_t>(stream));
}
