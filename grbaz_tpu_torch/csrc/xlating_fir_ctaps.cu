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
// This is the polyphase core of polyphase_fir.cuh with the complex taps
// built per block (RotatedTaps, one sincosf each) and a plain store: B1
// (xlating_fir.cu) without its per-output rotation. The launch geometry
// comes from the host (ops/cuda/tiling.py), as for B1 and B3.
//
// Bound on an H100 at the WBFM shape (2^20 samples in, decim 8, 104
// taps): memory. It reads 8 MiB and writes 1 MiB, 2.8 us at 3.35 TB/s;
// its 54.5 M FFMA take ~1.6 us spread over 132 SMs.
//
// What held the one-output-per-thread kernel this replaces back (14.1 us
// on an H100, PERF.md), and what the core does about it:
//   * 128-thread tiles, one output per thread, a 2-wavefront sample load
//     and a tap broadcast per output-tap (3 wavefronts per 32) -> lane
//     groups that slide a register window of 8 outputs down a phase
//     plane, conflict-free by the plane and tap strides: 0.60;
//   * staging through registers, a load and a store per sample -> one
//     cp.async per sample, every copy of a tile issued before any is
//     waited on, so the staging runs at the card's copy rate.
// What still holds it (9.4 us; the ablation in PERF.md): as in B1, every
// block of the one wave loads, then computes, so the copies and the dot
// add up. Sub-tiles with a commit group each, their dots started as each
// group lands, and smaller tiles over more blocks both measured slower.
//
// The increment arrives as a POINTER to a 0-d int64 device tensor (a
// uint32 value), so a launch never reads device state back to the host.

#include "polyphase_fir.cuh"

using pfir::Geometry;
using pfir::Problem;

namespace {

int launch(const float2* hist, const float2* body, int64_t n, const float* h,
           const int64_t* inc, void* y, int n_out, int tpad, int decim,
           const Geometry& geo, cudaStream_t stream) {
  // StorePlain reads no phase
  const Problem pr{hist, body, n, h, nullptr, inc, y, n_out, tpad, decim};
  return pfir::launch<float2, pfir::RotatedTaps, pfir::StorePlain>(
      pr, geo, stream);
}

}  // namespace

// New block x[n] with the carried raw tail[tpad] (tail[1:] is the
// history): what WBFMFrontend launches, with no concatenation.
extern "C" int xlating_fir_ctaps_block(const void* x, const void* tail,
                                       int64_t n, const float* h,
                                       const int64_t* inc, void* y,
                                       int n_out, int tpad, int decim,
                                       Geometry geo, void* stream) {
  return launch(static_cast<const float2*>(tail),
                static_cast<const float2*>(x), n, h, inc, y, n_out, tpad,
                decim, geo, static_cast<cudaStream_t>(stream));
}

// frame[tpad-1+n]: tpad-1 samples of raw history, then n new samples
// (the signature of the JAX kernel).
extern "C" int xlating_fir_ctaps_frame(const void* frame, int64_t n,
                                       const float* h, const int64_t* inc,
                                       void* y, int n_out, int tpad,
                                       int decim, Geometry geo,
                                       void* stream) {
  const float2* f = static_cast<const float2*>(frame);
  return launch(f - 1, f + (tpad - 1), n, h, inc, y, n_out, tpad, decim, geo,
                static_cast<cudaStream_t>(stream));
}
