// Decimating real-tap FIR, float32 or complex64.
//
// Replaces the TPU kernel fir_decimate_frame_pallas
// (grbaz_tpu/ops/pallas/fir_kernel.py: _fir_decimate_planar / _fir_kernel).
//
//     y[k] = sum_{t < tpad} h_rev_pad[t] * frame[k*decim + t]
//
// over a frame with tpad-1 samples of history (tpad a multiple of decim),
// read as interleaved float2 in ONE pass for complex64 (the TPU kernel
// ran two planar launches). Two entry points per type:
//   * fir_decimate_{f32,c64}: the frame, as the JAX kernel takes it;
//   * fir_decimate_block_{f32,c64}: a new block x[n] and the carried
//     tail[tpad] (tail[1:] is the history), read in place, so the block
//     that carries the tail (FIRDecimator) needs no concatenation.
//
// The kernel is the polyphase core of polyphase_fir.cuh with real taps
// and a plain store. The host (ops/cuda/tiling.py) picks its geometry
// from n_out, tpad and decim, for two regimes:
//
//   * the cascade chain's audio_aa shape (131072 + 175 float32 in, 176
//     taps, decim 8, 16384 out): 0.18 us of bytes, far below one launch
//     and one DRAM round trip, so it is bound by latency. The kernel it
//     replaces (9.0 us on an H100) ran 128 blocks of 4 warps, one output
//     per thread, each thread's ~9 staging loads nearly serial and its
//     176 FMAs one dependent chain. Here tiles of 64 outputs give 256
//     blocks, 8 lanes share each 4-output window (each lane sums one
//     phase: 4 chains of 24 FMAs), the partial sums meet through
//     __shfl_xor_sync, and every staging copy of a thread is issued
//     before any is waited on (cp.async);
//   * the channel shape (2^20 complex64 in, 104 taps): memory-bound (2.8
//     us of bytes) like the channelizer (csrc/xlating_fir.cu), with the
//     same tiles and register window, and half its FFMAs.
//
// Registers and shared memory (nvcc -Xptxas=-v, sm_90a): complex64 48
// registers at R = 8, 32-34 at R = 4, 2 and 1; float32 40 at R = 8, 32
// at R = 4, 2 and 1; no spills, no stack. Shared memory per block: 38720
// bytes at the channel shape (256 blocks), 4544 at audio_aa (87 rows x 8
// planes of 116 floats, and 8 x 26 taps; 256 blocks of 128 threads).
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch.

#include "polyphase_fir.cuh"

using pfir::Geometry;
using pfir::Problem;

namespace {

template <typename S>
int launch(const void* hist, const void* body, int64_t n, const float* h,
           void* y, int n_out, int tpad, int decim, const Geometry& geo,
           void* stream) {
  const Problem pr{hist, body, n, h, nullptr, nullptr, y, n_out, tpad, decim};
  return pfir::launch<S, pfir::RealTaps, pfir::StorePlain>(
      pr, geo, static_cast<cudaStream_t>(stream));
}

template <typename S>
int launch_frame(const void* frame, int64_t frame_len, const float* h,
                 void* y, int n_out, int tpad, int decim, const Geometry& geo,
                 void* stream) {
  const S* f = static_cast<const S*>(frame);
  return launch<S>(f - 1, f + (tpad - 1), frame_len - (tpad - 1), h, y,
                   n_out, tpad, decim, geo, stream);
}

}  // namespace

extern "C" int fir_decimate_f32(const void* frame, int64_t frame_len,
                                const float* h, void* y, int n_out, int tpad,
                                int decim, Geometry geo, void* stream) {
  return launch_frame<float>(frame, frame_len, h, y, n_out, tpad, decim, geo,
                             stream);
}

extern "C" int fir_decimate_c64(const void* frame, int64_t frame_len,
                                const float* h, void* y, int n_out, int tpad,
                                int decim, Geometry geo, void* stream) {
  return launch_frame<float2>(frame, frame_len, h, y, n_out, tpad, decim,
                              geo, stream);
}

extern "C" int fir_decimate_block_f32(const void* x, const void* tail,
                                      int64_t n, const float* h, void* y,
                                      int n_out, int tpad, int decim,
                                      Geometry geo, void* stream) {
  return launch<float>(tail, x, n, h, y, n_out, tpad, decim, geo, stream);
}

extern "C" int fir_decimate_block_c64(const void* x, const void* tail,
                                      int64_t n, const float* h, void* y,
                                      int n_out, int tpad, int decim,
                                      Geometry geo, void* stream) {
  return launch<float2>(tail, x, n, h, y, n_out, tpad, decim, geo, stream);
}
