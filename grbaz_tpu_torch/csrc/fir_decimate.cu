// Decimating real-tap FIR over a frame with tpad-1 samples of history.
//
// Replaces the TPU kernel fir_decimate_frame_pallas
// (grbaz_tpu/ops/pallas/fir_kernel.py: _fir_decimate_planar / _fir_kernel).
//
//     y[k] = sum_{t < tpad} h_rev_pad[t] * frame[k*decim + t]
//
// frame is float32 or complex64 (read as interleaved float2 in ONE pass;
// the TPU kernel ran two planar launches). tpad is a multiple of decim.
//
// Bound on an H100: memory. Each output needs tpad FMAs per component
// against decim new input samples, i.e. 2*tpad/decim FLOP per input byte
// pair -- far below the card's ~20 FLOP/byte f32 balance point. So the
// design reads every input sample from device memory once (plus the
// tpad-1 halo of each tile) and keeps the reuse in shared memory:
//
// * one thread block owns TILE consecutive outputs and stages their input
//   span (TILE*decim + tpad - 1 samples) and the taps in shared memory;
// * one thread computes one output: a tpad-term f32 FMA dot;
// * the staged samples are stored with one padding slot after every
//   decim samples (index j -> j + j/decim). Thread k then reads slot
//   (k + m)*(decim+1) + p, so a warp's 32 threads hit distinct banks
//   whenever decim is even (decim+1 is odd), instead of decim-way
//   conflicts at stride decim.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;  // outputs (= threads) per block

__device__ __forceinline__ float fma_acc(float acc, float h, float x) {
  return fmaf(h, x, acc);
}
__device__ __forceinline__ float2 fma_acc(float2 acc, float h, float2 x) {
  return make_float2(fmaf(h, x.x, acc.x), fmaf(h, x.y, acc.y));
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}

template <typename T>
__global__ void __launch_bounds__(TILE)
fir_decimate_kernel(const T* __restrict__ frame, int64_t frame_len,
                    const float* __restrict__ h, T* __restrict__ y,
                    int n_out, int tpad, int decim) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int stride = decim + 1;
  const int span = TILE * decim + tpad - 1;
  const int span_slots = span + span / decim + 1;
  float* hs = reinterpret_cast<float*>(xs + span_slots);

  const int64_t k0 = (int64_t)blockIdx.x * TILE;
  const int64_t base = k0 * decim;
  for (int t = threadIdx.x; t < tpad; t += TILE) hs[t] = h[t];
  for (int j = threadIdx.x; j < span; j += TILE) {
    const int64_t f = base + j;
    xs[j + j / decim] = f < frame_len ? frame[f] : zero<T>();
  }
  __syncthreads();

  const int64_t k = k0 + threadIdx.x;
  if (k >= n_out) return;
  const int n_phases = tpad / decim;
  T acc = zero<T>();
  for (int m = 0; m < n_phases; ++m) {
    const T* row = xs + (threadIdx.x + m) * stride;
    const float* hm = hs + m * decim;
    for (int p = 0; p < decim; ++p) acc = fma_acc(acc, hm[p], row[p]);
  }
  y[k] = acc;
}

template <typename T>
int launch(const void* frame, int64_t frame_len, const float* h, void* y,
           int n_out, int tpad, int decim, cudaStream_t stream) {
  if (n_out <= 0) return 0;
  const int span = TILE * decim + tpad - 1;
  const size_t smem = sizeof(T) * (size_t)(span + span / decim + 1)
                      + sizeof(float) * (size_t)tpad;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fir_decimate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_out + TILE - 1) / TILE;
  fir_decimate_kernel<T><<<blocks, TILE, smem, stream>>>(
      static_cast<const T*>(frame), frame_len, h, static_cast<T*>(y), n_out,
      tpad, decim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fir_decimate_f32(const void* frame, int64_t frame_len,
                                const float* h, void* y, int n_out, int tpad,
                                int decim, void* stream) {
  return launch<float>(frame, frame_len, h, y, n_out, tpad, decim,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int fir_decimate_c64(const void* frame, int64_t frame_len,
                                const float* h, void* y, int n_out, int tpad,
                                int decim, void* stream) {
  return launch<float2>(frame, frame_len, h, y, n_out, tpad, decim,
                        static_cast<cudaStream_t>(stream));
}
