// The Manchester decoder's FSM on the card.
//
// Replaces the per-sample lax.scan of ManchesterDecode.apply
// (grbaz_tpu/ops/decode.py:44, scan at :104). Each row of bits [B, n] is
// one stream: one thread walks it serially from the row's carried state
// (phase, held first-of-pair sample, violation window, window length),
// decoding pairs, counting violations in the sliding window and slipping
// the pair alignment by one sample when `threshold` of a full `window`
// are violations. Emissions before the row's `count` are written at the
// thread's own running count (no cumsum pass); past the capacity n/2 + 1
// they are added into the last slot with uint8 wrap, the JAX
// scatter-add's rule (a row emits at most ceil(n/2), so it never does).
//
// Bound: a serial walk. Its state does not forget (the pair alignment
// lasts until violations slip it), so it has no chunk-parallel form like
// csrc/peak_fsm.cu's. One dependent step a sample (a few integer ops);
// `manchester_chain_probe` times that step alone. The bytes (n in, about
// n/2 out) bound nothing next to the chain.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch. State rows: int32 [4, B] = phase, prev,
// viol_hist (uint32 bits), hist_len.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // a warp a block: rows spread over SMs

struct ManState {
  int phase, prev;
  uint32_t hist;
  int hlen;
};

// One step of the JAX scan. Returns whether the step decodes a pair
// (its bit in `bit`).
__device__ __forceinline__ bool man_step(ManState& s, int xi, int window,
                                         int threshold, uint32_t wmask,
                                         bool original, uint8_t& bit) {
  if (s.phase != 1) {
    s.phase = 1;
    s.prev = xi;
    return false;
  }
  const bool viol = s.prev == xi;
  bit = ((s.prev == 0 && xi == 1) != original) ? 1 : 0;
  s.hist = ((s.hist << 1) | (viol ? 1u : 0u)) & wmask;
  s.hlen = min(s.hlen + 1, window);
  if (s.hlen >= window && __popc(s.hist) >= threshold) {
    s.phase = 1;   // slip: this sample starts the next pair
    s.prev = xi;
    s.hist = 0;
    s.hlen = 0;
  } else {
    s.phase = 0;
  }
  return !viol;
}

__global__ void __launch_bounds__(kThreads)
manchester_kernel(const uint8_t* __restrict__ bits,
                  const int* __restrict__ count, int n, int rows,
                  const int* __restrict__ sin, uint8_t* __restrict__ out,
                  int* __restrict__ n_out, int* __restrict__ sout,
                  int original, int window, int threshold) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* x = bits + static_cast<size_t>(r) * n;
  const int cap = n / 2 + 1;
  uint8_t* y = out + static_cast<size_t>(r) * cap;
  ManState s{sin[r], sin[rows + r], static_cast<uint32_t>(sin[2 * rows + r]),
             sin[3 * rows + r]};
  const uint32_t wmask = (1u << window) - 1u;
  const int valid = count[r];
  int k = 0;
  uint8_t last = 0;   // the last slot's sum
  for (int i = 0; i < n; ++i) {
    uint8_t bit = 0;
    if (man_step(s, x[i] != 0, window, threshold, wmask, original != 0,
                 bit) && i < valid) {
      if (k < cap - 1) {
        y[k] = bit;
      } else {
        last = static_cast<uint8_t>(last + bit);
      }
      ++k;
    }
  }
  for (int j = min(k, cap - 1); j < cap - 1; ++j) y[j] = 0;
  y[cap - 1] = last;
  n_out[r] = min(k, cap);
  sout[r] = s.phase;
  sout[rows + r] = s.prev;
  sout[2 * rows + r] = static_cast<int>(s.hist);
  sout[3 * rows + r] = s.hlen;
}

// `steps` steps of man_step alone on one thread, its inputs from shared
// memory (timed for the walk's chain bound)
__global__ void chain_probe_kernel(int steps, int* out) {
  __shared__ uint8_t tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = static_cast<uint8_t>((i * 2654435761u) >> 31);
  __syncthreads();
  if (threadIdx.x != 0) return;
  ManState s{0, 0, 0u, 0};
  int acc = 0;
  for (int i = 0; i < steps; ++i) {
    uint8_t bit = 0;
    if (man_step(s, tab[i & 1023], 16, 8, 0xFFFFu, false, bit)) acc += bit;
  }
  out[0] = acc + s.phase;
}

}  // namespace

extern "C" int manchester_fsm(const uint8_t* bits, const int* count, int n,
                              int rows, const int* sin, uint8_t* out,
                              int* n_out, int* sout, int original, int window,
                              int threshold, void* stream) {
  if (n < 1 || rows < 1 || window < 1 || window > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  manchester_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      bits, count, n, rows, sin, out, n_out, sout, original, window,
      threshold);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int manchester_chain_probe(int steps, void* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
