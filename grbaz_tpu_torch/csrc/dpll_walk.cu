// The DPLL bit synchronizer's walk on the card.
//
// Replaces the per-sample lax.scan of DPLLBitSync.apply
// (grbaz_tpu/ops/decode.py:118, scan at :180). Each row of pulses [B, n]
// is one stream: one thread walks it serially from the row's carried
// period estimate, phase, pulse count, last pulse index and sample index.
// Every float32 rounding is written out as XLA compiles the JAX scan on
// the CPU: freq = 1 / period; phase + freq; the measured period
// (phase + freq) * period (XLA rewrites the scan's phase / freq so); the
// ratio (measured - period) / period; the clamp to period * (1 -+ rel);
// and the update, one product of which XLA contracts into a fused
// multiply-add: fma(1 - g, period, g * clamped), or fma(g, clamped,
// (1 - g) * period) where (1 - g) is a clamp bound too and that product
// is shared (`fuse_gain`; decode.dpll_fuses_gain decides). Events (index
// diff, new period, measured period) are written at the thread's running
// count; past 511 they are summed into row 511 in order, the JAX
// scatter-add's rule.
//
// Bound: a serial float chain, a division, an add, a multiply, a second
// division and the update a sample (~100 cycles of latency);
// `dpll_chain_probe` times that step alone. The bytes (n in, 5n out)
// bound nothing next to the chain.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch. State rows: float [2, B] = period, phase;
// int32 [3, B] = count, last_idx, global_idx.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // a warp a block: rows spread over SMs
constexpr int kMaxEvents = 512;

struct DpllConst {
  float omg, g, lo, hi, ign;   // 1 - gain, gain, 1 - rel, 1 + rel, ignore
  bool fuse_gain;              // which product the fused multiply-add takes
};

struct DpllState {
  float period, phase;
  int count, last, gidx;
};

// One step of the JAX scan at sample index `i` of the block. Returns
// whether the step emits an event (its fields in diff and cur).
__device__ __forceinline__ bool dpll_step(DpllState& s, bool pulse, int i,
                                          const DpllConst& c, float& diff,
                                          float& cur) {
  const float freq = __fdiv_rn(1.0f, s.period);
  const float phase = __fadd_rn(s.phase, freq);
  cur = __fmul_rn(phase, s.period);
  const float ratio = __fdiv_rn(__fsub_rn(cur, s.period), s.period);
  if (!pulse) {
    s.phase = phase;
    return false;
  }
  if (s.count > 0 && fabsf(ratio) < c.ign) {
    const float clamped = fminf(__fmul_rn(s.period, c.hi),
                                fmaxf(__fmul_rn(s.period, c.lo), cur));
    s.period = c.fuse_gain
                   ? __fmaf_rn(c.g, clamped, __fmul_rn(c.omg, s.period))
                   : __fmaf_rn(c.omg, s.period, __fmul_rn(c.g, clamped));
  }
  const int now = static_cast<int>(static_cast<unsigned>(s.gidx) +
                                   static_cast<unsigned>(i));
  const bool emit = s.last >= 0;
  diff = __int2float_rn(static_cast<int>(static_cast<unsigned>(now) -
                                         static_cast<unsigned>(s.last)));
  s.phase = 0.0f;
  s.count = static_cast<int>(static_cast<unsigned>(s.count) + 1u);
  s.last = now;
  return emit;
}

__global__ void __launch_bounds__(kThreads)
dpll_kernel(const uint8_t* __restrict__ pulses, int n, int rows,
            const float* __restrict__ fin, const int* __restrict__ iin,
            DpllConst c, uint8_t* __restrict__ p_out,
            float* __restrict__ periods, float* __restrict__ events,
            int* __restrict__ n_ev, float* __restrict__ fout,
            int* __restrict__ iout) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const size_t off = static_cast<size_t>(r) * n;
  const uint8_t* x = pulses + off;
  float* ev = events + static_cast<size_t>(r) * kMaxEvents * 3;
  DpllState s{fin[r], fin[rows + r], iin[r], iin[rows + r],
              iin[2 * rows + r]};
  int k = 0;
  float last0 = 0.0f, last1 = 0.0f, last2 = 0.0f;   // row 511's sums
  for (int i = 0; i < n; ++i) {
    const bool pulse = x[i] != 0;
    float diff, cur;
    const bool emit = dpll_step(s, pulse, i, c, diff, cur);
    p_out[off + i] = pulse ? 1 : 0;
    periods[off + i] = s.period;
    if (emit) {
      if (k < kMaxEvents - 1) {
        ev[3 * k] = diff;
        ev[3 * k + 1] = s.period;
        ev[3 * k + 2] = cur;
      } else {
        last0 = __fadd_rn(last0, diff);
        last1 = __fadd_rn(last1, s.period);
        last2 = __fadd_rn(last2, cur);
      }
      ++k;
    }
  }
  for (int j = 3 * min(k, kMaxEvents - 1); j < 3 * (kMaxEvents - 1); ++j)
    ev[j] = 0.0f;
  ev[3 * (kMaxEvents - 1)] = last0;
  ev[3 * (kMaxEvents - 1) + 1] = last1;
  ev[3 * (kMaxEvents - 1) + 2] = last2;
  n_ev[r] = min(k, kMaxEvents);
  fout[r] = s.period;
  fout[rows + r] = s.phase;
  iout[r] = s.count;
  iout[rows + r] = s.last;
  iout[2 * rows + r] = static_cast<int>(static_cast<unsigned>(s.gidx) +
                                        static_cast<unsigned>(n));
}

// `steps` steps of dpll_step alone on one thread, a pulse every ~100
// samples from a shared-memory table (timed for the walk's chain bound)
__global__ void chain_probe_kernel(int steps, float* out) {
  __shared__ uint8_t tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = (i % 100) == 99;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const DpllConst c{0.95f, 0.05f, 0.95f, 1.05f, 0.5f, true};
  DpllState s{97.0f, 0.0f, 0, -1, 0};
  float acc = 0.0f;
  for (int i = 0; i < steps; ++i) {
    float diff, cur;
    if (dpll_step(s, tab[i & 1023] != 0, i, c, diff, cur)) acc += diff;
  }
  out[0] = acc + s.period;
}

}  // namespace

extern "C" int dpll_walk(const uint8_t* pulses, int n, int rows,
                         const float* fin, const int* iin, float omg, float g,
                         float lo, float hi, float ign, int fuse_gain,
                         uint8_t* p_out, float* periods, float* events,
                         int* n_ev, float* fout, int* iout, void* stream) {
  if (n < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DpllConst c{omg, g, lo, hi, ign, fuse_gain != 0};
  dpll_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      pulses, n, rows, fin, iin, c, p_out, periods, events, n_ev, fout, iout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpll_chain_probe(int steps, void* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
