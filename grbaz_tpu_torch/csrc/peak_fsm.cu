// Peak detector FSM with lockout / look-ahead: one serial walk per stream.
//
// Replaces the per-sample lax.scan of PeakDetector._apply_scan
// (grbaz_tpu/ops/detect.py:236, the scan at :288), which the JAX package
// keeps because a lockout window swallows or trims the next rise and a
// look-ahead splits a run: each sample's step depends on the emissions
// before it, so no segment decomposition applies. Rows of x [B, n] are
// independent streams (B = 1 for PeakDetector.apply, a decoder bank's
// channels for B > 1).
//
// What bounds it: the dependent chain of one step, not memory. A step
// reads one float and writes nothing unless it emits; the chain from the
// lockout count through the rise state to the emit decision and back
// (compare, select, subtract, compare, select) is a few dependent
// instructions of ~4 cycles each, so a row of n samples takes at least n
// times that chain (chip_smoke.py derives the bound from the SASS count).
// The design keeps that chain free of memory latency and branches:
//   * one block per row; lane 0 of warp 0 walks the row with the whole
//     state and the constants in registers, each step a run of selects
//     with a branch only around an emission's stores (PERF.md compares a
//     first version whose if/else blocks compiled to two branches and two
//     convergence barriers a step);
//   * warps 1-3 stage the row through shared memory in chunks of
//     kChunk samples, double-buffered: while the walker runs chunk c, they
//     copy chunk c+1 and zero its outputs; one __syncthreads per chunk;
//   * a mark is a read-modify-write of the row's outputs at
//     clip(peak_pos - base, 0, n-1) by the walker alone (peaks of an
//     earlier block land on sample 0 and sum there, as in the JAX
//     scatter-add); a peak is never later than the sample that emits it,
//     so its chunk has been zeroed before;
//   * every float operation is an explicit intrinsic, so nvcc contracts
//     nothing on its own: the average is __fmaf_rn(alpha, prev,
//     __fmul_rn(1-alpha, ave)), the one fused multiply-add that XLA makes
//     of the JAX scan's alpha*prev + (1-alpha)*ave on the CPU, and the
//     compares' product and difference are __fmul_rn / __fsub_rn. Every
//     rounding is the plain version's, and the marks, idx_diff and state
//     equal it bit for bit.
//
// State in and out (struct of arrays over the rows): float [4][B] = ave,
// prev, first, peak; int [6][B] = rising, rise_count, peak_age,
// lockout_count, last_peak_global, global_idx. int32 arithmetic wraps as
// the JAX package's does.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

// the FSM's constants, passed by value from ctypes (ops/cuda/peak_fsm.py);
// outside the unnamed namespace so that the C entry point keeps external
// linkage
struct PeakFsmConfig {
  float alpha;     // f32(alpha)
  float beta;      // f32(1 - alpha)
  float keep;      // f32(1 - drop)
  float min_diff;  // f32(min_diff)
  int min_len;
  int lockout;
  int look_ahead;
};

namespace {

constexpr int kThreads = 128;  // warp 0 walks (lane 0), warps 1-3 stage
constexpr int kChunk = 4096;   // samples per staged chunk (16 KB)

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(kThreads)
    peak_fsm_kernel(const float* __restrict__ x, int n,
                    const float* __restrict__ thr,
                    const float* __restrict__ fin, const int* __restrict__ iin,
                    float* __restrict__ marks, int* __restrict__ idx_out,
                    float* __restrict__ fout, int* __restrict__ iout,
                    PeakFsmConfig cfg) {
  __shared__ float stage[2][kChunk];
  const int rows = gridDim.x;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xr = x + static_cast<int64_t>(row) * n;
  float* mr = marks + static_cast<int64_t>(row) * n;
  int* ir = idx_out + static_cast<int64_t>(row) * n;
  const int nchunks = (n + kChunk - 1) / kChunk;

  // copy chunk c of the row into its buffer and zero its outputs
  auto stage_chunk = [&](int c, int t0, int nt) {
    const int base = c * kChunk;
    const int len = min(kChunk, n - base);
    float* s = stage[c & 1];
    for (int i = t0; i < len; i += nt) {
      s[i] = xr[base + i];
      mr[base + i] = 0.f;
      ir[base + i] = 0;
    }
  };
  stage_chunk(0, tid, kThreads);
  __syncthreads();

  float ave = 0.f, prev = 0.f, first = 0.f, peak = 0.f, t = 0.f;
  bool rising = false;
  int rc = 0, pa = 0, lc = 0, last = 0, gidx = 0, base = 0;
  if (tid == 0) {
    ave = fin[0 * rows + row];
    prev = fin[1 * rows + row];
    first = fin[2 * rows + row];
    peak = fin[3 * rows + row];
    rising = iin[0 * rows + row] != 0;
    rc = iin[1 * rows + row];
    pa = iin[2 * rows + row];
    lc = iin[3 * rows + row];
    last = iin[4 * rows + row];
    gidx = iin[5 * rows + row];
    base = gidx;
    t = thr[row];
  }
  // the constants in registers, outside the walk
  const float alpha = cfg.alpha, beta = cfg.beta, keep = cfg.keep;
  const float min_diff = cfg.min_diff;
  const int min_len = cfg.min_len, lockout = cfg.lockout;
  const int look_ahead = cfg.look_ahead;
  const bool use_look_ahead = look_ahead > 0;

  for (int c = 0; c < nchunks; ++c) {
    if (tid >= 32) {
      if (c + 1 < nchunks) stage_chunk(c + 1, tid - 32, kThreads - 32);
    } else if (tid == 0) {
      const float* s = stage[c & 1];
      const int len = min(kChunk, n - c * kChunk);
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        // one step of PeakDetector._apply_scan as selects: no branch but
        // the rare emission's stores (bitwise & and | do not short-cut)
        const float xi = s[i];
        ave = __fmaf_rn(alpha, prev, __fmul_rn(beta, ave));
        const bool unlocked = lc <= 0;
        const bool cond = (xi >= t) & (xi > __fmul_rn(ave, keep));
        const bool start = cond & !rising;
        const bool upd = start | (cond & rising & (xi > peak));
        first = (unlocked & start) ? xi : first;
        peak = (unlocked & upd) ? xi : peak;
        pa = unlocked ? (upd ? 0 : wadd(pa, 1)) : pa;
        const int rc_n =
            unlocked ? (start ? 1 : wadd(rc, static_cast<int>(cond))) : rc;
        const bool ended =
            rising & (!cond | (use_look_ahead & (pa >= look_ahead)));
        const bool emit = ended & unlocked & (rc_n >= min_len) &
                          (__fsub_rn(peak, first) >= min_diff);
        if (emit) {
          const int pos = wsub(gidx, pa);
          const int rel = min(max(wsub(pos, base), 0), n - 1);
          mr[rel] += 1.f;
          if (last >= 0) ir[rel] = wadd(ir[rel], wsub(pos, last));
          last = pos;
        }
        lc = emit ? lockout : (unlocked ? 0 : lc - 1);
        rising = unlocked ? (cond & !ended) : rising;
        rc = ended ? 0 : rc_n;
        prev = xi;
        gidx = wadd(gidx, 1);
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    fout[0 * rows + row] = ave;
    fout[1 * rows + row] = prev;
    fout[2 * rows + row] = first;
    fout[3 * rows + row] = peak;
    iout[0 * rows + row] = rising ? 1 : 0;
    iout[1 * rows + row] = rc;
    iout[2 * rows + row] = pa;
    iout[3 * rows + row] = lc;
    iout[4 * rows + row] = last;
    iout[5 * rows + row] = gidx;
  }
}

}  // namespace

extern "C" int peak_fsm(const float* x, int n, int rows, const float* thr,
                        const float* fin, const int* iin, float* marks,
                        int* idx_out, float* fout, int* iout,
                        PeakFsmConfig cfg,
                        void* stream) {
  if (n < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  peak_fsm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, thr, fin, iin, marks, idx_out, fout, iout, cfg);
  return static_cast<int>(cudaGetLastError());
}
