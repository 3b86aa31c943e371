// Peak detector FSM with lockout / look-ahead: a chunk-parallel speculative
// walk, bit-equal to the serial scan.
//
// Replaces the per-sample lax.scan of PeakDetector._apply_scan
// (grbaz_tpu/ops/detect.py:236, the scan at :288), which the JAX package
// keeps because a lockout window swallows or trims the next rise and a
// look-ahead splits a run: each step depends on the emissions before it,
// so no segment decomposition applies. Rows of x [B, n] are independent
// streams (B = 1 for PeakDetector.apply, a decoder bank's channels for
// B > 1).
//
// What bounds it: the bytes (x read once, marks and idx_diff written once,
// 12 B a sample), plus the chain of checks across chunks. A serial walk is
// bound instead by its dependent chain of a few instructions a sample, one
// thread a row; this design takes that chain off the row:
//   * the FSM forgets. While not rising, the rise's fields (rise_count,
//     first, peak, peak_age) are dead: no decision reads them before the
//     next start overwrites them. A lockout lasts `lockout` samples, the
//     average is a contraction (a copy of prev for alpha = 1), and the last
//     emission's position feeds no decision. So the state at a sample is
//     fixed by the samples shortly before it, in all but rare data;
//   * pass 1 (speculate): each row is cut into chunks of `chunk` samples,
//     one thread a chunk, 32 chunks a block, the block's samples staged
//     into shared memory by coalesced cp.async (one pad word a chunk, so
//     that the 32 walkers read 32 banks). Chunk 0 walks from the carried
//     state. Every other chunk starts `warm` samples before its start
//     from a guess (not rising, not locked, ave and prev from the input),
//     walks the warm-up without output, keeps the state at its start (the
//     guess), walks its chunk and records its end state, its emissions
//     (in scratch, never in the outputs) and whether its walk saw a start.
//     The block zeroes its part of marks and idx_diff;
//   * pass 2 (check, repair, patch): one warp a row walks the chunk
//     records in order, 32 at a time. Two states are equivalent when ave,
//     prev, rising and the lockout count are bit-equal and, where rising,
//     the rise's fields too: equivalent states take the same decisions
//     on the same samples. A chunk is confirmed when its guess is
//     equivalent to the true end of the chunk before; the true end of a
//     confirmed chunk is equivalent to its recorded end, so a lane checks
//     its guess against its neighbour's recorded end, and the first lane
//     that fails is the only one that needs the true state. Each
//     confirmed lane records the last emission before its chunk (a ballot
//     of the lanes that emitted, else the carried value). The state is
//     carried past them: ave, prev,
//     rising and the lockout count from the last confirmed lane's end,
//     the last emission from the last lane that emitted, and the dead
//     fields from the last lane that saw a start (or was rising at its
//     start), else the true start's with peak_age advanced by the
//     unlocked steps since (a warp sum, wrapping). The failing chunk is
//     walked again from the true state by one lane, its emissions straight
//     into the outputs, and the check resumes after it. Only misses are
//     walked again, so the worst case (every chunk a miss, as on a
//     monotone ramp) is one serial walk of the row; pass 2 counts them.
//     The records of the next two windows load while one is checked;
//   * pass 3 (apply): one thread a confirmed chunk adds its emissions to
//     the outputs, the first one's idx_diff patched with the recorded last
//     emission before it where that is >= 0 (atomics: 1.0 to a mark and
//     wrapping int32 to idx_diff give the same bits in any order). So the
//     serial pass reads no emission, however dense they are.
// The result is exact whatever chunk and warm are: a guess only decides
// how much is walked again. Every float operation is an explicit
// intrinsic, so nvcc contracts nothing on its own: the average is
// __fmaf_rn(alpha, prev, __fmul_rn(1-alpha, ave)), the one fused
// multiply-add that XLA makes of the JAX scan's alpha*prev +
// (1-alpha)*ave on the CPU, and the compares' product and difference are
// __fmul_rn / __fsub_rn. Every rounding is the plain version's, and the
// marks, idx_diff and state equal it bit for bit.
//
// State in and out (struct of arrays over the rows): float [4][B] = ave,
// prev, first, peak; int [6][B] = rising, rise_count, peak_age,
// lockout_count, last_peak_global, global_idx. int32 arithmetic wraps as
// the JAX package's does. Scratch (the wrapper allocates it, nothing is
// read before it is written): float [8][B*K] and int [10][B*K] chunk
// records (K = ceil(n / chunk)), int2 [B*K][chunk/2 + 1] emissions
// (rel, idx_diff; the first one's position), int [B] repaired chunks.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spec_fsm.cuh"

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

using namespace spec_fsm;

constexpr int kWalkers = 32;  // chunks (threads) of a pass-1 block

// chunk record rows: floats, then ints
enum { kGAve, kGPrev, kGFirst, kGPeak, kEAve, kEPrev, kEFirst, kEPeak };
enum { kGRc, kGPa, kGLc, kERc, kEPa, kELc, kELast, kFlags, kConf, kBefore,
       kIntRows };
// kFlags: bit 0 guess rising, bit 1 end rising, bit 2 fresh (the end's
// rise fields are its own: rising at its start or a start in its walk),
// the number of emissions from bit 3 on. Pass 2 writes kConf (1 where
// confirmed, 0 where walked again) and kBefore (the last emission before
// a confirmed chunk) for pass 3.

struct St {
  float ave, prev, first, peak;
  bool rising;
  int rc, pa, lc;
};

// one step of PeakDetector._apply_scan as selects (bitwise & and | do not
// short-cut); returns whether it emits, `started` whether it started a rise
__device__ __forceinline__ bool step(St& s, float xi, float t,
                                     const PeakFsmConfig& c, bool& started) {
  s.ave = __fmaf_rn(c.alpha, s.prev, __fmul_rn(c.beta, s.ave));
  const bool unlocked = s.lc <= 0;
  const bool cond = (xi >= t) & (xi > __fmul_rn(s.ave, c.keep));
  const bool start = cond & !s.rising;
  const bool upd = start | (cond & s.rising & (xi > s.peak));
  s.first = (unlocked & start) ? xi : s.first;
  s.peak = (unlocked & upd) ? xi : s.peak;
  s.pa = unlocked ? (upd ? 0 : wadd(s.pa, 1)) : s.pa;
  const int rc_n =
      unlocked ? (start ? 1 : wadd(s.rc, static_cast<int>(cond))) : s.rc;
  const bool ended =
      s.rising & (!cond | ((c.look_ahead > 0) & (s.pa >= c.look_ahead)));
  const bool emit = ended & unlocked & (rc_n >= c.min_len) &
                    (__fsub_rn(s.peak, s.first) >= c.min_diff);
  s.lc = emit ? c.lockout : (unlocked ? 0 : s.lc - 1);
  s.rising = unlocked ? (cond & !ended) : s.rising;
  s.rc = ended ? 0 : rc_n;
  s.prev = xi;
  started = unlocked & start;
  return emit;
}

__device__ __forceinline__ int clip_rel(int pos, int base, int n) {
  return min(max(wsub(pos, base), 0), n - 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// the pass-1 tile: kWalkers chunks and the warm-up and guess samples
// before them; sample q of the tile at q + q / chunk
__host__ __device__ inline int tile_samples(int chunk, int warm) {
  return kWalkers * chunk + warm + 2;
}
__host__ __device__ inline int tile_words(int chunk, int warm) {
  const int q = tile_samples(chunk, warm);
  return q + q / chunk + 1;
}

// reads the tile one sample after another, without a division a step
struct Cursor {
  int addr, m, chunk;
  __device__ Cursor(int q, int c) : addr(q + q / c), m(q % c), chunk(c) {}
  __device__ __forceinline__ float take(const float* tile) {
    const float v = tile[addr];
    ++addr;
    if (++m == chunk) {
      m = 0;
      ++addr;
    }
    return v;
  }
};

struct Chunks {
  int chunk, warm, k;  // chunk and warm-up length, chunks per row
  int cap;             // emission slots per chunk
  float* rec_f;
  int* rec_i;
  int2* emits;
};

__global__ void __launch_bounds__(kWalkers)
    speculate_kernel(const float* __restrict__ x, int n,
                     const float* __restrict__ thr,
                     const float* __restrict__ fin, const int* __restrict__ iin,
                     float* __restrict__ marks, int* __restrict__ idx_out,
                     PeakFsmConfig cfg, Chunks ch) {
  extern __shared__ float tile[];
  const int rows = gridDim.y;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int C = ch.chunk, W = ch.warm;
  const float* xr = x + static_cast<int64_t>(row) * n;
  const int k0 = blockIdx.x * kWalkers;
  const int p0 = k0 * C - W - 2;  // the tile's first sample in the row

  // stage the tile, zero-filled outside the row, and zero the outputs
  const int nq = tile_samples(C, W);
  for (int q = tid; q < nq; q += kWalkers) {
    const int p = p0 + q;
    const bool in = p >= 0 && p < n;
    cp_async4(tile + q + q / C, xr + (in ? p : 0), in ? 4 : 0);
  }
  float* mr = marks + static_cast<int64_t>(row) * n;
  int* ir = idx_out + static_cast<int64_t>(row) * n;
  const int z1 = min(n, (k0 + kWalkers) * C);
  for (int p = k0 * C + tid; p < z1; p += kWalkers) {
    mr[p] = 0.f;
    ir[p] = 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int k = k0 + tid;
  if (k >= ch.k) return;
  const float t = thr[row];
  const int base = iin[5 * rows + row];
  St s;
  const int q = tid * C + W + 2;  // the chunk's first sample in the tile
  Cursor cu(q, C);
  if (k == 0) {
    s.ave = fin[0 * rows + row];
    s.prev = fin[1 * rows + row];
    s.first = fin[2 * rows + row];
    s.peak = fin[3 * rows + row];
    s.rising = iin[0 * rows + row] != 0;
    s.rc = iin[1 * rows + row];
    s.pa = iin[2 * rows + row];
    s.lc = iin[3 * rows + row];
  } else {
    // the guess at s0 = max(k*C - warm, 2): idle, ave and prev from the
    // two samples before s0; then the warm-up up to the chunk
    const int a0 = tid * C + max(0, W + 2 - k * C);
    cu = Cursor(a0, C);
    s.ave = cu.take(tile);
    s.prev = cu.take(tile);
    s.first = s.peak = 0.f;
    s.rising = false;
    s.rc = s.pa = s.lc = 0;
    bool started;
    for (int a = a0 + 2; a < q; ++a) step(s, cu.take(tile), t, cfg, started);
  }
  const St guess = s;
  const int len = min(C, n - k * C);
  const int kk = row * ch.k + k;
  int2* em = ch.emits + static_cast<int64_t>(kk) * ch.cap;
  int ne = 0, last = 0, gidx = wadd(base, k * C);
  bool saw_start = false;
#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    bool started;
    const bool emit = step(s, cu.take(tile), t, cfg, started);
    saw_start |= started;
    if (emit) {
      const int pos = wsub(gidx, s.pa);
      // the first emission keeps its position: pass 2 adds its idx_diff
      em[ne] = make_int2(clip_rel(pos, base, n),
                         ne == 0 ? pos : (last >= 0 ? wsub(pos, last) : 0));
      ++ne;
      last = pos;
    }
    gidx = wadd(gidx, 1);
  }
  const int kt = rows * ch.k;
  float* rf = ch.rec_f + kk;
  int* ri = ch.rec_i + kk;
  rf[kGAve * kt] = guess.ave;
  rf[kGPrev * kt] = guess.prev;
  rf[kGFirst * kt] = guess.first;
  rf[kGPeak * kt] = guess.peak;
  rf[kEAve * kt] = s.ave;
  rf[kEPrev * kt] = s.prev;
  rf[kEFirst * kt] = s.first;
  rf[kEPeak * kt] = s.peak;
  ri[kGRc * kt] = guess.rc;
  ri[kGPa * kt] = guess.pa;
  ri[kGLc * kt] = guess.lc;
  ri[kERc * kt] = s.rc;
  ri[kEPa * kt] = s.pa;
  ri[kELc * kt] = s.lc;
  ri[kELast * kt] = last;
  ri[kFlags * kt] = static_cast<int>(guess.rising) |
                    (static_cast<int>(s.rising) << 1) |
                    (static_cast<int>(guess.rising | saw_start) << 2) |
                    (ne << 3);
}

// a chunk record as a lane holds it
struct Rec {
  St g, e;
  int last, flags;
};

__device__ __forceinline__ Rec load_rec(const Chunks& ch, int kk, int kt) {
  Rec r;
  const float* rf = ch.rec_f + kk;
  const int* ri = ch.rec_i + kk;
  r.g.ave = rf[kGAve * kt];
  r.g.prev = rf[kGPrev * kt];
  r.g.first = rf[kGFirst * kt];
  r.g.peak = rf[kGPeak * kt];
  r.e.ave = rf[kEAve * kt];
  r.e.prev = rf[kEPrev * kt];
  r.e.first = rf[kEFirst * kt];
  r.e.peak = rf[kEPeak * kt];
  r.g.rc = ri[kGRc * kt];
  r.g.pa = ri[kGPa * kt];
  r.g.lc = ri[kGLc * kt];
  r.e.rc = ri[kERc * kt];
  r.e.pa = ri[kEPa * kt];
  r.e.lc = ri[kELc * kt];
  r.last = ri[kELast * kt];
  r.flags = ri[kFlags * kt];
  r.g.rising = r.flags & 1;
  r.e.rising = (r.flags >> 1) & 1;
  return r;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_int(a) == __float_as_int(b);
}

// the check's equivalence: the fields that decide the next steps
__device__ __forceinline__ bool equivalent(const St& g, const St& s) {
  const bool core = same_bits(g.ave, s.ave) & same_bits(g.prev, s.prev) &
                    (g.rising == s.rising) & (g.lc == s.lc);
  const bool rise = (g.rc == s.rc) & (g.pa == s.pa) &
                    same_bits(g.first, s.first) & same_bits(g.peak, s.peak);
  return core & (!g.rising | rise);
}

__global__ void __launch_bounds__(32)
    chain_kernel(const float* __restrict__ x, int n,
                 const float* __restrict__ thr,
                 const float* __restrict__ fin, const int* __restrict__ iin,
                 float* __restrict__ marks, int* __restrict__ idx_out,
                 float* __restrict__ fout, int* __restrict__ iout,
                 PeakFsmConfig cfg, Chunks ch, int* __restrict__ repairs) {
  extern __shared__ float buf[];  // a chunk walked again
  const int rows = gridDim.x;
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int C = ch.chunk, K = ch.k, kt = rows * K;
  const float* xr = x + static_cast<int64_t>(row) * n;
  float* mr = marks + static_cast<int64_t>(row) * n;
  int* ir = idx_out + static_cast<int64_t>(row) * n;
  const float t = thr[row];
  const int base = iin[5 * rows + row];
  // the true state at the next unchecked chunk, the same in every lane
  St S;
  S.ave = fin[0 * rows + row];
  S.prev = fin[1 * rows + row];
  S.first = fin[2 * rows + row];
  S.peak = fin[3 * rows + row];
  S.rising = iin[0 * rows + row] != 0;
  S.rc = iin[1 * rows + row];
  S.pa = iin[2 * rows + row];
  S.lc = iin[3 * rows + row];
  int last = iin[4 * rows + row];
  int nrep = 0;

  // the records of the next two windows are in flight while one is checked
  Rec nxt{}, nxt2{};
  if (lane < K) nxt = load_rec(ch, row * K + lane, kt);
  if (32 + lane < K) nxt2 = load_rec(ch, row * K + 32 + lane, kt);
  for (int w = 0; w < K; w += 32) {
    const Rec cur = nxt;
    nxt = nxt2;
    if (w + 64 + lane < K) nxt2 = load_rec(ch, row * K + w + 64 + lane, kt);
    const int k = w + lane;
    const int nvalid = min(32, K - w);
    const bool valid = lane < nvalid;
    const St pred = from_lane_below(cur.e);  // the recorded end of chunk k-1
    const int ne = valid ? cur.flags >> 3 : 0;
    const bool fresh = (cur.flags >> 2) & 1;
    const bool pred_ok = equivalent(cur.g, pred);
    for (int lo = 0; lo < nvalid;) {
      const bool ok = lane == lo ? (k == 0 || equivalent(cur.g, S)) : pred_ok;
      const unsigned fail = __ballot_sync(kAll, valid & (lane >= lo) & !ok);
      const int f = fail ? __ffs(fail) - 1 : nvalid;
      const unsigned conf = lanes(lo, f);
      const bool mine = (conf >> lane) & 1u;
      // the confirmed chunks, for pass 3 to add their emissions, with the
      // last emission before each chunk for its first idx_diff
      const unsigned emitted = __ballot_sync(kAll, mine & (ne > 0));
      const unsigned before = emitted & ((1u << lane) - 1u);
      const int lb_lane =
          from_lane(cur.last, before ? top_lane(before) : 0);
      if (mine) {
        ch.rec_i[kConf * kt + row * K + k] = 1;
        ch.rec_i[kBefore * kt + row * K + k] = before ? lb_lane : last;
      }
      if (f > lo) {
        // carry the true state past the confirmed chunks
        const int L = f - 1;
        const St end = from_lane(cur.e, L);
        if (emitted) last = from_lane(cur.last, top_lane(emitted));
        const unsigned fr = __ballot_sync(kAll, mine & fresh);
        const int h = fr ? top_lane(fr) : lo - 1;
        const int adv = (mine & (lane > h)) ? wsub(cur.e.pa, cur.g.pa) : 0;
        const int aged = static_cast<int>(
            __reduce_add_sync(kAll, static_cast<unsigned>(adv)));
        const St hs = from_lane(cur.e, fr ? h : 0);
        if (fr) {
          S.first = hs.first;
          S.peak = hs.peak;
          S.rc = hs.rc;
          S.pa = wadd(hs.pa, aged);
        } else {
          S.pa = wadd(S.pa, aged);
        }
        S.ave = end.ave;
        S.prev = end.prev;
        S.rising = end.rising;
        S.lc = end.lc;
      }
      if (f < nvalid) {
        // a miss: walk chunk w+f again from the true state
        const int c0 = (w + f) * C;
        const int len = min(C, n - c0);
        __syncwarp();
        for (int i = lane; i < len; i += 32) buf[i] = xr[c0 + i];
        __syncwarp();
        if (lane == 0) {
          int gidx = wadd(base, c0);
          for (int i = 0; i < len; ++i) {
            bool started;
            if (step(S, buf[i], t, cfg, started)) {
              const int pos = wsub(gidx, S.pa);
              const int rel = clip_rel(pos, base, n);
              atomicAdd(mr + rel, 1.f);
              if (last >= 0) atomicAdd(ir + rel, wsub(pos, last));
              last = pos;
            }
            gidx = wadd(gidx, 1);
          }
        }
        if (lane == 0) ch.rec_i[kConf * kt + row * K + w + f] = 0;
        S = from_lane(S, 0);
        last = from_lane(last, 0);
        ++nrep;
        lo = f + 1;
      } else {
        lo = nvalid;
      }
    }
  }
  if (lane == 0) {
    fout[0 * rows + row] = S.ave;
    fout[1 * rows + row] = S.prev;
    fout[2 * rows + row] = S.first;
    fout[3 * rows + row] = S.peak;
    iout[0 * rows + row] = S.rising ? 1 : 0;
    iout[1 * rows + row] = S.rc;
    iout[2 * rows + row] = S.pa;
    iout[3 * rows + row] = S.lc;
    iout[4 * rows + row] = last;
    iout[5 * rows + row] = wadd(base, n);
    repairs[row] = nrep;
  }
}

// pass 3: the emissions of the confirmed chunks into the outputs, one
// thread a chunk
__global__ void __launch_bounds__(128)
    apply_kernel(int n, float* __restrict__ marks, int* __restrict__ idx_out,
                 Chunks ch) {
  const int rows = gridDim.y;
  const int row = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= ch.k) return;
  const int kt = rows * ch.k;
  const int kk = row * ch.k + k;
  const int ne = ch.rec_i[kFlags * kt + kk] >> 3;
  if (ne == 0 || ch.rec_i[kConf * kt + kk] == 0) return;
  const int lb = ch.rec_i[kBefore * kt + kk];
  float* mr = marks + static_cast<int64_t>(row) * n;
  int* ir = idx_out + static_cast<int64_t>(row) * n;
  const int2* em = ch.emits + static_cast<int64_t>(kk) * ch.cap;
  for (int j = 0; j < ne; ++j) {
    const int2 e = em[j];
    atomicAdd(mr + e.x, 1.f);
    const int d = j > 0 ? e.y : (lb >= 0 ? wsub(e.y, lb) : 0);
    if (d != 0) atomicAdd(ir + e.x, d);
  }
}

}  // namespace

extern "C" int peak_fsm(const float* x, int n, int rows, const float* thr,
                        const float* fin, const int* iin, float* marks,
                        int* idx_out, float* fout, int* iout,
                        PeakFsmConfig cfg, int chunk, int warm, float* rec_f,
                        int* rec_i, void* emits, int* repairs, void* stream) {
  if (n < 1 || rows < 1 || chunk < 2 || warm < 0 ||
      static_cast<int64_t>(kWalkers) * chunk + warm + 2 > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = sizeof(float) * tile_words(chunk, warm);
  const size_t smem2 = sizeof(float) * chunk;  // < 48 KB when smem1 fits
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Chunks ch;
  ch.chunk = chunk;
  ch.warm = warm;
  ch.k = (n + chunk - 1) / chunk;
  ch.cap = chunk / 2 + 1;
  ch.rec_f = rec_f;
  ch.rec_i = rec_i;
  ch.emits = static_cast<int2*>(emits);
  const cudaError_t e = fit_smem(speculate_kernel, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid1((ch.k + kWalkers - 1) / kWalkers, rows);
  const dim3 grid3((ch.k + 127) / 128, rows);
  return launch_passes(
      [&] {
        speculate_kernel<<<grid1, kWalkers, smem1, s>>>(
            x, n, thr, fin, iin, marks, idx_out, cfg, ch);
      },
      [&] {
        chain_kernel<<<rows, 32, smem2, s>>>(x, n, thr, fin, iin, marks,
                                             idx_out, fout, iout, cfg, ch,
                                             repairs);
      },
      [&] { apply_kernel<<<grid3, 128, 0, s>>>(n, marks, idx_out, ch); });
}
