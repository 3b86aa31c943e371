// The DPLL bit synchronizer's walk on the card.
//
// Replaces the per-sample lax.scan of DPLLBitSync.apply
// (grbaz_tpu/ops/decode.py:118, scan at :180). Each row of pulses [B, n]
// is one stream, walked by one warp from the row's carried period
// estimate, phase, pulse count, last pulse index and sample index.
// Every float32 rounding is written out as XLA compiles the JAX scan on
// the CPU: freq = 1 / period; phase + freq; the measured period
// (phase + freq) * period (XLA rewrites the scan's phase / freq so); the
// ratio (measured - period) / period; the clamp to period * (1 -+ rel);
// and the update, one product of which XLA contracts into a fused
// multiply-add: fma(1 - g, period, g * clamped), or fma(g, clamped,
// (1 - g) * period) where (1 - g) is a clamp bound too and that product
// is shared (`fuse_gain`; decode.dpll_fuses_gain decides). Events (index
// diff, new period, measured period) are written at the row's running
// count; past 511 they are summed into row 511 in order, the JAX
// scatter-add's rule.
//
// Pulse to pulse. The period changes only on a pulse, so freq = 1 /
// period is the same float on every sample between two pulses and its
// reciprocal is taken again only on a pulse; between pulses the
// state moves by phase = fl(phase + freq) alone, and the measured period
// and the ratio matter only on a pulse. The warp stages the row in tiles
// of 1024 samples, each lane four neighbouring samples of each group of
// 128 as one 32-bit load (byte loads where the row is not aligned), two
// tiles ahead of the walk. Per tile: a 4-bit pulse mask a lane and group
// (`__vcmpne4`), the pulses written back as 0/1, and the tile's pulse
// list in shared memory, in sample order, placed by one warp scan of the
// lanes' counts packed a byte a group. Every lane then walks the list in
// lockstep, so the state needs no broadcast and no lane branches apart:
// the fadd chain up to the pulse (`advance`), then the pulse step
// (`pulse_step`: the ratio test beside the clamp, the update and the new
// freq), each pulse's new period and event fields stored to shared
// memory. The warp then writes the tile's events and period estimates,
// four samples a lane: a sample takes the period of the last pulse at or
// before it in the tile (the pulses before its lane's four plus those of
// the four up to it), or the period the tile started with.
//
// Bound: the serial float chain, n fadd latencies plus a pulse step a
// pulse; `dpll_fadd_probe` and `dpll_pulse_probe` time the two alone.
// The bytes (n in, 5n out) bound nothing next to the chain.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch. State rows: float [2, B] = period, phase;
// int32 [3, B] = count, last_idx, global_idx.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTile = 1024;   // samples a tile: 4 a lane in 8 groups
constexpr int kMaxEvents = 512;

struct DpllConst {
  float omg, g, lo, hi, ign;   // 1 - gain, gain, 1 - rel, 1 + rel, ignore
};

struct Walk {
  float period, phase, freq;   // freq = fl(1 / period), kept with it
  int count, last;
};

// `n` samples with no pulse: the phase's fadd chain (eight at a time,
// then 4, 2 and 1 as n's bits say: few branches for a short gap)
__device__ __forceinline__ float advance(float phase, float freq, int n) {
  for (int j = n >> 3; j > 0; --j) {
#pragma unroll
    for (int u = 0; u < 8; ++u) phase = __fadd_rn(phase, freq);
  }
  if (n & 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) phase = __fadd_rn(phase, freq);
  }
  if (n & 2) {
    phase = __fadd_rn(phase, freq);
    phase = __fadd_rn(phase, freq);
  }
  if (n & 1) phase = __fadd_rn(phase, freq);
  return phase;
}

// The scan's step at a pulse, sample index `now` (wrapping int32).
// Returns whether it emits an event (its fields in diff and cur). Both
// outcomes of the ratio test are computed side by side and one is
// selected: the ratio's division runs beside the clamp, the update and
// the updated period's reciprocal (the scan's freq), so the two divisions
// overlap and no branch sits on the chain. kFuse: which product the
// update's fused multiply-add takes.
template <bool kFuse>
__device__ __forceinline__ bool pulse_step(Walk& s, int now,
                                           const DpllConst& c, float& diff,
                                           float& cur) {
  const float phase = __fadd_rn(s.phase, s.freq);
  cur = __fmul_rn(phase, s.period);
  const float ratio = __fdiv_rn(__fsub_rn(cur, s.period), s.period);
  const float clamped = fminf(__fmul_rn(s.period, c.hi),
                              fmaxf(__fmul_rn(s.period, c.lo), cur));
  const float upd = kFuse
                        ? __fmaf_rn(c.g, clamped, __fmul_rn(c.omg, s.period))
                        : __fmaf_rn(c.omg, s.period, __fmul_rn(c.g, clamped));
  const float upd_freq = __fdiv_rn(1.0f, upd);
  const bool adjust = (s.count > 0) & (fabsf(ratio) < c.ign);
  s.period = adjust ? upd : s.period;
  s.freq = adjust ? upd_freq : s.freq;
  const bool emit = s.last >= 0;
  diff = __int2float_rn(static_cast<int>(static_cast<unsigned>(now) -
                                         static_cast<unsigned>(s.last)));
  s.phase = 0.0f;
  s.count = static_cast<int>(static_cast<unsigned>(s.count) + 1u);
  s.last = now;
  return emit;
}

// A lane's four samples t + 128k + 4 lane + j (j = 0..3) of each group k
// of a tile as one word, byte j = sample j; zero past the row's end.
// vec: the row's samples are 4-byte aligned and n a multiple of 4.
__device__ __forceinline__ void load_tile(uint32_t (&v)[kTile / 128],
                                          const uint8_t* x, int t, int n,
                                          bool vec, int lane) {
#pragma unroll
  for (int k = 0; k < kTile / 128; ++k) {
    const int i = t + 128 * k + 4 * lane;
    if (vec) {
      v[k] = i < n ? *reinterpret_cast<const uint32_t*>(x + i) : 0u;
    } else {
      v[k] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) v[k] |= static_cast<uint32_t>(x[i + j]) << (8 * j);
    }
  }
}

template <bool kFuse>
__global__ void __launch_bounds__(32)
dpll_kernel(const uint8_t* __restrict__ pulses, int n, int rows, int vec,
            const float* __restrict__ fin, const int* __restrict__ iin,
            DpllConst c, uint8_t* __restrict__ p_out,
            float* __restrict__ periods, float* __restrict__ events,
            int* __restrict__ n_ev, float* __restrict__ fout,
            int* __restrict__ iout) {
  constexpr int kGroups = kTile / 128;
  // the tile's pulses in order: sample index, new period, event fields
  // and event row (-1: none)
  __shared__ int pj[kTile], pev[kTile];
  __shared__ float pper[kTile], pdiff[kTile], pcur[kTile];
  const int r = blockIdx.x, lane = threadIdx.x;
  const size_t off = static_cast<size_t>(r) * n;
  const uint8_t* x = pulses + off;
  float* ev = events + static_cast<size_t>(r) * kMaxEvents * 3;
  Walk s{fin[r], fin[rows + r], 0.0f, iin[r], iin[rows + r]};
  s.freq = __fdiv_rn(1.0f, s.period);
  const int gidx = iin[2 * rows + r];
  int k = 0, pos = 0;   // events so far; the next sample the phase needs
  float last0 = 0.0f, last1 = 0.0f, last2 = 0.0f;   // row 511's sums
  // this tile's samples and the next two tiles', loaded ahead
  uint32_t v0[kGroups], v1[kGroups], v2[kGroups];
  load_tile(v0, x, 0, n, vec, lane);
  load_tile(v1, x, kTile, n, vec, lane);
  for (int t0 = 0; t0 < n; t0 += kTile) {
    load_tile(v2, x, t0 + 2 * kTile, n, vec, lane);
    // each group's pulses as a 4-bit mask a lane (bit j: sample j), the
    // pulses written back as 0/1, and the lanes' counts packed a byte a
    // group (at most 128 a group: no carry between the bytes)
    uint32_t nib[kGroups];
    unsigned long long cnt = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const uint32_t m = __vcmpne4(v0[g], 0u);
      nib[g] = ((m & 0x08040201u) * 0x01010101u) >> 24;
      cnt |= static_cast<unsigned long long>(__popc(nib[g])) << (8 * g);
      const int i = t0 + 128 * g + 4 * lane;
      if (vec) {
        if (i < n)
          *reinterpret_cast<uint32_t*>(p_out + off + i) = m & 0x01010101u;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i + j < n) p_out[off + i + j] = (nib[g] >> j) & 1u;
      }
    }
    // the tile's pulse list, in sample order: group by group, lane by lane
    unsigned long long incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    const unsigned long long excl = incl - cnt;
    const unsigned long long tot = __shfl_sync(kFull, incl, 31);
    int base[kGroups], total = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      base[g] = total + static_cast<int>((excl >> (8 * g)) & 0xFFu);
      total += static_cast<int>((tot >> (8 * g)) & 0xFFu);
      int o = base[g];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((nib[g] >> j) & 1u) pj[o++] = 128 * g + 4 * lane + j;
    }
    __syncwarp();
    // the walk, every lane in lockstep (shared stores of one value)
    const float start = s.period;
    int jn = total ? pj[0] : 0;
    for (int p = 0; p < total; ++p) {
      const int i = t0 + jn;
      jn = p + 1 < total ? pj[p + 1] : 0;
      s.phase = advance(s.phase, s.freq, i - pos);
      pos = i + 1;
      float diff, cur;
      const int now = static_cast<int>(static_cast<unsigned>(gidx) +
                                       static_cast<unsigned>(i));
      const bool emit = pulse_step<kFuse>(s, now, c, diff, cur);
      pper[p] = s.period;
      pdiff[p] = diff;
      pcur[p] = cur;
      pev[p] = emit ? k : -1;
      const bool sum = emit & (k >= kMaxEvents - 1);
      last0 = sum ? __fadd_rn(last0, diff) : last0;
      last1 = sum ? __fadd_rn(last1, s.period) : last1;
      last2 = sum ? __fadd_rn(last2, cur) : last2;
      k += emit;
    }
    __syncwarp();
    // the tile's events below row 511, and its period estimates: a
    // sample takes the period of the last pulse at or before it in the
    // tile (the pulses before its lane's four plus those of the four up
    // to it), or the period the tile started with
    for (int p = lane; p < total; p += 32) {
      const int e = pev[p];
      if (e >= 0 && e < kMaxEvents - 1) {
        ev[3 * e] = pdiff[p];
        ev[3 * e + 1] = pper[p];
        ev[3 * e + 2] = pcur[p];
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float est[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int before = base[g] + __popc(nib[g] & ((2u << j) - 1u));
        est[j] = before ? pper[before - 1] : start;
      }
      const int i = t0 + 128 * g + 4 * lane;
      if (vec) {
        if (i < n)
          *reinterpret_cast<float4*>(periods + off + i) =
              make_float4(est[0], est[1], est[2], est[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i + j < n) periods[off + i + j] = est[j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      v0[g] = v1[g];
      v1[g] = v2[g];
    }
  }
  s.phase = advance(s.phase, s.freq, n - pos);
  for (int j = 3 * min(k, kMaxEvents - 1) + lane; j < 3 * (kMaxEvents - 1);
       j += 32)
    ev[j] = 0.0f;
  if (lane == 0) {
    ev[3 * (kMaxEvents - 1)] = last0;
    ev[3 * (kMaxEvents - 1) + 1] = last1;
    ev[3 * (kMaxEvents - 1) + 2] = last2;
    n_ev[r] = min(k, kMaxEvents);
    fout[r] = s.period;
    fout[rows + r] = s.phase;
    iout[r] = s.count;
    iout[rows + r] = s.last;
    iout[2 * rows + r] = static_cast<int>(static_cast<unsigned>(gidx) +
                                          static_cast<unsigned>(n));
  }
}

// `steps` samples of the fadd chain alone on one thread (timed for the
// walk's bound: ns a sample)
__global__ void fadd_probe_kernel(int steps, float* out) {
  __shared__ float f;
  if (threadIdx.x == 0) f = 1.0f / 97.0f;
  __syncthreads();
  if (threadIdx.x != 0) return;
  out[0] = advance(0.0f, f, steps);
}

// `steps` pulse steps back to back on one thread, each from a phase near
// a pulse at period ~97 (a shared-memory table) so that every step takes
// the update (timed for the walk's bound: ns a pulse)
__global__ void pulse_probe_kernel(int steps, float* out) {
  __shared__ float tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = (96.0f + 0.8f * ((i * 37) % 11 - 5) / 5.0f) / 97.0f;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const DpllConst c{0.95f, 0.05f, 0.95f, 1.05f, 0.5f};
  Walk s{97.0f, 0.0f, 1.0f / 97.0f, 1, 0};
  float acc = 0.0f;
  for (int i = 0; i < steps; ++i) {
    float diff, cur;
    s.phase = tab[i & 1023];
    if (pulse_step<true>(s, i, c, diff, cur)) acc += cur;
  }
  out[0] = acc + s.period;
}

}  // namespace

extern "C" int dpll_walk(const uint8_t* pulses, int n, int rows, int vec,
                         const float* fin, const int* iin, float omg, float g,
                         float lo, float hi, float ign, int fuse_gain,
                         uint8_t* p_out, float* periods, float* events,
                         int* n_ev, float* fout, int* iout, void* stream) {
  if (n < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DpllConst c{omg, g, lo, hi, ign};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fuse_gain)
    dpll_kernel<true><<<rows, 32, 0, st>>>(pulses, n, rows, vec, fin, iin,
                                           c, p_out, periods, events, n_ev,
                                           fout, iout);
  else
    dpll_kernel<false><<<rows, 32, 0, st>>>(pulses, n, rows, vec, fin, iin,
                                            c, p_out, periods, events, n_ev,
                                            fout, iout);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpll_fadd_probe(int steps, void* out, void* stream) {
  fadd_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpll_pulse_probe(int steps, void* out, void* stream) {
  pulse_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
