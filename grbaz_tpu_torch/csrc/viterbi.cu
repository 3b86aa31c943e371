// Soft-decision rate-1/2 Viterbi decoding on the card.
//
// Replaces viterbi_decode's add-compare-select scan and traceback scan
// (grbaz_tpu/ops/fec.py:244, scans at :268 and :276) for every constraint
// length K from 2 to 30 (ns = 2^(K-1) states; the state indices are
// int32).
//
// Trellis. State t's predecessors are 2t mod ns and 2t+1 mod ns (the
// newest bit sits at the register's MSB), and states t and t + ns/2 share
// them. The expected +-1 outputs of every branch come in as an argument
// (`exp` [ns, 2, 2], as fec.expected_outputs builds it for any pair of
// polynomials; only the signs are read); each branch keeps them as a
// 2-bit code (the sign of the first output, whether the second has the
// same sign), so a step's four branch metrics are A = r0 + r1,
// B = r0 - r1 and their negations:
// fl(-r0 - r1) = -fl(r0 + r1) and fl(-r0 + r1) = -fl(r0 - r1) under
// round-to-nearest, the products by +-1 being exact.
//
// Arithmetic, bit-equal to the JAX scan on the CPU: candidates pm[pred] +
// bm, the second predecessor only where strictly greater (jnp.argmax takes
// the first of equal maxima), every step normalised by its max. The
// normalisation is folded into the next step: a step keeps its raw
// metrics x and their max m, and the next step reads fl(x[pred] - m),
// the same float the normalised metric would be, so the predecessors'
// exchange runs beside the max's reduction.
//
// The max. No metric is ever -0, so an order-preserving int32 key of each
// metric (key_of) reduced by one redux.sync gives the float max bit for
// bit: the initial metrics are +0 and -1e9; a candidate p + bm with p not
// -0 is -0 only if p and bm are both -0 (an exact cancellation rounds to
// +0 under round-to-nearest), so no candidate is -0; and x - m for x <= m
// is +0 when x == m and negative otherwise, never -0. (A -0 branch metric
// changes nothing: p + -0 = p + +0 for every p that is not -0.)
//
// Forward pass, K <= 9: one warp (viterbi_warp). Lane l holds states
// l + 32i, i < S = ns/32; for fewer than 32 states lane l holds state
// l mod ns and the lanes repeat one another. The two predecessors of
// states l + 32i and l + 32i + ns/2 sit in lanes 2l mod 32 and 2l+1 mod
// 32, slot 2i (lanes below 16) or 2i+1: four shuffles fetch them. Soft
// pairs are staged in shared memory 512 at a time, the next 512 loaded
// into registers while the warp works on these. The steps run in
// unrolled groups of 32, so that a step's bookkeeping overlaps the next
// step's chain. A step's choices are S ballot words; lane j keeps step
// j's words of every 32 and the warp stores them together.
//
// Forward pass, K >= 10: one block (viterbi_block). Each thread takes
// state pairs (t, t + ns/2); the raw metrics are double-buffered in
// shared memory (up to K = 15: 2 x 2^14 x 4 B) or, beyond that, in a
// global work area; each warp reduces its max with one redux.sync and
// leaves it in shared memory, and the next step reduces the warps' maxima
// after the step's one __syncthreads.
//
// Decisions: S 32-bit words a step (ns/8 bytes; one word for fewer than
// 32 states), in groups of 32 steps: word w of step t at
// ((t / 32) * S + w) * 32 + t % 32, so 32 steps' words of one w are one
// coalesced line.
//
// Traceback, parallel and exact. The T steps are cut into chunks of L (a
// multiple of 32). trace_map: for every chunk but the first and every end
// state, the state its first step starts from, traced L steps back (a
// thread a state, the chunk's words staged in shared memory when they
// fit). trace_bits: for every chunk, its end state, composed from the
// lowest-index best final state through the later chunks' maps, then the
// chunk's bits traced from it. The bits are those of the serial traceback
// by construction.
//
// Bound: the forward step's dependent chain (the max's fmax, key, redux
// and back, a subtract, an add, a compare and select; the shuffles run
// beside the redux), not memory (8 B in and 1 B out a pair, plus the
// decisions); `viterbi_chain_probe` times that step alone at K = 7.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kStage = 512;          // soft pairs staged a time (warp form)
constexpr int kBlockThreads = 512;   // block form, at most
constexpr int kTraceThreads = 128;
constexpr int kStageWords = 8192;    // a chunk's decisions staged, at most
constexpr int kSmemStates = 1 << 14; // block form in shared memory up to
constexpr int kKeyMin = -2147483647 - 1;

// order-preserving int32 key of a float that is not NaN; an involution
__device__ __forceinline__ int key_of(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float of_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// a branch's metric from its 2-bit code (bit 0: the first output is -1;
// bit 1: both outputs have one sign)
__device__ __forceinline__ float branch(uint32_t code, float a, float b) {
  const float v = (code & 2u) ? a : b;
  return (code & 1u) ? -v : v;
}

// state s's 4-bit code: its two branches' 2-bit codes
__device__ __forceinline__ uint32_t state_code(const float* exp, int s) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool n0 = exp[4 * s + 2 * j] < 0.0f;
    const bool n1 = exp[4 * s + 2 * j + 1] < 0.0f;
    c |= (static_cast<uint32_t>(n0) | (static_cast<uint32_t>(n0 == n1) << 1))
         << (2 * j);
  }
  return c;
}

__device__ __forceinline__ size_t dec_at(long long t, int w, int S) {
  return (static_cast<size_t>(t >> 5) * S + w) * 32 +
         static_cast<size_t>(t & 31);
}

// One add-compare-select step of the warp. raw holds the last step's raw
// metrics and m their max; on return, this step's and theirs. code holds
// the lane's states' 4-bit codes; src0/src1 are the predecessors' lanes
// and hi picks their slot. Scalars and register arrays only: a form that
// passed the lane's constants as a struct and its branch table by pointer
// ran each step ~12x slower on the H100.
template <int S>
__device__ __forceinline__ void acs(float (&raw)[S], float& m, uint32_t code,
                                    int src0, int src1, bool hi, float a,
                                    float b, bool (&c)[S]) {
  float nr[S];
#pragma unroll
  for (int i = 0; i < (S + 1) / 2; ++i) {
    float x0, x1;
    if (S == 1) {
      x0 = __shfl_sync(kFull, raw[0], src0);
      x1 = __shfl_sync(kFull, raw[0], src1);
    } else {
      const float a0 = __shfl_sync(kFull, raw[2 * i], src0);
      const float a1 = __shfl_sync(kFull, raw[2 * i + 1], src0);
      const float b0 = __shfl_sync(kFull, raw[2 * i], src1);
      const float b1 = __shfl_sync(kFull, raw[2 * i + 1], src1);
      x0 = hi ? a1 : a0;
      x1 = hi ? b1 : b0;
    }
    const float p0 = __fsub_rn(x0, m), p1 = __fsub_rn(x1, m);
    // states i and i + S/2 share these predecessors
#pragma unroll
    for (int h = 0; h < (S == 1 ? 1 : 2); ++h) {
      const int q = i + h * (S / 2);
      const float c0 = __fadd_rn(p0, branch(code >> (4 * q), a, b));
      const float c1 = __fadd_rn(p1, branch(code >> (4 * q + 2), a, b));
      c[q] = c1 > c0;
      nr[q] = c[q] ? c1 : c0;
    }
  }
  float mx = nr[0];
#pragma unroll
  for (int i = 1; i < S; ++i) mx = fmaxf(mx, nr[i]);
  m = of_key(__reduce_max_sync(kFull, key_of(mx)));
#pragma unroll
  for (int i = 0; i < S; ++i) raw[i] = nr[i];
}

template <int S>
__global__ void __launch_bounds__(32)
viterbi_warp(const float2* __restrict__ metrics, long long T,
             const float* __restrict__ exp, int k, float* __restrict__ pm_out,
             uint32_t* __restrict__ dec, int* __restrict__ best) {
  __shared__ float2 sr[2][kStage];
  const int lane = threadIdx.x;
  const int ns = 1 << (k - 1);
  const int src0 = (2 * lane) & 31, src1 = (2 * lane + 1) & 31;
  const bool hi = lane >= 16;
  uint32_t code = 0;
  float raw[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int t = (lane + 32 * i) % ns;
    code |= state_code(exp, t) << (4 * i);
    raw[i] = t == 0 ? 0.0f : -1e9f;   // as the JAX scan starts
  }
  float m = 0.0f;
  uint32_t mine[S];   // lane j: the words of step j of the 32
#pragma unroll
  for (int i = 0; i < S; ++i) mine[i] = 0;
  for (int j = lane; j < kStage; j += 32)
    if (j < T) sr[0][j] = metrics[j];
  __syncwarp();
  int b = 0;
  for (long long t0 = 0; t0 < T; t0 += kStage, b ^= 1) {
    const int len = static_cast<int>(T - t0 < kStage ? T - t0 : kStage);
    float2 nxt[kStage / 32];   // the next pairs, loaded while these run
#pragma unroll
    for (int q = 0; q < kStage / 32; ++q) {
      const long long t = t0 + kStage + 32 * q + lane;
      nxt[q] = t < T ? metrics[t] : make_float2(0.0f, 0.0f);
    }
    // whole groups of 32 steps, unrolled: a step's ballots and the
    // group's store leave the next step's chain alone
    int j = 0;
    for (; j + 32 <= len; j += 32) {
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const float2 r = sr[b][j + u];
        bool c[S];
        acs<S>(raw, m, code, src0, src1, hi, __fadd_rn(r.x, r.y),
               __fsub_rn(r.x, r.y), c);
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const uint32_t w = __ballot_sync(kFull, c[i]);
          if (lane == u) mine[i] = w;
        }
      }
#pragma unroll
      for (int i = 0; i < S; ++i) dec[dec_at(t0 + j + lane, i, S)] = mine[i];
    }
    // the stream's last steps, fewer than 32
    for (; j < len; ++j) {
      const float2 r = sr[b][j];
      bool c[S];
      acs<S>(raw, m, code, src0, src1, hi, __fadd_rn(r.x, r.y),
             __fsub_rn(r.x, r.y), c);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const uint32_t w = __ballot_sync(kFull, c[i]);
        if ((j & 31) == lane) mine[i] = w;
      }
    }
    if (len & 31) {
      if (lane < (len & 31)) {
#pragma unroll
        for (int i = 0; i < S; ++i)
          dec[dec_at(t0 + (len & ~31) + lane, i, S)] = mine[i];
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kStage / 32; ++q) sr[b ^ 1][32 * q + lane] = nxt[q];
    __syncwarp();
  }
  // normalised final metrics, and the lowest-index state holding the max
#pragma unroll
  for (int i = 0; i < S; ++i)
    if (lane + 32 * i < ns) pm_out[lane + 32 * i] = __fsub_rn(raw[i], m);
  int s = ns;
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    uint32_t hit = __ballot_sync(kFull, raw[i] == m);
    if (ns < 32) hit &= (1u << ns) - 1u;
    if (hit) s = 32 * i + __ffs(hit) - 1;
  }
  if (lane == 0) *best = s;
}

__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(kFull, v);
}

__global__ void __launch_bounds__(kBlockThreads)
viterbi_block(const float2* __restrict__ metrics, long long T,
              const float* __restrict__ exp, int k, float* __restrict__ pm_out,
              uint32_t* __restrict__ dec, int* __restrict__ best,
              unsigned char* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wkey[2][32];   // each warp's max (as a key), by parity
  __shared__ int wbest[32];
  const int ns = 1 << (k - 1), half = ns / 2, S = ns / 32;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int pairs = half / nt;
  unsigned char* base = work ? work : smem;
  float* buf = reinterpret_cast<float*>(base);          // [2][ns]
  uint8_t* codes = base + 8 * static_cast<size_t>(ns);  // [ns/2]
  for (int s = tid; s < ns; s += nt) buf[s] = s == 0 ? 0.0f : -1e9f;
  for (int q = tid; q < half; q += nt)
    codes[q] = static_cast<uint8_t>(state_code(exp, q) |
                                    (state_code(exp, q + half) << 4));
  if (tid < 32) wkey[1][tid] = key_of(0.0f);   // step 0 reads m = +0
  __syncthreads();
  float2 r = T > 0 ? metrics[0] : make_float2(0.0f, 0.0f);
  for (long long t = 0; t < T; ++t) {
    const float2 rn = t + 1 < T ? metrics[t + 1] : r;
    const float a = __fadd_rn(r.x, r.y), b = __fsub_rn(r.x, r.y);
    const int par = static_cast<int>(t & 1);
    const float m = of_key(
        __reduce_max_sync(kFull, lane < nw ? wkey[par ^ 1][lane] : kKeyMin));
    const float* cur = buf + par * ns;
    float* nxt = buf + (par ^ 1) * ns;
    float mx = __int_as_float(0xff800000);   // -inf
    for (int p = 0; p < pairs; ++p) {
      const int q = p * nt + tid;
      const float p0 = __fsub_rn(cur[2 * q], m);
      const float p1 = __fsub_rn(cur[2 * q + 1], m);
      const uint32_t cd = codes[q];
      const float l0 = __fadd_rn(p0, branch(cd, a, b));
      const float l1 = __fadd_rn(p1, branch(cd >> 2, a, b));
      const float h0 = __fadd_rn(p0, branch(cd >> 4, a, b));
      const float h1 = __fadd_rn(p1, branch(cd >> 6, a, b));
      const bool cl = l1 > l0, ch = h1 > h0;
      const float vl = cl ? l1 : l0, vh = ch ? h1 : h0;
      nxt[q] = vl;
      nxt[q + half] = vh;
      mx = fmaxf(mx, fmaxf(vl, vh));
      const uint32_t wl = __ballot_sync(kFull, cl);
      const uint32_t wh = __ballot_sync(kFull, ch);
      if (lane == 0) {
        dec[dec_at(t, p * nw + warp, S)] = wl;
        dec[dec_at(t, p * nw + warp + half / 32, S)] = wh;
      }
    }
    const int wk = __reduce_max_sync(kFull, key_of(mx));
    if (lane == 0) wkey[par][warp] = wk;
    __syncthreads();
    r = rn;
  }
  const float* fin = buf + static_cast<int>(T & 1) * ns;
  const float m = of_key(__reduce_max_sync(
      kFull, lane < nw ? wkey[static_cast<int>((T + 1) & 1)][lane] : kKeyMin));
  int sb = ns;
  for (int s = tid; s < ns; s += nt) {
    const float v = fin[s];
    pm_out[s] = __fsub_rn(v, m);
    if (v == m && s < sb) sb = s;
  }
  sb = warp_min(sb);
  if (lane == 0) wbest[warp] = sb;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_min(lane < nw ? wbest[lane] : ns);
    if (lane == 0) *best = v;
  }
}

// A chunk's decisions as a base pointer: staged into shared memory when
// they fit (every thread of the block takes part), else read in place.
// Word w of the chunk's step j sits at ((j / 32) * S + w) * 32 + j % 32.
__device__ const uint32_t* stage_chunk(const uint32_t* dec, long long t0,
                                       int len, int S, int L, uint32_t* sw) {
  const uint32_t* src = dec + static_cast<size_t>(t0 >> 5) * S * 32;
  if (static_cast<long long>(L) * S > kStageWords) return src;
  const int n = ((len + 31) >> 5) * S * 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sw[i] = src[i];
  __syncthreads();
  return sw;
}

// the state step j of a chunk came from, given the state it reached
__device__ __forceinline__ int pred(const uint32_t* words, int j, int s,
                                    int S, int half) {
  const uint32_t w = words[((j >> 5) * S + (s >> 5)) * 32 + (j & 31)];
  return 2 * (s & (half - 1)) + static_cast<int>((w >> (s & 31)) & 1u);
}

// chunk c >= 1's map: for every end state, the state its first step
// starts from
__global__ void __launch_bounds__(kTraceThreads)
trace_map(const uint32_t* __restrict__ dec, long long T, int k, int L,
          int* __restrict__ maps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long c = static_cast<long long>(blockIdx.x) + 1;
  const long long t0 = c * L;
  const int len = static_cast<int>(T - t0 < L ? T - t0 : L);
  const int ns = 1 << (k - 1), S = ns >= 32 ? ns / 32 : 1;
  const uint32_t* words = stage_chunk(dec, t0, len, S, L,
                                      reinterpret_cast<uint32_t*>(smem));
  for (int s0 = threadIdx.x; s0 < ns; s0 += blockDim.x) {
    int s = s0;
    for (int j = len - 1; j >= 0; --j) s = pred(words, j, s, S, ns / 2);
    maps[static_cast<size_t>(c) * ns + s0] = s;
  }
}

// chunk c's bits: its end state composed through the later chunks' maps
// from the best final state, then its steps traced back from it
__global__ void __launch_bounds__(kTraceThreads)
trace_bits(const uint32_t* __restrict__ dec, long long T, int k, int L,
           const int* __restrict__ maps, const int* __restrict__ best,
           uint8_t* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_end;
  const long long c = blockIdx.x;
  const long long chunks = (T + L - 1) / L;
  const long long t0 = c * L;
  const int len = static_cast<int>(T - t0 < L ? T - t0 : L);
  const int ns = 1 << (k - 1), S = ns >= 32 ? ns / 32 : 1;
  const bool staged = static_cast<long long>(L) * S <= kStageWords;
  uint8_t* sbits = smem + (staged ? static_cast<size_t>(L) * S * 4 : 0);
  if (threadIdx.x == 0) {
    int s = *best;
    for (long long d = chunks - 1; d > c; --d)
      s = maps[static_cast<size_t>(d) * ns + s];
    s_end = s;
  }
  const uint32_t* words = stage_chunk(dec, t0, len, S, L,
                                      reinterpret_cast<uint32_t*>(smem));
  __syncthreads();
  if (threadIdx.x == 0) {
    const int msb = k - 2;
    int s = s_end;
    for (int j = len - 1; j >= 0; --j) {
      sbits[j] = static_cast<uint8_t>(s >> msb);
      s = pred(words, j, s, S, ns / 2);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < len; j += blockDim.x) bits[t0 + j] = sbits[j];
}

// `steps` (a multiple of 32) add-compare-select steps of one warp at K = 7
// alone, in unrolled groups of 32 as the decoder runs them, the soft pairs
// from shared memory, no decisions kept (timed for the decoder's chain
// bound)
__global__ void chain_probe_kernel(int steps, float* out) {
  __shared__ float2 sr[1024];
  const int lane = threadIdx.x;
  for (int j = lane; j < 1024; j += 32)
    sr[j] = make_float2((j * 37 % 11) - 5.0f, (j * 53 % 7) - 3.0f);
  __syncwarp();
  uint32_t code = 0;
  float raw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    code |= static_cast<uint32_t>((lane * 7 + i * 3) % 16) << (4 * i);
    raw[i] = lane + i ? -1e9f : 0.0f;
  }
  float m = 0.0f;
  const int src0 = (2 * lane) & 31, src1 = (2 * lane + 1) & 31;
  unsigned acc = 0;
  for (int j = 0; j < steps; j += 32) {
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      bool c[2];
      const float2 r = sr[(j + u) & 1023];
      acs<2>(raw, m, code, src0, src1, lane >= 16, __fadd_rn(r.x, r.y),
             __fsub_rn(r.x, r.y), c);
      acc += c[0];
    }
  }
  out[lane] = raw[0] + raw[1] + m + static_cast<float>(acc);
}

}  // namespace

// Decodes T soft pairs with K = k: bits [T], final path metrics [ns];
// `chunk` (a multiple of 32) steps a traceback chunk; scratch: dec
// (ceil(T / 32) * 32 * max(ns / 32, 1) words), maps (ceil(T / chunk) * ns
// ints), best (one int) and, above 2^14 states, work (8.5 * ns bytes).
extern "C" int viterbi(const float* metrics, long long T, const float* exp,
                       int k, int chunk, uint8_t* bits, float* pm_out,
                       uint32_t* dec, int* maps, int* best, void* work,
                       void* stream) {
  if (T < 0 || k < 2 || k > 30 || chunk < 32 || chunk % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ns = 1 << (k - 1);
  if (k >= 10 && ns > kSmemStates && work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* m = reinterpret_cast<const float2*>(metrics);
  switch (k) {
    case 2: case 3: case 4: case 5: case 6:
      viterbi_warp<1><<<1, 32, 0, s>>>(m, T, exp, k, pm_out, dec, best);
      break;
    case 7:
      viterbi_warp<2><<<1, 32, 0, s>>>(m, T, exp, k, pm_out, dec, best);
      break;
    case 8:
      viterbi_warp<4><<<1, 32, 0, s>>>(m, T, exp, k, pm_out, dec, best);
      break;
    case 9:
      viterbi_warp<8><<<1, 32, 0, s>>>(m, T, exp, k, pm_out, dec, best);
      break;
    default: {
      const bool in_smem = ns <= kSmemStates;
      const int bytes = in_smem ? 8 * ns + ns / 2 : 0;
      if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            viterbi_block, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      const int threads = ns / 2 < kBlockThreads ? ns / 2 : kBlockThreads;
      viterbi_block<<<1, threads, bytes, s>>>(
          m, T, exp, k, pm_out, dec, best,
          in_smem ? nullptr : static_cast<unsigned char*>(work));
    }
  }
  const long long chunks = (T + chunk - 1) / chunk;
  const int S = ns >= 32 ? ns / 32 : 1;
  const int staged = static_cast<long long>(chunk) * S <= kStageWords
                         ? chunk * S * 4 : 0;
  if (chunks > 1)
    trace_map<<<static_cast<unsigned>(chunks - 1), kTraceThreads, staged, s>>>(
        dec, T, k, chunk, maps);
  if (chunks > 0)
    trace_bits<<<static_cast<unsigned>(chunks), kTraceThreads,
                 staged + chunk, s>>>(dec, T, k, chunk, maps, best, bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viterbi_chain_probe(int steps, void* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
