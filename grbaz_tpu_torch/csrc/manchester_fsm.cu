// The Manchester decoder's FSM on the card.
//
// Replaces the per-sample lax.scan of ManchesterDecode.apply
// (grbaz_tpu/ops/decode.py:44, scan at :104). Each row of chips [B, n] is
// one stream, walked from its carried state (phase, held first-of-pair
// sample, violation window, window length): pairs decode to a bit, equal
// pairs are violations, and `threshold` violations in a full `window`
// slip the pair alignment by one sample. Emissions before the row's
// `count` are kept; past the capacity n/2 + 1 they are added into the
// last slot with uint8 wrap, the JAX scatter-add's rule (threshold 0
// slips at every pair end, and alternating chips then emit at every
// sample: the last slot does fill).
//
// The state classes. After sample c - 1, c >= 2 window + 2 samples into
// a call, a state the input has shaped is fixed by its (phase, hist_len)
// and the input: prev is x[c - 1] when phase is 1 (x[c] ends the open
// pair) and x[c - 2] when it is 0; viol_hist holds the violations of the
// last min(hist_len, window) pairs ending at c - 2, c - 4, ... (phase 1)
// or c - 1, c - 3, ... (phase 0), as a slip clears it. So a stretch of
// samples maps each of the 2 (window + 1) classes to a class, and the
// maps compose. Between slips a walk only shifts pairs in: from class
// (phase, h) the next slip is at the first pair end j, at least
// window - h - 1 pairs on, whose last `window` pairs hold `threshold`
// violations (bit j of the staged slip mask), and sample j + 1 then ends
// the next pair; every pair end walked emits x[j] ^ original unless it
// is a violation.
//
// A block a row, in segments of up to 64 chunks of 256 samples. The
// block stages the segment's chips as ballot words, the violations (chip
// equal to the one before) and the slip mask (a funnel shift and a
// popcount a sample). Thread 0 walks the row's first 64 samples step by
// step from the carried state (which may be one no walk leaves) and
// checks that the state after them is its class's rebuild; warps 1-15
// walk every chunk from every class, slip to slip, into a map.
// Thread 0 composes the maps chunk by chunk; each chunk is walked again
// from its true class, marking its emitting pair ends; the marks are
// compacted in sample order (a block scan of the words' popcounts). A
// carried state that 64 samples do not bring to its class (a hist_len
// below -1) is walked step by step to the end by thread 0. The end state
// is rebuilt from the last class at n.
//
// Bound: a dependent chain of the 64-sample head (`manchester_chain_probe`
// times a step alone) and one map lookup a chunk
// (`manchester_compose_probe`), besides the parallel walks.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch. The state's fields are [B] tensors of the
// block's own types, read and written in place of a packed copy: phase,
// prev and hist_len int32, viol_hist int64 (its uint32 bits).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

struct ManFields {
  void *phase, *prev, *hist, *hlen;
};

namespace {

constexpr int kThreads = 512;
constexpr int kHead = 64;          // samples walked step by step
constexpr int kChunk = 256;        // samples a chunk
constexpr int kMaxSegChunks = 64;  // chunks a segment
constexpr int kMaxClasses = 64;    // 2 (window + 1), window <= 31
constexpr int kWords = (kMaxSegChunks * kChunk + kHead) / 32;
constexpr int kBatch = 16;         // words a warp stages a round
constexpr unsigned kEven = 0x55555555u;

struct ManState {
  int phase, prev;
  uint32_t hist;
  int hlen;
};

struct ManConst {
  int window, threshold;
  uint32_t wmask;
  uint64_t pat;   // bits 63, 61, ...: the last `window` pair ends
  int original;
};

struct Smem {
  uint32_t x[kWords + 1], viol[kWords + 1], slip[kWords + 1],
      mark[kWords + 1], slipped[kWords + 1];
  uint8_t bits_out[kWords * 32];   // the segment's emissions in order
  uint8_t maps[kMaxSegChunks * kMaxClasses];
  uint8_t start_cls[kMaxSegChunks];
  int scan[33];
  int serial, cls, total, last, bit0;
  ManState st;   // the explicit state (head, step-by-step walk)
};
static_assert(sizeof(Smem) <= 48 * 1024, "no opt-in to more shared memory");

// One step of the JAX scan. Returns whether the step decodes a pair
// (its bit in `bit`).
__device__ __forceinline__ bool man_step(ManState& s, int xi,
                                         const ManConst& k, int& bit) {
  if (s.phase != 1) {
    s.phase = 1;
    s.prev = xi;
    return false;
  }
  const bool viol = s.prev == xi;
  bit = ((s.prev == 0 && xi == 1) != (k.original != 0)) ? 1 : 0;
  s.hist = ((s.hist << 1) | (viol ? 1u : 0u)) & k.wmask;
  s.hlen = min(s.hlen + 1, k.window);
  if (s.hlen >= k.window && __popc(s.hist) >= k.threshold) {
    s.phase = 1;   // slip: this sample starts the next pair
    s.prev = xi;
    s.hist = 0;
    s.hlen = 0;
  } else {
    s.phase = 0;
  }
  return !viol;
}

__device__ __forceinline__ int bit_of(const uint32_t* w, int i) {
  return (w[i >> 5] >> (i & 31)) & 1;
}

// The first sample j >= q of j's parity `par`, below `end`, with its slip
// bit set; -1 if none (window coordinates).
__device__ __forceinline__ int next_slip(const uint32_t* slip, int q, int end,
                                         int par) {
  if (q >= end) return -1;
  const uint32_t pm = par ? ~kEven : kEven;
  int wi = q >> 5;
  uint32_t m = slip[wi] & pm & (bscan::kFull << (q & 31));
  while (m == 0u) {
    if (32 * ++wi >= end) return -1;
    m = slip[wi] & pm;
  }
  const int j = 32 * wi + __ffs(m) - 1;
  return j < end ? j : -1;
}

// From class (ph, h) at sample c to `end` (window coordinates), slip to
// slip; returns the class at `end`. kRecord: sets each slip's bit in
// `slipped`.
template <bool kRecord>
__device__ int jump_walk(Smem& sm, int c, int end, int ph, int h,
                         const ManConst& k) {
  int p = ph == 1 ? c : c + 1;   // the next pair end
  while (p < end) {
    const int j = next_slip(sm.slip, p + 2 * max(0, k.window - h - 1), end,
                            p & 1);
    if (j < 0) {
      const int last = p + 2 * ((end - 1 - p) >> 1);
      h = min(h + ((last - p) >> 1) + 1, k.window);
      p = last + 2;
      break;
    }
    if (kRecord) sm.slipped[j >> 5] |= 1u << (j & 31);
    p = j + 1;
    h = 0;
  }
  return (p == end ? 1 : 0) * (k.window + 1) + h;
}

// The emitting pair ends of the chunk [c, end) walked from class (ph, .)
// with its slips in `slipped`: the pair ends from the first, c or c + 1,
// on, of the first's parity until a slip and of the other after it
// (each slip flips it, the prefix XOR of the slips before a sample); not
// a violation and before `valid`. Whole words: a chunk starts on one.
__device__ __forceinline__ void mark_chunk(Smem& sm, int c, int end, int ph,
                                           int valid) {
  const int p0 = ph == 1 ? c : c + 1;
  uint32_t flip = 0u;   // slips so far, mod 2
  for (int wi = c >> 5; 32 * wi < end; ++wi) {
    uint32_t x = sm.slipped[wi];
    x ^= x << 1;
    x ^= x << 2;
    x ^= x << 4;
    x ^= x << 8;
    x ^= x << 16;
    x ^= flip;                              // slips at or before each bit
    const uint32_t before = (x << 1) | (flip & 1u);   // strictly before
    flip = (x >> 31) ? bscan::kFull : 0u;
    const uint32_t ends = ((p0 & 1) ? ~kEven : kEven) ^ before;
    const int v = min(valid, end) - 32 * wi;
    const uint32_t vm = v >= 32 ? bscan::kFull : v <= 0 ? 0u : (1u << v) - 1u;
    const uint32_t from = 32 * wi >= p0 ? bscan::kFull
                                        : bscan::kFull << (p0 - 32 * wi);
    sm.mark[wi] = ends & ~sm.viol[wi] & vm & from;
  }
}

// (prev, hist) of class (ph, h) at sample c (window coordinates)
__device__ __forceinline__ void rebuild(const Smem& sm, int c, int ph, int h,
                                        int window, int& prev,
                                        uint32_t& hist) {
  prev = bit_of(sm.x, ph == 1 ? c - 1 : c - 2);
  const int last = ph == 1 ? c - 2 : c - 1;
  hist = 0u;
  for (int j = 0; j < min(h, window); ++j)
    hist |= static_cast<uint32_t>(bit_of(sm.viol, last - 2 * j)) << j;
}

__global__ void __launch_bounds__(kThreads)
manchester_class_walk(const uint8_t* __restrict__ bits,
                      const int* __restrict__ count, int count_step, int n,
                      ManFields fin, uint8_t* __restrict__ out,
                      int* __restrict__ n_out, ManFields fout, ManConst k,
                      int seg_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int r = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const uint8_t* x = bits + static_cast<size_t>(r) * n;
  const int cap = n / 2 + 1;
  uint8_t* y = out + static_cast<size_t>(r) * cap;
  const int valid = count[r * count_step];
  const int nc = k.window + 1;
  const int seg = seg_chunks * kChunk;
  const int nwords = (seg + kHead) / 32;
  if (t == 0) {
    sm.st = ManState{static_cast<const int*>(fin.phase)[r],
                     static_cast<const int*>(fin.prev)[r],
                     static_cast<uint32_t>(
                         static_cast<const int64_t*>(fin.hist)[r]),
                     static_cast<const int*>(fin.hlen)[r]};
    sm.serial = 0;
    sm.total = 0;
    sm.last = 0;
    sm.bit0 = 0;
  }
  for (int s = 0; s == 0 || kHead + s * seg < n; ++s) {
    const int lo = s * seg;           // the window's first sample
    const int c0 = kHead;             // its first chunk (window coords)
    const int nch = n > lo + c0 ? min(seg_chunks,
                                      (n - lo - c0 + kChunk - 1) / kChunk)
                                : 0;
    const int end = min(n - lo, c0 + nch * kChunk);   // window coords
    const int vld = valid - lo;
    // stage: the chips as ballot words, a warp 16 words a round with their
    // loads at once
    for (int w0 = warp; w0 < nwords; w0 += kBatch * (kThreads / 32)) {
      uint8_t c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = lo + 32 * (w0 + u * (kThreads / 32)) + lane;
        c[u] = i < n ? x[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int wi = w0 + u * (kThreads / 32);
        const unsigned v = __ballot_sync(bscan::kFull, c[u] != 0);
        if (lane == 0 && wi < nwords) sm.x[wi] = v;
      }
    }
    if (t == 0) sm.x[nwords] = 0u;
    __syncthreads();
    // violations: bit i where chip i equals chip i - 1
    for (int wi = t; wi <= nwords; wi += kThreads) {
      const uint32_t cur = sm.x[wi], before = wi ? sm.x[wi - 1] : 0u;
      sm.viol[wi] = ~(cur ^ ((cur << 1) | (before >> 31)));
    }
    __syncthreads();
    // slip mask: bit j where the window pair ends j, j - 2, ... hold
    // `threshold` violations; emission marks cleared
    for (int wi = t; wi <= nwords; wi += kThreads) {
      uint32_t m = 0u;
      if (wi >= 2 && wi < nwords) {
        const uint64_t hi = static_cast<uint64_t>(sm.viol[wi]) << 32 |
                            sm.viol[wi - 1];
        const uint64_t a = sm.viol[wi - 2];
        for (int b = 0; b < 32; ++b) {
          const uint64_t f = (hi << (31 - b)) | (a >> (b + 1));
          m |= static_cast<uint32_t>(__popcll(f & k.pat) >= k.threshold)
               << b;
        }
      }
      sm.slip[wi] = m;
      sm.mark[wi] = 0u;
      sm.slipped[wi] = 0u;
    }
    __syncthreads();
    // the head, step by step from the carried state, and its check
    if (s == 0 && t == 0) {
      ManState st = sm.st;
      for (int i = 0; i < min(n, kHead); ++i) {
        int b = 0;
        if (man_step(st, bit_of(sm.x, i), k, b) && i < valid) {
          sm.mark[i >> 5] |= 1u << (i & 31);
          if (i == 0) sm.bit0 = b;
        }
      }
      sm.st = st;
      if (n > kHead) {
        int prev = 0;
        uint32_t hist = 0u;
        const bool cls = (st.phase == 0 || st.phase == 1) && st.hlen >= 0 &&
                         st.hlen <= k.window;
        if (cls) rebuild(sm, kHead, st.phase, st.hlen, k.window, prev, hist);
        sm.serial = !(cls && prev == st.prev && hist == st.hist);
        sm.cls = st.phase * nc + st.hlen;
      }
    }
    // every chunk from every class into its map (warps 1-15, while thread
    // 0 walks the head)
    for (int it = t - 32; it < nch * 2 * nc; it += kThreads - 32) {
      if (it < 0) break;
      const int ch = it / (2 * nc), cl = it - ch * 2 * nc;
      const int c = c0 + ch * kChunk;
      sm.maps[ch * kMaxClasses + cl] = static_cast<uint8_t>(jump_walk<false>(
          sm, c, min(end, c + kChunk), cl / nc, cl % nc, k));
    }
    __syncthreads();
    // compose the maps (or walk the segment step by step)
    if (t == 0 && nch > 0) {
      if (sm.serial) {
        ManState st = sm.st;
        for (int i = c0; i < end; ++i) {
          int b = 0;
          if (man_step(st, bit_of(sm.x, i), k, b) && i < vld)
            sm.mark[i >> 5] |= 1u << (i & 31);
        }
        sm.st = st;
      } else {
        int cl = sm.cls;
        for (int ch = 0; ch < nch; ++ch) {
          sm.start_cls[ch] = static_cast<uint8_t>(cl);
          cl = sm.maps[ch * kMaxClasses + cl];
        }
        sm.cls = cl;
      }
    }
    __syncthreads();
    // each chunk again from its true class, marking its emissions
    if (!sm.serial && t < nch) {
      const int c = c0 + t * kChunk, cl = sm.start_cls[t];
      const int e = min(end, c + kChunk);
      jump_walk<true>(sm, c, e, cl / nc, cl % nc, k);
      mark_chunk(sm, c, e, cl / nc, vld);
    }
    __syncthreads();
    // compaction: the marks in sample order, a block scan of popcounts
    const int per = (nwords + kThreads - 1) / kThreads;
    int mine = 0;
    for (int j = 0; j < per; ++j) {
      const int wi = t * per + j;
      if (wi < nwords) mine += __popc(sm.mark[wi]);
    }
    int seg_total = 0;
    int at = bscan::exclusive_sum(mine, sm.scan, kThreads, seg_total);
    for (int j = 0; j < per; ++j) {
      const int wi = t * per + j;
      if (wi >= nwords) break;
      uint32_t m = sm.mark[wi];
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1u;
        sm.bits_out[at++] = static_cast<uint8_t>(
            (lo + 32 * wi + b == 0) ? sm.bit0
                                    : (((sm.x[wi] >> b) & 1) ^ k.original));
      }
    }
    __syncthreads();
    // the segment's emissions stored in order, coalesced; past the
    // capacity summed into the last slot
    const int base = sm.total;
    int extra = 0;
    for (int j = t; j < seg_total; j += kThreads) {
      if (base + j < cap - 1) {
        y[base + j] = sm.bits_out[j];
      } else {
        extra += sm.bits_out[j];
      }
    }
    if (extra) atomicAdd(&sm.last, extra);
    __syncthreads();
    if (t == 0) sm.total += seg_total;
    __syncthreads();
    if (kHead + (s + 1) * seg >= n && t == 0) {
      // the end state: explicit, or the last class rebuilt at n
      ManState st = sm.st;
      if (n > kHead && !sm.serial) {
        st.phase = sm.cls / nc;
        st.hlen = sm.cls % nc;
        rebuild(sm, n - lo, st.phase, st.hlen, k.window, st.prev, st.hist);
      }
      static_cast<int*>(fout.phase)[r] = st.phase;
      static_cast<int*>(fout.prev)[r] = st.prev;
      static_cast<int64_t*>(fout.hist)[r] = st.hist;
      static_cast<int*>(fout.hlen)[r] = st.hlen;
    }
  }
  const int total = sm.total;
  for (int j = min(total, cap - 1) + t; j < cap - 1; j += kThreads) y[j] = 0;
  if (t == 0) {
    y[cap - 1] = static_cast<uint8_t>(sm.last);
    n_out[r] = min(total, cap);
  }
}

// `steps` steps of man_step alone on one thread, its inputs from shared
// memory (the head's chain)
__global__ void chain_probe_kernel(int steps, int* out) {
  __shared__ uint8_t tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = static_cast<uint8_t>((i * 2654435761u) >> 31);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const ManConst k{16, 8, 0xFFFFu, 0, 0};
  ManState s{0, 0, 0u, 0};
  int acc = 0;
  for (int i = 0; i < steps; ++i) {
    int bit = 0;
    if (man_step(s, tab[i & 1023], k, bit)) acc += bit;
  }
  out[0] = acc + s.phase;
}

// `steps` dependent map lookups on one thread, the maps in shared memory
// (the composition's chain: one a chunk)
__global__ void compose_probe_kernel(int steps, int* out) {
  __shared__ uint8_t maps[kMaxSegChunks * kMaxClasses];
  for (int i = threadIdx.x; i < kMaxSegChunks * kMaxClasses; i += blockDim.x)
    maps[i] = static_cast<uint8_t>((i * 2654435761u) >> 26);
  __syncthreads();
  if (threadIdx.x != 0) return;
  int cl = 0;
  for (int i = 0; i < steps; ++i)
    cl = maps[(i & (kMaxSegChunks - 1)) * kMaxClasses + cl];
  out[0] = cl;
}

}  // namespace

extern "C" int manchester_fsm(const uint8_t* bits, const int* count,
                              int count_step, int n, int rows, ManFields fin,
                              uint8_t* out, int* n_out, ManFields fout,
                              int original, int window, int threshold,
                              int seg_chunks, void* stream) {
  if (n < 1 || rows < 1 || window < 1 || window > 31 || seg_chunks < 1 ||
      seg_chunks > kMaxSegChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  ManConst k{window, threshold, (1u << window) - 1u, 0ull, original != 0};
  for (int j = 0; j < window; ++j) k.pat |= 1ull << (63 - 2 * j);
  manchester_class_walk<<<rows, kThreads, sizeof(Smem),
                      static_cast<cudaStream_t>(stream)>>>(
      bits, count, count_step, n, fin, out, n_out, fout, k, seg_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int manchester_chain_probe(int steps, void* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int manchester_compose_probe(int steps, void* out, void* stream) {
  compose_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
