// FasTrak decoder FSM: a chunk-parallel speculative walk, bit-equal to the
// serial scan.
//
// Replaces the per-sample lax.scan of FastrakDecoder.apply
// (grbaz_tpu/ops/misc.py:72, the scan at :196): threshold sync, sampled
// hard bits, the 12-bit sync word, a 16-bit type, a 32-bit ID, a CRC16
// check, and each passing frame's ID with its consecutive-repeat count
// summed into [32, 3] event rows. Rows of metric and sync [B, n] are
// independent streams (B = 1 for the block, a decoder bank's channels for
// B > 1).
//
// What bounds it: the bytes (metric and sync read once, 8 B a sample; the
// events and state are small). A serial walk is bound instead by its chain
// of dependent steps, one thread a row. This design takes that chain off
// the row, as csrc/peak_fsm.cu does for the peak detector:
//   * the FSM forgets. In SEARCH every frame field is dead until a sync
//     fire overwrites it, and a frame returns to SEARCH within 76 bits
//     (76 * oversampling samples). Which fields are live follows from the
//     state: in SEARCH crc_buf alone (0 whenever a frame ends, since every
//     frame ends on a byte boundary); from SYNC on also sub, bit_buf,
//     bit_ctr, crc and compute_crc (a fire writes them); from TYPE on
//     crc_bits (the sync word's check zeroes it); from DECODE on
//     payload_len; in CRC the ID. So the state at a sample is fixed by the
//     samples shortly before it, in all but rare data;
//   * the walk skips what changes nothing: in SEARCH every field holds
//     until the sync stream reaches the threshold, and inside a frame only
//     the sub-symbol counter moves between sampled bits. A step needs two
//     bits of a sample (sync >= threshold, metric >= 0), so a block first
//     stages its stretch of the rows, coalesced, as two ballot words per
//     32 samples in shared memory; a SEARCH walk then finds the next hit a
//     word at a time (__ffs) and a frame is walked bit by bit, every
//     iteration ending in one step, so that the threads of a warp step
//     together;
//   * pass 1 (speculate): one thread a chunk of `chunk` samples, 32 a
//     block of 512 threads that stage the chunks' bits. Chunk 0
//     walks from the carried state; every other chunk walks `warm` samples
//     before it from a guess (SEARCH, every field 0), keeps the state at
//     its start (its guess), walks the chunk and records its end state,
//     which fields its walk wrote or held live (a mask of four groups:
//     the fire's fields, crc_bits, payload_len, the ID), and its passing
//     frames: each ID with its count local to the chunk and whether it is
//     in the chunk's leading run of one ID;
//   * pass 2 (check, repair, carry): one warp a row walks the chunk
//     records in order, 32 at a time. A chunk is confirmed when its guess
//     agrees with the true state on the fields live in the guess's state:
//     equal live fields take the same decisions on the same samples. A
//     lane checks its guess against the recorded end of the chunk before
//     (the live fields of a confirmed chunk's end are true), and the first
//     lane that fails is the only one that needs the true state. The true
//     state is carried past the confirmed lanes: state and crc_buf from
//     the last one's end, each group of fields from the last lane whose
//     mask holds it, else kept. Then, over the confirmed lanes that passed
//     frames, in order and by shuffles, the carried last ID and count give
//     each chunk the count its leading run adds (its first ID is the
//     carried one) and its first frame's number. The failing chunk is
//     walked again from the true state by its lane, which records its
//     frames with their true counts, and the check resumes after it. The
//     final state, the dead fields included, is the serial walk's bit for
//     bit;
//   * pass 3 (apply): one thread a chunk writes its frames' rows: frames
//     0-30 to event rows of their own, the later ones, which the JAX block
//     sums into row 31 (.at[slot].add), in frame order to scratch;
//   * pass 4: one thread a row sums those into row 31 in frame order, the
//     scatter-add's order.
// The result is exact whatever chunk and warm are: a guess only decides
// how much is walked again.
//
// State in and out (int32 [12][B], uint32 fields as their bits): state,
// sub, bit_buf, bit_ctr, crc, crc_buf, crc_bits, compute_crc,
// payload_len, id, last_id, last_id_count. Events float [B][32][3],
// counts int [B]. Scratch (the wrapper allocates it, nothing is read
// before it is written): int [B*K][32] chunk records (K = ceil(n /
// chunk)), int [B*K][cap][3] passing frames (cap = chunk / 64 + 2: frames
// pass at least 76 samples apart), float [B*K*cap][3] the rows past the
// 31st, int [B] frames a row, int [B] chunks walked again.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spec_fsm.cuh"

namespace {

using namespace spec_fsm;

constexpr int kSearch = 0, kSync = 1, kType = 2, kDecode = 3, kCrc = 4;
constexpr uint32_t kSyncWord = 0xAAC;
constexpr uint32_t kPtId = 0x0001;
constexpr int kMaxEvents = 32;
constexpr int kRec = 32;     // ints a chunk record
constexpr int kThreads1 = 512;  // a pass-1 block: all stage its bits
constexpr int kWalkers = 32;    // chunks a pass-1 block, one a thread
constexpr int kThreads3 = 128;

// record layout: guess fields, end fields, then the summary
// pass 2 writes kAdd (the count the chunk's leading run adds) and kSlot
// (its first frame's number); a chunk walked again gets its frames, kInfo,
// kAdd = 0 and kSlot anew
enum { kGuess = 0, kEnd = 10, kInfo = 20, kFirst, kLeadAll, kLast, kLocal,
       kAdd, kSlot };

// the ten frame fields of the state rows
struct Fs {
  int st, sub;
  uint32_t bb;
  int bc, crc, cb, cbits, cc, plen;
  uint32_t id;
};

__device__ __forceinline__ int crc16_update(int crc, int byte) {
  int t = ((crc >> 8) ^ byte) & 0xFF;
  t ^= t >> 4;
  return ((crc << 8) ^ (t << 12) ^ (t << 5) ^ t) & 0xFFFF;
}

// the groups of fields a state holds live: the fire's fields (sub,
// bit_buf, bit_ctr, crc, compute_crc), crc_bits, payload_len, the ID
__device__ __forceinline__ int live_mask(int st) {
  return st == kSearch ? 0 : st == kSync ? 1 : st == kType ? 3
         : st == kDecode ? 7 : 15;
}

// one step of the JAX scan, in its order of updates; returns whether it
// emits (the ID is then s.id)
__device__ __forceinline__ bool step(Fs& s, bool bit, bool hit, int os) {
  const bool searching = s.st == kSearch;
  const bool fire = searching & hit;
  const bool sampling = !searching & (s.sub == 0);
  int sub = searching ? (fire ? 0 : s.sub)
                      : (sampling ? os - 1 : max(s.sub - 1, 0));
  const bool take = fire | sampling;
  int st = fire ? kSync : s.st;
  const uint32_t b = bit ? 1u : 0u;
  uint32_t bb = fire ? b : (take ? (s.bb << 1) | b : s.bb);
  int bc = fire ? 1 : (take ? wadd(s.bc, 1) : s.bc);
  if (fire) sub = os - 1;
  int cc = fire ? 0 : s.cc;
  const bool acc = take & (cc != 0);
  int cb = acc ? static_cast<int>((static_cast<unsigned>(s.cb) << 1) | b)
               : s.cb;
  int cbits = acc ? wadd(s.cbits, 1) : s.cbits;
  const bool byte_done = acc & (cbits % 8 == 0);
  const int crc = fire ? 0 : (byte_done ? crc16_update(s.crc, cb & 0xFF)
                                        : s.crc);
  if (byte_done) cb = 0;
  const bool sync_done = take & (st == kSync) & (bc == 12);
  const bool sync_ok = sync_done & (bb == kSyncWord);
  if (sync_done) st = sync_ok ? kType : kSearch;
  if (sync_ok) {
    cc = 1;
    cbits = 0;
  }
  const bool type_done = take & (st == kType) & (bc == 16) & !sync_done;
  const bool type_ok = type_done & (bb == kPtId);
  if (type_done) st = type_ok ? kDecode : kSearch;
  const int plen = type_ok ? 32 : s.plen;
  const bool dec_done =
      take & (st == kDecode) & (bc == plen) & !type_done & !sync_done;
  const uint32_t id = dec_done ? bb : s.id;
  if (dec_done) st = kCrc;
  const bool crc_done = take & (st == kCrc) & (bc == 16) & !dec_done &
                        !type_done & !sync_done;
  if (crc_done) st = kSearch;
  if (sync_done | type_done | dec_done | crc_done) {
    bb = 0;
    bc = 0;
  }
  s.st = st;
  s.sub = sub;
  s.bb = bb;
  s.bc = bc;
  s.crc = crc;
  s.cb = cb;
  s.cbits = cbits;
  s.cc = cc;
  s.plen = plen;
  s.id = id;
  return crc_done & (crc == 0);
}

// a stretch of one row as bits in shared memory, 32 samples a word: `hit`
// where the sync stream reaches the threshold, `sgn` where the metric is
// >= 0 (NaN sets neither, as the JAX compares give); word w of the stretch
// covers samples p0 + 32w .. p0 + 32w + 31 and sits at w + w / 32, so that
// walkers 32 words apart read distinct banks
struct Bits {
  const unsigned* hit;
  const unsigned* sgn;
  int p0;
};

__device__ __forceinline__ int word_at(int w) { return w + (w >> 5); }

// the stretch [p0, p1) of a row into bits, the block's threads together:
// each warp reads four words' 32 consecutive samples of both rows with
// all eight loads in flight, then keeps two ballots a word
__device__ __forceinline__ void stage_bits(unsigned* hit, unsigned* sgn,
                                           const float* __restrict__ m,
                                           const float* __restrict__ y,
                                           int n, float thr, int p0, int p1) {
  constexpr int kUnroll = 4;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int words = (p1 - p0 + 31) >> 5;
  for (int w0 = (threadIdx.x >> 5) * kUnroll; w0 < words;
       w0 += warps * kUnroll) {
    float vy[kUnroll], vm[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + 32 * (w0 + u) + lane;
      in[u] = p >= 0 && p < n && w0 + u < words;
      vy[u] = in[u] ? y[p] : 0.f;
      vm[u] = in[u] ? m[p] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned h = __ballot_sync(kAll, in[u] && vy[u] >= thr);
      const unsigned g = __ballot_sync(kAll, in[u] && vm[u] >= 0.f);
      if (lane == 0 && w0 + u < words) {
        hit[word_at(w0 + u)] = h;
        sgn[word_at(w0 + u)] = g;
      }
    }
  }
}

// walk samples [i, end) of the stretch from s, skipping the steps that
// change nothing: in SEARCH to the next set `hit` bit (a word of 32
// samples a look), inside a frame over the sub-symbol count (after a skip
// the next sample is a sampled bit). Every iteration ends in one step, so
// the threads of a warp that walk different chunks step together;
// `on_step(emitted)` runs after every step
template <typename OnStep>
__device__ __forceinline__ void walk(Fs& s, const Bits& b, int i, int end,
                                     int os, OnStep on_step) {
  while (i < end) {
    if (s.st == kSearch) {
      int w = (i - b.p0) >> 5;
      unsigned h = b.hit[word_at(w)] & (kAll << ((i - b.p0) & 31));
      while (!h) {
        ++w;
        if (b.p0 + 32 * w >= end) return;
        h = b.hit[word_at(w)];
      }
      i = b.p0 + 32 * w + __ffs(h) - 1;
      if (i >= end) return;
    } else if (s.sub > 0) {
      const int d = min(s.sub, end - i);
      s.sub -= d;
      i += d;
      if (i >= end) return;
    }
    const int t = i - b.p0;
    const unsigned bit = 1u << (t & 31);
    on_step(step(s, (b.sgn[word_at(t >> 5)] & bit) != 0,
                 (b.hit[word_at(t >> 5)] & bit) != 0, os));
    ++i;
  }
}

// shared words for `samples` samples of bits, both arrays
__host__ __device__ inline int bit_words(int samples) {
  const int w = (samples + 31) / 32 + 1;
  return w + w / 32 + 1;
}

__device__ __forceinline__ Fs load_state(const int* __restrict__ sin,
                                         int rows, int row) {
  Fs s;
  s.st = sin[0 * rows + row];
  s.sub = sin[1 * rows + row];
  s.bb = static_cast<uint32_t>(sin[2 * rows + row]);
  s.bc = sin[3 * rows + row];
  s.crc = sin[4 * rows + row];
  s.cb = sin[5 * rows + row];
  s.cbits = sin[6 * rows + row];
  s.cc = sin[7 * rows + row];
  s.plen = sin[8 * rows + row];
  s.id = static_cast<uint32_t>(sin[9 * rows + row]);
  return s;
}

__device__ __forceinline__ void put_fs(int* r, const Fs& s) {
  r[0] = s.st;
  r[1] = s.sub;
  r[2] = static_cast<int>(s.bb);
  r[3] = s.bc;
  r[4] = s.crc;
  r[5] = s.cb;
  r[6] = s.cbits;
  r[7] = s.cc;
  r[8] = s.plen;
  r[9] = static_cast<int>(s.id);
}

__device__ __forceinline__ Fs get_fs(const int* r) {
  Fs s;
  s.st = r[0];
  s.sub = r[1];
  s.bb = static_cast<uint32_t>(r[2]);
  s.bc = r[3];
  s.crc = r[4];
  s.cb = r[5];
  s.cbits = r[6];
  s.cc = r[7];
  s.plen = r[8];
  s.id = static_cast<uint32_t>(r[9]);
  return s;
}

struct Chunks {
  int chunk, warm, k;  // chunk and warm-up length, chunks per row
  int cap;             // passing frames a chunk can hold
  int* rec;            // [B*K][kRec]
  int* frames;         // [B*K][cap][3]: id, local count, leading run
};

__global__ void __launch_bounds__(kThreads1)
    speculate_kernel(const float* __restrict__ metric,
                     const float* __restrict__ sync, int n,
                     const float* __restrict__ thr,
                     const int* __restrict__ sin, int os, Chunks ch) {
  extern __shared__ unsigned bits[];
  const int rows = gridDim.y;
  const int row = blockIdx.y;
  const int k0 = blockIdx.x * kWalkers;
  const int k = k0 + threadIdx.x;
  const float* m = metric + static_cast<int64_t>(row) * n;
  const float* y = sync + static_cast<int64_t>(row) * n;
  const float t = thr[row];
  // the block's chunks and the warm-up before them, from a multiple of 32
  const int lo = k0 * ch.chunk - ch.warm;
  const int p0 = lo >= 0 ? lo & ~31 : -((-lo + 31) & ~31);
  const int p1 = min(n, (k0 + kWalkers) * ch.chunk);
  const int words = bit_words(kWalkers * ch.chunk + ch.warm);
  const Bits b{bits, bits + words, p0};
  stage_bits(bits, bits + words, m, y, n, t, p0, p1);
  __syncthreads();
  if (threadIdx.x >= kWalkers || k >= ch.k) return;
  const int c0 = k * ch.chunk;
  const int c1 = min(n, c0 + ch.chunk);
  Fs s;
  if (k == 0) {
    s = load_state(sin, rows, row);
  } else {
    s = Fs{kSearch, 0, 0u, 0, 0, 0, 0, 0, 0, 0u};
    walk(s, b, max(c0 - ch.warm, 0), c0, os, [](bool) {});
  }
  const int64_t kk = static_cast<int64_t>(row) * ch.k + k;
  int* r = ch.rec + kk * kRec;
  int* fr = ch.frames + kk * ch.cap * 3;
  put_fs(r + kGuess, s);
  int mask = live_mask(s.st);
  int ne = 0, local = 0;
  uint32_t first = 0u, last = 0u;
  bool lead = true;
  walk(s, b, c0, c1, os, [&](bool emitted) {
    mask |= live_mask(s.st);
    if (emitted) {
      if (ne == 0) {
        first = s.id;
        local = 1;
      } else {
        local = s.id == last ? wadd(local, 1) : 1;
        lead = lead & (s.id == first);
      }
      fr[3 * ne + 0] = static_cast<int>(s.id);
      fr[3 * ne + 1] = local;
      fr[3 * ne + 2] = lead ? 1 : 0;
      last = s.id;
      ++ne;
    }
  });
  put_fs(r + kEnd, s);
  r[kInfo] = mask | (ne << 4);
  r[kFirst] = static_cast<int>(first);
  r[kLeadAll] = lead ? 1 : 0;
  r[kLast] = static_cast<int>(last);
  r[kLocal] = local;
}

// a chunk record as a lane of pass 2 holds it
struct Rec {
  Fs g, e;
  int info;
  uint32_t first;
  int lead_all;
  uint32_t last;
  int local;
};

__device__ __forceinline__ Rec load_rec(const int* rec_row, int k) {
  const int* r = rec_row + static_cast<int64_t>(k) * kRec;
  Rec c;
  c.g = get_fs(r + kGuess);
  c.e = get_fs(r + kEnd);
  c.info = r[kInfo];
  c.first = static_cast<uint32_t>(r[kFirst]);
  c.lead_all = r[kLeadAll];
  c.last = static_cast<uint32_t>(r[kLast]);
  c.local = r[kLocal];
  return c;
}

// the check: the fields live in the guess's state are equal
__device__ __forceinline__ bool agrees(const Fs& g, const Fs& s) {
  bool eq = (g.st == s.st) & (g.cb == s.cb);
  if (g.st >= kSync)
    eq &= (g.sub == s.sub) & (g.bb == s.bb) & (g.bc == s.bc) &
          (g.crc == s.crc) & (g.cc == s.cc);
  if (g.st >= kType) eq &= g.cbits == s.cbits;
  if (g.st >= kDecode) eq &= g.plen == s.plen;
  if (g.st == kCrc) eq &= g.id == s.id;
  return eq;
}

__global__ void __launch_bounds__(32)
    chain_kernel(const float* __restrict__ metric,
                 const float* __restrict__ sync, int n,
                 const float* __restrict__ thr, const int* __restrict__ sin,
                 float* __restrict__ events, int* __restrict__ n_ev,
                 int* __restrict__ sout, int os, Chunks ch,
                 int* __restrict__ totals, int* __restrict__ repairs) {
  extern __shared__ unsigned buf[];  // a chunk walked again, as bits
  const int rows = gridDim.x;
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int C = ch.chunk, K = ch.k;
  const float* m = metric + static_cast<int64_t>(row) * n;
  const float* y = sync + static_cast<int64_t>(row) * n;
  float* ev = events + static_cast<int64_t>(row) * kMaxEvents * 3;
  const float t = thr[row];
  for (int j = lane; j < kMaxEvents * 3; j += 32) ev[j] = 0.f;
  // the true state, last ID, its count and the frames so far: the same in
  // every lane
  Fs S = load_state(sin, rows, row);
  uint32_t cid = static_cast<uint32_t>(sin[10 * rows + row]);
  int ccount = sin[11 * rows + row];
  int total = 0;
  int nrep = 0;
  int* rec_row = ch.rec + static_cast<int64_t>(row) * K * kRec;
  int* fr_row = ch.frames + static_cast<int64_t>(row) * K * ch.cap * 3;

  // the next window's records are in flight while one is checked
  Rec nxt = load_rec(rec_row, min(lane, K - 1));
  for (int w = 0; w < K; w += 32) {
    const int k = w + lane;
    const int nvalid = min(32, K - w);
    const bool valid = lane < nvalid;
    int* r = rec_row + static_cast<int64_t>(valid ? k : w) * kRec;
    const Rec cur = nxt;
    if (w + 32 < K) nxt = load_rec(rec_row, min(w + 32 + lane, K - 1));
    const Fs& g = cur.g;
    const Fs& e = cur.e;
    const int info = valid ? cur.info : 0;
    const int ne = info >> 4;
    const uint32_t first = cur.first;
    const int lead_all = cur.lead_all;
    const uint32_t last = cur.last;
    const int local = cur.local;
    const bool pred_ok = agrees(g, from_lane_below(e));
    for (int lo = 0; lo < nvalid;) {
      const bool ok = lane == lo ? (k == 0 || agrees(g, S)) : pred_ok;
      const unsigned fail = __ballot_sync(kAll, valid & (lane >= lo) & !ok);
      const int f = fail ? __ffs(fail) - 1 : nvalid;
      if (f > lo) {
        // carry the true state past the confirmed chunks lo..f-1
        const bool mine = (lane >= lo) & (lane < f);
        const Fs end = from_lane(e, f - 1);
        S.st = end.st;
        S.cb = end.cb;
        for (int grp = 0; grp < 4; ++grp) {
          const unsigned has = __ballot_sync(kAll, mine & ((info >> grp) & 1));
          const Fs h = from_lane(e, has ? top_lane(has) : 0);
          if (!has) continue;
          if (grp == 0) {
            S.sub = h.sub;
            S.bb = h.bb;
            S.bc = h.bc;
            S.crc = h.crc;
            S.cc = h.cc;
          } else if (grp == 1) {
            S.cbits = h.cbits;
          } else if (grp == 2) {
            S.plen = h.plen;
          } else {
            S.id = h.id;
          }
        }
        // their passing frames in order: the count a leading run adds,
        // the first frame's number, and the carried last ID and count
        int my_add = 0, my_slot = 0;
        for (unsigned b = __ballot_sync(kAll, mine & (ne > 0)); b;
             b &= b - 1) {
          const int j = __ffs(b) - 1;
          const int ne_j = from_lane(ne, j);
          const uint32_t first_j = from_lane(first, j);
          const int lead_j = from_lane(lead_all, j);
          const uint32_t last_j = from_lane(last, j);
          const int local_j = from_lane(local, j);
          const int add = first_j == cid ? ccount : 0;
          if (lane == j) {
            my_add = add;
            my_slot = total;
          }
          ccount = lead_j ? wadd(local_j, add) : local_j;
          cid = last_j;
          total = wadd(total, ne_j);
        }
        if (mine) {
          r[kAdd] = my_add;
          r[kSlot] = my_slot;
        }
      }
      if (f < nvalid) {
        // a miss: walk chunk w+f again from the true state; its frames,
        // with their true counts, replace the chunk's for pass 3
        const int c0 = (w + f) * C;
        const int c1 = min(n, c0 + C);
        const int words = bit_words(C);
        __syncwarp();
        stage_bits(buf, buf + words, m, y, n, t, c0, c1);
        __syncwarp();
        if (lane == f) {
          int* fr = fr_row + static_cast<int64_t>(w + f) * ch.cap * 3;
          int q = 0;
          const Bits bb{buf, buf + words, c0};
          walk(S, bb, c0, c1, os, [&](bool emitted) {
            if (emitted) {
              ccount = S.id == cid ? wadd(ccount, 1) : 1;
              cid = S.id;
              fr[3 * q + 0] = static_cast<int>(S.id);
              fr[3 * q + 1] = ccount;
              fr[3 * q + 2] = 0;
              ++q;
            }
          });
          r[kInfo] = q << 4;
          r[kAdd] = 0;
          r[kSlot] = total;
          total = wadd(total, q);
        }
        S = from_lane(S, f);
        cid = from_lane(cid, f);
        ccount = from_lane(ccount, f);
        total = from_lane(total, f);
        ++nrep;
        lo = f + 1;
      } else {
        lo = nvalid;
      }
    }
  }
  if (lane == 0) {
    int* o = sout + row;
    o[0 * rows] = S.st;
    o[1 * rows] = S.sub;
    o[2 * rows] = static_cast<int>(S.bb);
    o[3 * rows] = S.bc;
    o[4 * rows] = S.crc;
    o[5 * rows] = S.cb;
    o[6 * rows] = S.cbits;
    o[7 * rows] = S.cc;
    o[8 * rows] = S.plen;
    o[9 * rows] = static_cast<int>(S.id);
    o[10 * rows] = static_cast<int>(cid);
    o[11 * rows] = ccount;
    n_ev[row] = min(total, kMaxEvents);
    totals[row] = total;
    repairs[row] = nrep;
  }
}

// one passing frame's event row
__device__ __forceinline__ float3 event_row(uint32_t id, int count) {
  return make_float3(static_cast<float>(id >> 16),
                     static_cast<float>(id & 0xFFFFu), __int2float_rn(count));
}

// pass 3: the chunks' frames into the event rows, one thread a chunk.
// Frames 0-30 each have a row of their own (0 + v is v, as the JAX
// scatter-add gives); the later ones, which the JAX block sums into row
// 31, go to `late` in frame order for pass 4
__global__ void __launch_bounds__(kThreads3)
    apply_kernel(float* __restrict__ events, Chunks ch,
                 float* __restrict__ late) {
  const int row = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= ch.k) return;
  const int* r = ch.rec + (static_cast<int64_t>(row) * ch.k + k) * kRec;
  const int ne = r[kInfo] >> 4;
  if (ne == 0) return;
  const int* fr = ch.frames + (static_cast<int64_t>(row) * ch.k + k) *
                                  ch.cap * 3;
  float* ev = events + static_cast<int64_t>(row) * kMaxEvents * 3;
  float* lt = late + static_cast<int64_t>(row) * ch.k * ch.cap * 3;
  const int add = r[kAdd], slot0 = r[kSlot];
  for (int j = 0; j < ne; ++j) {
    const int local = fr[3 * j + 1];
    const float3 v = event_row(static_cast<uint32_t>(fr[3 * j]),
                               fr[3 * j + 2] ? wadd(local, add) : local);
    const int slot = slot0 + j;
    float* dst = slot < kMaxEvents - 1
                     ? ev + 3 * slot
                     : lt + 3 * static_cast<int64_t>(slot - (kMaxEvents - 1));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
  }
}

// pass 4: row 31, the frames from the 32nd on summed in frame order, one
// thread a row (nothing to do where 31 frames or fewer passed)
__global__ void last_row_kernel(float* __restrict__ events,
                                const int* __restrict__ totals, Chunks ch,
                                const float* __restrict__ late, int rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int extra = totals[row] - (kMaxEvents - 1);
  if (extra <= 0) return;
  const float* lt = late + static_cast<int64_t>(row) * ch.k * ch.cap * 3;
  float a = 0.f, b = 0.f, c = 0.f;
  for (int q = 0; q < extra; ++q) {
    a = __fadd_rn(a, lt[3 * q]);
    b = __fadd_rn(b, lt[3 * q + 1]);
    c = __fadd_rn(c, lt[3 * q + 2]);
  }
  float* ev = events + static_cast<int64_t>(row) * kMaxEvents * 3 +
              3 * (kMaxEvents - 1);
  ev[0] = a;
  ev[1] = b;
  ev[2] = c;
}

}  // namespace

extern "C" int fastrak_fsm(const float* metric, const float* sync, int n,
                           int rows, const float* thr, const int* sin,
                           float* events, int* n_ev, int* sout, int os,
                           int chunk, int warm, int* rec, int* frames,
                           float* late, int* totals, int* repairs,
                           void* stream) {
  // chunks of whole bit words; a pass-1 block's bits within 227 KB
  if (n < 1 || rows < 1 || os < 1 || chunk < 32 || chunk % 32 ||
      chunk > (1 << 16) || warm < 0 || warm > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Chunks ch;
  ch.chunk = chunk;
  ch.warm = warm;
  ch.k = (n + chunk - 1) / chunk;
  ch.cap = chunk / 64 + 2;
  ch.rec = rec;
  ch.frames = frames;
  const size_t smem1 = 2 * sizeof(unsigned) *
                       bit_words(kWalkers * chunk + warm);
  const cudaError_t e = fit_smem(speculate_kernel, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid1((ch.k + kWalkers - 1) / kWalkers, rows);
  const size_t smem2 = 2 * sizeof(unsigned) * bit_words(chunk);
  const dim3 grid3((ch.k + kThreads3 - 1) / kThreads3, rows);
  return launch_passes(
      [&] {
        speculate_kernel<<<grid1, kThreads1, smem1, s>>>(metric, sync, n, thr,
                                                         sin, os, ch);
      },
      [&] {
        chain_kernel<<<rows, 32, smem2, s>>>(metric, sync, n, thr, sin,
                                             events, n_ev, sout, os, ch,
                                             totals, repairs);
      },
      [&] { apply_kernel<<<grid3, kThreads3, 0, s>>>(events, ch, late); },
      [&] {
        last_row_kernel<<<(rows + 127) / 128, 128, 0, s>>>(events, totals,
                                                           ch, late, rows);
      });
}
