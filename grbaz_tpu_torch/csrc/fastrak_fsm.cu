// FasTrak decoder FSM: a chain of candidate frames, bit-equal to the serial
// scan.
//
// Replaces the per-sample lax.scan of FastrakDecoder.apply
// (grbaz_tpu/ops/misc.py:72, the scan at :196): threshold sync, sampled
// hard bits, the 12-bit sync word, a 16-bit type, a 32-bit ID, a CRC16
// check, and each passing frame's ID with its consecutive-repeat count
// summed into [32, 3] event rows. Rows of metric and sync [B, n] are
// independent streams (B = 1 for the block, a decoder bank's channels for
// B > 1).
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 3.35 TB/s): the bytes,
// metric and sync read once, 8 B a sample: 2.5 us at [1, 2^20]. The
// speculative form this file held before (a 1024-sample chunk a thread,
// each but a row's first walked from a SEARCH guess after a 1280-sample
// warm-up, checked, repaired and carried by one warp a row) took 0.1528 ms
// there: pass 1 walked 2.25x the input serially on 32 of the 132 SMs
// (52.6 us), pass 2 carried 1024 chunk records in 32 dependent windows
// (48.2 us), passes 3-4 and the gaps the rest; with the sync held above
// the threshold nearly every guess missed and it took 31.96 ms.
//
// This form guesses nothing. It rests on what a frame is in the JAX step:
//   * a fire happens only in SEARCH, at a sample p where sync >= threshold
//     (a hit), and the frame then samples its bits at p + k * os;
//   * its length L is 12 bits where the sync word fails, 28 where the type
//     fails, 76 otherwise, and it returns to SEARCH on the step of its last
//     bit, e(p) = p + (L - 1) * os;
//   * everything it computes (L, the CRC, the ID, which fields it writes
//     and their values) follows from the metric's signs at those L samples
//     alone: the fire resets sub, bit_buf, bit_ctr, crc and compute_crc;
//     crc_buf and crc_bits are rewritten from the sync word's check on
//     (crc_buf is 0 after a frame whose sync word passed: every such frame
//     ends on a byte boundary), payload_len and the ID from the type's;
//   * the next frame fires at the first hit at or after e(p) + 1.
// So the serial walk is a chain of fires through the row's hits: every hit
// can work out its own frame in parallel, and only the chain, one link a
// frame, is serial. Two launches:
//   * pass 1 (candidates): a block a tile of `tile` samples of a row, on
//     every SM. It stages the sync hits and the metric's signs over the
//     tile and the longest frame after it (75 * os samples) as ballot
//     bit-words in shared memory (16-byte loads where the rows allow),
//     writes the tile's hit words and each word's hits before it in the
//     tile, lists the tile's hits in position order (a block scan of the
//     words' hit counts) and shares them out over its threads, which work
//     out the frame a fire there walks (its length code: 12, 28 or 76
//     bits, or open at the row's end; its CRC and ID) and where it hands
//     on to: the first hit after its end, as its tile and the hits of that
//     tile before it, counted in the staged hits. Written in position
//     order with the tile's count;
//   * pass 2 (chain): a block a row. It prefixes the tile counts, walks a
//     frame carried in from the previous call to its end (the block loads
//     the bits a batch at a time, one thread steps), then chases the chain
//     through windows of candidates in shared memory, each with its
//     successor's index: one thread follows the links (the next link's
//     loads in flight while it takes one), numbering the passing frames
//     with their repeat counts carried in frame order, rows 0-30 written
//     directly and the later ones summed into row 31 in frame order (the
//     JAX block's .at[slot].add), then writes the field groups of the last
//     frame that wrote each (the fire's group, crc_buf and crc_bits where
//     the sync word passed, payload_len and the ID where the type passed),
//     while warps 1 on load the next window. A frame still open at the
//     row's end is walked like the carried one.
// No sample is walked twice; the serial part is one link a frame. The
// final state is the serial walk's bit for bit, the dead fields included.
//
// State in and out: twelve [B] arrays (state, sub, bit_buf, bit_ctr, crc,
// crc_buf, crc_bits, compute_crc, payload_len, id, last_id,
// last_id_count), each bool, int32 or int64 (a uint32 field's value), read
// and written where they lie. Threshold [B] or one for all rows. Events
// float [B][32][3], counts int [B]. Scratch (the wrapper allocates it,
// nothing is read before it is written): uint [B][K * tile / 32] hit words
// and int [B][K * tile / 32] hits before each word in its tile (K = ceil(n
// / tile)), int [B][K] hits a tile, int [B][K + 1] their prefix (used
// where it does not fit in shared memory), uint2 [B][K][tile] the
// candidates and int [B][K][tile] their successors, int [2][B] the
// candidates and the chain's frames a row.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kSearch = 0, kSync = 1, kType = 2, kDecode = 3, kCrc = 4;
constexpr uint32_t kSyncWord = 0xAAC;
constexpr uint32_t kPtId = 0x0001;
constexpr int kMaxEvents = 32;
// a candidate's length code: 0, 1, 2 for 12, 28, 76 bits, or open at the
// row's end
constexpr int kOpen = 3;
// a candidate's successor past the row's end, or to be ranked in pass 2
constexpr int kNextEnd = -1, kNextRank = -2;
constexpr int kMaxLen = 76;

constexpr int kThreads1 = 512;
constexpr int kUnroll = 8;            // 128-sample groups a warp has in flight
constexpr int kMaxTile = 1 << 14;     // a candidate's offset in 14 bits
constexpr int kMaxStage = 1 << 17;    // samples of signs a block stages (16 KB)
constexpr int kThreads2 = 512;
constexpr int kWindow = 2048;         // candidates a window of the chase
// a window's candidates a thread loads: all threads, or warps 1 on
constexpr int kPerAll = kWindow / kThreads2;
constexpr int kPerLoader = (kWindow + kThreads2 - 33) / (kThreads2 - 32);
constexpr int kTpCap = 4096;          // tile prefixes kept in shared memory

// int32 addition that wraps, as the JAX package's does
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int frame_len(int code) {
  return code == 0 ? 12 : code == 1 ? 28 : kMaxLen;
}

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

struct Geo {
  int n, os, tile, k;  // samples a row, samples a bit, a tile, tiles a row
  int stage;           // samples of signs a pass-1 block stages
  int thr_step;        // 1: a threshold a row; 0: one for all rows
};

// the state's twelve fields, a [B] array each: pointers and element bytes
// (1 a bool, 4 an int32, 8 an int64: uint32 fields as their value)
struct Fields {
  void* p[12];
  int bytes[12];

  __device__ __forceinline__ int get(int f, int row) const {
    const void* q = p[f];
    return bytes[f] == 8   ? static_cast<int>(
                                 static_cast<const int64_t*>(q)[row])
           : bytes[f] == 4 ? static_cast<const int*>(q)[row]
                           : static_cast<const uint8_t*>(q)[row];
  }

  __device__ __forceinline__ void put(int f, int row, int v) const {
    if (bytes[f] == 8)
      static_cast<int64_t*>(p[f])[row] = static_cast<uint32_t>(v);
    else if (bytes[f] == 4)
      static_cast<int*>(p[f])[row] = v;
    else
      static_cast<uint8_t*>(p[f])[row] = v != 0;
  }
};

struct Scratch {
  unsigned* hw;  // [B][K * tile / 32] hit words
  int* wpre;     // [B][K * tile / 32] hits before the word in its tile
  int* cnt;      // [B][K] hits a tile
  int* tp;       // [B][K + 1] hits before each tile (where K + 1 > kTpCap)
  uint2* cand;   // [B][K][tile] candidates: the ID, then the CRC | code <<
                 // 16 | the offset in the tile << 18
  int* next;     // [B][K][tile] each one's successor, as next_of gives it
  int* stats;    // [2][B] candidates, the chain's frames
};

// ---------------------------------------------------------------------------
// pass 1: the candidates of a tile
// ---------------------------------------------------------------------------

// a stretch [lo, hi) of one row into bits where x >= t, 32 samples a word,
// out[w] for samples lo + 32w ..; lo a multiple of 128
struct Run {
  const float* x;
  float t;
  int lo, hi;
  unsigned* out;
};

// two runs (the tile's sync hits and the metric's signs) into bits, the
// block's warps together: a warp and unit is a group of 128 samples, the
// units of both runs interleaved so that a warp has kUnroll groups' loads
// in flight. With kVec a lane reads 16 bytes, 4 consecutive samples, and
// the 8 lanes of a word gather its nibbles with shuffles; else a lane
// reads a sample of each of 4 words and a ballot makes each word. Samples
// at or past `hi` read as NaN, which sets no bit
template <bool kVec>
__device__ __forceinline__ void stage_runs(const Run& a, int ga, const Run& b,
                                           int gb) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int units = ga + gb;
  const float nan = __int_as_float(0x7fc00000);
  for (int u0 = (threadIdx.x >> 5) * kUnroll; u0 < units;
       u0 += warps * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 + j;
      const Run& r = u < ga ? a : b;
      const int g = u < ga ? u : u - ga;
      const int64_t p0 = static_cast<int64_t>(r.lo) + 128 * g;
      if (kVec) {
        const int64_t p = p0 + 4 * lane;
        v[j] = u < units && p < r.hi
                   ? *reinterpret_cast<const float4*>(r.x + p)
                   : make_float4(nan, nan, nan, nan);
      } else {
        const int64_t p = p0 + lane;
        const bool in = u < units;
        v[j].x = in && p < r.hi ? r.x[p] : nan;
        v[j].y = in && p + 32 < r.hi ? r.x[p + 32] : nan;
        v[j].z = in && p + 64 < r.hi ? r.x[p + 64] : nan;
        v[j].w = in && p + 96 < r.hi ? r.x[p + 96] : nan;
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 + j;
      if (u >= units) break;  // the same in every lane
      const Run& r = u < ga ? a : b;
      const int g = u < ga ? u : u - ga;
      if (kVec) {
        unsigned w = ((v[j].x >= r.t ? 1u : 0u) | (v[j].y >= r.t ? 2u : 0u) |
                      (v[j].z >= r.t ? 4u : 0u) | (v[j].w >= r.t ? 8u : 0u))
                     << (4 * (lane & 7));
        w |= __shfl_xor_sync(kAll, w, 1);
        w |= __shfl_xor_sync(kAll, w, 2);
        w |= __shfl_xor_sync(kAll, w, 4);
        if ((lane & 7) == 0) r.out[4 * g + (lane >> 3)] = w;
      } else {
        const unsigned w0 = __ballot_sync(kAll, v[j].x >= r.t);
        const unsigned w1 = __ballot_sync(kAll, v[j].y >= r.t);
        const unsigned w2 = __ballot_sync(kAll, v[j].z >= r.t);
        const unsigned w3 = __ballot_sync(kAll, v[j].w >= r.t);
        if (lane == 0) {
          r.out[4 * g] = w0;
          r.out[4 * g + 1] = w1;
          r.out[4 * g + 2] = w2;
          r.out[4 * g + 3] = w3;
        }
      }
    }
  }
}

// the frame a fire at p walks, from the metric's signs at p + k * os:
// signs of [t0, s1) from the staged words, later ones from the row
struct Signs {
  const unsigned* words;
  const float* m;
  int t0, s1, n, os;

  __device__ __forceinline__ uint32_t at(int64_t q) const {
    if (q < s1) {
      const int r = static_cast<int>(q - t0);
      return (words[r >> 5] >> (r & 31)) & 1u;
    }
    return m[q] >= 0.f ? 1u : 0u;
  }

  // bits k0 .. k0 + kCount - 1 of the frame at p onto v; false where one
  // lies past the row's end. Where all are staged their loads go out
  // together
  template <int kCount>
  __device__ __forceinline__ bool take(int64_t p, int k0, uint32_t& v) const {
    const int64_t last = p + static_cast<int64_t>(k0 + kCount - 1) * os;
    if (last >= n) return false;
    if (last < s1) {
      const int r0 = static_cast<int>(p - t0) + k0 * os;
      uint32_t b[kCount];
#pragma unroll
      for (int k = 0; k < kCount; ++k) {
        const int r = r0 + k * os;
        b[k] = (words[r >> 5] >> (r & 31)) & 1u;
      }
#pragma unroll
      for (int k = 0; k < kCount; ++k) v = (v << 1) | b[k];
    } else {
      for (int k = k0; k < k0 + kCount; ++k)
        v = (v << 1) | at(p + static_cast<int64_t>(k) * os);
    }
    return true;
  }
};

// the candidate record of a fire at p (offset `off` in its tile)
__device__ __forceinline__ uint2 frame_at(const Signs& sg, int64_t p,
                                          int off) {
  uint32_t w = 0, ty = 0, id = 0, cw = 0;
  int crc = 0, code = kOpen;
  if (sg.take<12>(p, 0, w)) {
    if (w != kSyncWord) {
      code = 0;
    } else if (sg.take<16>(p, 12, ty)) {
      crc = crc16_update(crc16_update(0, ty >> 8), ty & 0xFF);
      if (ty != kPtId) {
        code = 1;
      } else if (sg.take<32>(p, 28, id) && sg.take<16>(p, 60, cw)) {
        for (int s = 24; s >= 0; s -= 8)
          crc = crc16_update(crc, (id >> s) & 0xFF);
        crc = crc16_update(crc16_update(crc, cw >> 8), cw & 0xFF);
        code = 2;
      }
    }
  }
  return make_uint2(id, static_cast<unsigned>(crc) |
                            static_cast<unsigned>(code) << 16 |
                            static_cast<unsigned>(off) << 18);
}

// where the frame of a candidate with record word `cw` at p hands on to:
// the first hit after its end as (its tile - this tile) << 16 | the hits
// of its tile before it, from the staged hits (`pre`: the staged words'
// hits before each); kNextEnd past the row's end; kNextRank where the end
// lies past the staged samples (pass 2 ranks it from the hit words)
__device__ __forceinline__ int next_of(unsigned cw, int64_t p, int tile,
                                       int t0, int s1, const Geo& g,
                                       const unsigned* hit, const int* pre) {
  const int code = (cw >> 16) & 3;
  if (code == kOpen) return kNextEnd;  // not read: an open frame has none
  const int64_t q = p + static_cast<int64_t>(frame_len(code) - 1) * g.os + 1;
  if (q >= g.n) return kNextEnd;
  if (q >= s1) return kNextRank;
  const int r = static_cast<int>(q - t0);
  const int tq = static_cast<int>(q / g.tile);
  const int tw = g.tile / 32;
  return (tq - tile) << 16 |
         (pre[r >> 5] - pre[(tq - tile) * tw] +
          __popc(hit[r >> 5] & ((1u << (r & 31)) - 1u)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads1)
    candidates_kernel(const float* __restrict__ metric,
                      const float* __restrict__ sync,
                      const float* __restrict__ thr, Geo g, Scratch sc) {
  // the staged samples' signs and hits as bit words, the hits before each
  // word, the tile's hits' offsets in position order
  extern __shared__ unsigned bits[];
  __shared__ int scan[33];
  const int row = blockIdx.y, tile = blockIdx.x;
  const int64_t rbase = static_cast<int64_t>(row) * g.n;
  const float* m = metric + rbase;
  const int t0 = tile * g.tile;
  const int s1 = static_cast<int>(
      min(static_cast<int64_t>(g.n), static_cast<int64_t>(t0) + g.stage));
  const int tw = g.tile / 32;
  const int sg_words = g.stage / 32;
  unsigned* hit = bits + sg_words;
  int* pre = reinterpret_cast<int*>(hit + sg_words);
  uint16_t* offs = reinterpret_cast<uint16_t*>(pre + sg_words + 1);
  // the tile's words and those of the staged samples after it
  const int units = max(tw / 4, (s1 - t0 + 127) / 128);
  const int words = 4 * units;
  stage_runs<kVec>(Run{sync + rbase, thr[row * g.thr_step], t0, s1, hit},
                   units, Run{m, 0.f, t0, s1, bits}, (s1 - t0 + 127) / 128);
  __syncthreads();
  // each thread a run of words in order: their hits' places by a block scan
  const int wpt = (words + kThreads1 - 1) / kThreads1;
  const int w0 = min(words, static_cast<int>(threadIdx.x) * wpt);
  const int w1 = min(words, w0 + wpt);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(hit[w]);
  int staged;
  int at = bscan::exclusive_sum(mine, scan, kThreads1, staged);
  for (int w = w0; w < w1; ++w) {
    pre[w] = at;
    at += __popc(hit[w]);
  }
  if (threadIdx.x == 0) pre[words] = staged;
  __syncthreads();
  const int total = pre[tw];  // the tile's hits
  const int64_t wrow = (static_cast<int64_t>(row) * g.k + tile) * tw;
  const int64_t crow = (static_cast<int64_t>(row) * g.k + tile) * g.tile;
  // the hits' offsets in position order, so that the block shares out
  // their frames evenly however the hits cluster (a sync correlation
  // crosses the threshold on runs of samples)
  for (int w = threadIdx.x; w < tw; w += kThreads1) {
    sc.hw[wrow + w] = hit[w];
    sc.wpre[wrow + w] = pre[w];
    int j = pre[w];
    for (unsigned h = hit[w]; h; h &= h - 1)
      offs[j++] = static_cast<uint16_t>(32 * w + __ffs(h) - 1);
  }
  __syncthreads();
  const Signs sg{bits, m, t0, s1, g.n, g.os};
  for (int j = threadIdx.x; j < total; j += kThreads1) {
    const int64_t p = static_cast<int64_t>(t0) + offs[j];
    const uint2 r = frame_at(sg, p, offs[j]);
    sc.cand[crow + j] = r;
    sc.next[crow + j] = next_of(r.y, p, tile, t0, s1, g, hit, pre);
  }
  if (threadIdx.x == 0)
    sc.cnt[static_cast<int64_t>(row) * g.k + tile] = total;
}

// ---------------------------------------------------------------------------
// pass 2: the chain of a row
// ---------------------------------------------------------------------------

// the walk of a row, in shared memory: thread 0 writes it, the block reads
// it after a barrier
struct Walk {
  Fs s;
  uint32_t cid;    // last_id
  int ccount;      // last_id_count
  int emitted;     // passing frames so far
  float r31[3];    // row 31: frames 31 on, summed in frame order
  int64_t i;       // the next sample of a frame walk
  int fire;        // the frame walk starts with a fire at i
  int done;        // the frame walk reached SEARCH
  int cur;         // the chase's next candidate
  int open;        // a chain frame open at the row's end fires here (or -1)
  int frames;      // the chain's frames
};

// a passing frame's event, in frame order (thread 0)
__device__ __forceinline__ void emit(Walk& c, uint32_t id, float* ev) {
  c.ccount = id == c.cid ? wadd(c.ccount, 1) : 1;
  c.cid = id;
  const float v[3] = {static_cast<float>(id >> 16),
                      static_cast<float>(id & 0xFFFFu),
                      __int2float_rn(c.ccount)};
  if (c.emitted < kMaxEvents - 1) {
    for (int j = 0; j < 3; ++j) ev[3 * c.emitted + j] = v[j];
  } else {
    for (int j = 0; j < 3; ++j) c.r31[j] = __fadd_rn(c.r31[j], v[j]);
  }
  ++c.emitted;
}

// walk the frame in c.s from sample c.i (with a fire there if c.fire) to
// the step that returns it to SEARCH, or to the row's end: the block loads
// the signs of the next kThreads2 sampled bits, thread 0 steps them. Every
// thread of the block calls it; after it, c.i is the sample after the
// frame's last step (or the row's end) and c.s the state there
__device__ void walk_frame(Walk& c, const float* __restrict__ m, int n,
                           int os, unsigned* bw, float* ev) {
  for (;;) {
    if (threadIdx.x == 0) {
      int64_t i = c.i;
      if (!c.fire) {
        // only sub moves until the next sampled bit
        if (i < n && c.s.sub < 0) {
          c.s.sub = 0;
          ++i;
        }
        if (c.s.sub > 0) {
          const int64_t d = min(static_cast<int64_t>(c.s.sub), n - i);
          c.s.sub -= static_cast<int>(d);
          i += d;
        }
      }
      c.i = i;
      c.done = 0;
    }
    __syncthreads();
    const int64_t first = c.i;
    if (first >= n) break;
    const int64_t q = first + static_cast<int64_t>(threadIdx.x) * os;
    const unsigned word = __ballot_sync(kAll, q < n && m[q] >= 0.f);
    if ((threadIdx.x & 31) == 0) bw[threadIdx.x >> 5] = word;
    __syncthreads();
    if (threadIdx.x == 0) {
      Walk w = c;  // in registers while it steps
      int64_t last = first;
      for (int k = 0; k < kThreads2; ++k) {
        const int64_t qk = first + static_cast<int64_t>(k) * os;
        if (qk >= n) break;
        // between two sampled bits only sub moves, from os - 1 to 0
        if (k > 0) w.s.sub = 0;
        if (step(w.s, (bw[k >> 5] >> (k & 31)) & 1u, w.fire != 0, os))
          emit(w, w.s.id, ev);
        w.fire = 0;
        last = qk;
        if (w.s.st == kSearch) {
          w.done = 1;
          break;
        }
      }
      w.i = last + 1;
      c = w;
    }
    __syncthreads();
    if (c.done) break;
  }
}

// a window of the chain's candidates in shared memory: each one's ID, its
// record's second word (CRC | code << 16 | offset << 18) and its successor
// (the first candidate after its frame's end, `total` if none; where its
// frame is open at the row's end, the sample it fires at)
struct Window {
  unsigned* id;
  unsigned* cw;
  int* nx;
};

// window b (0 or 1) after the tiles' prefix in the block's dynamic shared
// memory; its pointers come from the shared array itself, so that the
// compiler keeps shared-memory loads and stores
__device__ __forceinline__ Window window_at(unsigned* buf, int b) {
  unsigned* w = buf + kTpCap + 3 * kWindow * b;
  return {w, w + kWindow, reinterpret_cast<int*>(w + 2 * kWindow)};
}

// the tile of candidate i: the last tile whose prefix is <= i
__device__ __forceinline__ int tile_of(const int* tp, int k, int i) {
  int lo = 0, hi = k - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tp[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// candidates base .. base + span - 1 of the row into `win`, by threads t,
// t + nt, ..: kPer of them a step, their records and successors' loads in
// flight together; a successor pass 1 could not rank (its frame ends past
// the staged samples) is ranked from the hit words
template <int kPer>
__device__ __forceinline__ void load_window(const Scratch& sc, const int* tp,
                                            const Geo& g, int row, int total,
                                            const Window& win, int base,
                                            int span, int t, int nt) {
  for (int j0 = t; j0 < span; j0 += nt * kPer) {
    uint2 r[kPer];
    int nr[kPer], ti[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = j0 + u * nt;
      r[u] = make_uint2(0u, static_cast<unsigned>(kOpen) << 16);
      nr[u] = kNextEnd;
      ti[u] = 0;
      if (j < span) {
        const int i = base + j;
        ti[u] = tile_of(tp, g.k, i);
        const int64_t at = (static_cast<int64_t>(row) * g.k + ti[u]) * g.tile +
                           (i - tp[ti[u]]);
        r[u] = sc.cand[at];
        nr[u] = sc.next[at];
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = j0 + u * nt;
      if (j >= span) continue;
      const int code = (r[u].y >> 16) & 3;
      const int64_t p = static_cast<int64_t>(ti[u]) * g.tile + (r[u].y >> 18);
      int nx;
      if (code == kOpen) {
        nx = static_cast<int>(p);  // where it fires
      } else if (nr[u] == kNextEnd) {
        nx = total;
      } else if (nr[u] == kNextRank) {
        // the hits before q: its tile's, its word's, then the bits
        const int64_t q = p + static_cast<int64_t>(frame_len(code) - 1) *
                                  g.os + 1;
        const int64_t w =
            static_cast<int64_t>(row) * g.k * (g.tile / 32) + (q >> 5);
        nx = tp[q / g.tile] + sc.wpre[w] +
             __popc(sc.hw[w] & ((1u << (q & 31)) - 1u));
      } else {
        nx = tp[ti[u] + (nr[u] >> 16)] + (nr[u] & 0xFFFF);
      }
      win.id[j] = r[u].x;
      win.cw[j] = r[u].y;
      win.nx[j] = nx;
    }
  }
}

// follow the chain through a window from candidate c.cur (thread 0, what
// the links change in registers): each frame numbered, the passing ones
// emitted in order; then the field groups of the last frame that wrote
// each: the fire's group (the last frame), crc_buf and crc_bits (the last
// whose sync word passed), payload_len and the ID (the last whose type
// passed). Stops at a frame open at the row's end (c.open) or a successor
// past the window; c.cur is the next candidate (`total` at the end)
__device__ __forceinline__ void chase(Walk& c, const Window& win, int base,
                                      int span, int total, int os,
                                      float* ev) {
  uint32_t cid = c.cid;
  int ccount = c.ccount, emitted = c.emitted, frames = c.frames;
  float r0 = c.r31[0], r1 = c.r31[1], r2 = c.r31[2];
  int j = c.cur - base, last = -1, g1 = -1, g2 = -1, cur = total;
  unsigned cw = win.cw[j], id = win.id[j];
  int nx = win.nx[j];
  for (;;) {
    const int code = (cw >> 16) & 3;
    // the next link's loads in flight while this one is taken (an open
    // frame's nx is the sample it fires at, and it has no next)
    const int jn = nx - base;
    const bool on = code != kOpen && jn < span;
    unsigned cw_n = 0u, id_n = 0u;
    int nx_n = 0;
    if (on) {
      cw_n = win.cw[jn];
      id_n = win.id[jn];
      nx_n = win.nx[jn];
    }
    ++frames;
    if (code == kOpen) {
      c.open = nx;
      break;
    }
    last = j;
    if (code > 0) {
      g1 = j;
      if (code == 2) {
        g2 = j;
        if ((cw & 0xFFFFu) == 0) {  // a passing frame: its event
          ccount = id == cid ? wadd(ccount, 1) : 1;
          cid = id;
          const float hi = static_cast<float>(id >> 16);
          const float lo = static_cast<float>(id & 0xFFFFu);
          const float n = __int2float_rn(ccount);
          if (emitted < kMaxEvents - 1) {
            ev[3 * emitted] = hi;
            ev[3 * emitted + 1] = lo;
            ev[3 * emitted + 2] = n;
          } else {
            r0 = __fadd_rn(r0, hi);
            r1 = __fadd_rn(r1, lo);
            r2 = __fadd_rn(r2, n);
          }
          ++emitted;
        }
      }
    }
    if (!on) {
      cur = nx;
      break;
    }
    j = jn;
    cw = cw_n;
    id = id_n;
    nx = nx_n;
  }
  c.cid = cid;
  c.ccount = ccount;
  c.emitted = emitted;
  c.frames = frames;
  c.r31[0] = r0;
  c.r31[1] = r1;
  c.r31[2] = r2;
  c.cur = cur;
  Fs& s = c.s;
  if (last >= 0) {
    const unsigned lw = win.cw[last];
    s.st = kSearch;
    s.sub = os - 1;
    s.bb = 0u;
    s.bc = 0;
    s.crc = static_cast<int>(lw & 0xFFFFu);
    s.cc = ((lw >> 16) & 3) > 0 ? 1 : 0;
  }
  if (g1 >= 0) {
    s.cb = 0;
    s.cbits = ((win.cw[g1] >> 16) & 3) == 1 ? 16 : 64;
  }
  if (g2 >= 0) {
    s.plen = 32;
    s.id = win.id[g2];
  }
}

__global__ void __launch_bounds__(kThreads2)
    chain_kernel(const float* __restrict__ metric, Fields sin,
                 float* __restrict__ events, int* __restrict__ n_ev,
                 Fields sout, Geo g, Scratch sc) {
  // the tiles' prefix, then two windows: the chase's and the next one's
  extern __shared__ unsigned buf[];
  int* tps = reinterpret_cast<int*>(buf);
  __shared__ unsigned bw[kThreads2 / 32];
  __shared__ int scan[33];
  __shared__ Walk c;
  const int rows = gridDim.x, row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* m = metric + static_cast<int64_t>(row) * g.n;
  float* ev = events + static_cast<int64_t>(row) * kMaxEvents * 3;
  for (int j = tid; j < kMaxEvents * 3; j += kThreads2) ev[j] = 0.f;
  // the tiles' prefix
  int* tp = g.k + 1 <= kTpCap
                ? tps
                : sc.tp + static_cast<int64_t>(row) * (g.k + 1);
  const int* cnt = sc.cnt + static_cast<int64_t>(row) * g.k;
  const int64_t wbase = static_cast<int64_t>(row) * g.k * (g.tile / 32);
  if (tid == 0) {  // the state's loads in flight with the counts'
    Fs& s = c.s;
    s.st = sin.get(0, row);
    s.sub = sin.get(1, row);
    s.bb = static_cast<uint32_t>(sin.get(2, row));
    s.bc = sin.get(3, row);
    s.crc = sin.get(4, row);
    s.cb = sin.get(5, row);
    s.cbits = sin.get(6, row);
    s.cc = sin.get(7, row);
    s.plen = sin.get(8, row);
    s.id = static_cast<uint32_t>(sin.get(9, row));
    c.cid = static_cast<uint32_t>(sin.get(10, row));
    c.ccount = sin.get(11, row);
    c.emitted = 0;
    c.r31[0] = c.r31[1] = c.r31[2] = 0.f;
    c.i = 0;
    c.fire = 0;
    c.open = -1;
    c.frames = 0;
  }
  int carry = 0;
  for (int t0 = 0; t0 < g.k; t0 += kThreads2) {
    const int t = t0 + tid;
    int sum;
    const int ex = bscan::exclusive_sum(t < g.k ? cnt[t] : 0, scan, kThreads2,
                                        sum);
    if (t < g.k) tp[t] = carry + ex;
    carry += sum;
  }
  if (tid == 0) tp[g.k] = carry;
  __syncthreads();
  const int total = tp[g.k];
  // a frame carried in from the previous call
  if (c.s.st != kSearch) walk_frame(c, m, g.n, g.os, bw, ev);
  if (tid == 0) {
    // the first hit from c.i on: the hits before it
    const int64_t i = c.i;
    c.cur = i == 0 ? 0
            : i >= g.n
                ? total
                : tp[i / g.tile] + sc.wpre[wbase + (i >> 5)] +
                      __popc(sc.hw[wbase + (i >> 5)] & ((1u << (i & 31)) - 1u));
  }
  __syncthreads();
  // the chain, a window of candidates at a time: while thread 0 follows
  // the links through one, warps 1 on load the next (where the chain
  // leaves a window for a later one, that one is loaded by all)
  int base = c.cur, b = 0;
  int span = min(kWindow, total - base);
  if (base < total)
    load_window<kPerAll>(sc, tp, g, row, total, window_at(buf, 0), base,
                         span, tid, kThreads2);
  __syncthreads();
  while (base < total) {
    const int nbase = base + span;
    const int nspan = min(kWindow, total - nbase);
    if (tid == 0)
      chase(c, window_at(buf, b), base, span, total, g.os, ev);
    else if (tid >= 32 && nspan > 0)
      load_window<kPerLoader>(sc, tp, g, row, total, window_at(buf, b ^ 1),
                              nbase, nspan, tid - 32, kThreads2 - 32);
    __syncthreads();
    const int cur = c.cur;
    __syncthreads();  // read by all before thread 0 moves it on
    if (cur >= total) break;
    if (nspan > 0 && cur < nbase + nspan) {  // the chain goes on in it
      base = nbase;
      span = nspan;
      b ^= 1;
    } else {
      base = cur;
      span = min(kWindow, total - base);
      load_window<kPerAll>(sc, tp, g, row, total, window_at(buf, b), base,
                           span, tid, kThreads2);
      __syncthreads();
    }
  }
  // a chain frame open at the row's end
  if (c.open >= 0) {
    if (tid == 0) {
      c.i = c.open;
      c.fire = 1;
    }
    walk_frame(c, m, g.n, g.os, bw, ev);
  }
  if (tid == 0) {
    const Fs& s = c.s;
    const int v[12] = {s.st,  s.sub,   static_cast<int>(s.bb),
                       s.bc,  s.crc,   s.cb,
                       s.cbits, s.cc,  s.plen,
                       static_cast<int>(s.id), static_cast<int>(c.cid),
                       c.ccount};
    for (int f = 0; f < 12; ++f) sout.put(f, row, v[f]);
    if (c.emitted >= kMaxEvents) {
      for (int j = 0; j < 3; ++j) ev[3 * (kMaxEvents - 1) + j] = c.r31[j];
    }
    n_ev[row] = min(c.emitted, kMaxEvents);
    sc.stats[row] = total;
    sc.stats[rows + row] = c.frames;
  }
}

}  // namespace

extern "C" int fastrak_fsm(const float* metric, const float* sync, int n,
                           int rows, const float* thr, int thr_step,
                           void* const* in_p, const int* in_bytes,
                           float* events, int* n_ev, void* const* out_p,
                           const int* out_bytes, int os, int tile,
                           unsigned* hw, int* wpre, int* cnt, int* tp,
                           int* cand, int* next, int* stats, void* stream) {
  // tiles of whole 128-sample groups whose offsets fit in 14 bits; a grid
  // row a stream
  if (n < 1 || rows < 1 || rows > 65535 || os < 1 || tile < 128 ||
      tile % 128 || tile > kMaxTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo g;
  g.n = n;
  g.os = os;
  g.tile = tile;
  g.k = static_cast<int>((static_cast<int64_t>(n) + tile - 1) / tile);
  // the tile and the longest frame that starts in it, in whole groups
  const int64_t want = (static_cast<int64_t>(tile) + (kMaxLen - 1) *
                        static_cast<int64_t>(os) + 127) / 128 * 128;
  g.stage = static_cast<int>(want < kMaxStage ? want : kMaxStage);
  Scratch sc{hw, wpre, cnt, tp, reinterpret_cast<uint2*>(cand), next, stats};
  Fields sin, sout;
  for (int f = 0; f < 12; ++f) {
    if (in_bytes[f] != 1 && in_bytes[f] != 4 && in_bytes[f] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    if (out_bytes[f] != 1 && out_bytes[f] != 4 && out_bytes[f] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    sin.p[f] = in_p[f];
    sin.bytes[f] = in_bytes[f];
    sout.p[f] = out_p[f];
    sout.bytes[f] = out_bytes[f];
  }
  g.thr_step = thr_step;
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(metric) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sync) % 16 == 0;
  // signs, hits and their prefix over the staged samples, the offsets
  const size_t smem1 = (3 * static_cast<size_t>(g.stage / 32) + 1) *
                           sizeof(unsigned) +
                       static_cast<size_t>(tile) * sizeof(uint16_t);
  cudaError_t e = cudaSuccess;
  if (smem1 > 48 * 1024) {
    e = cudaFuncSetAttribute(candidates_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem1));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(candidates_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid1(g.k, rows);
  if (vec)
    candidates_kernel<true><<<grid1, kThreads1, smem1, s>>>(metric, sync, thr,
                                                            g, sc);
  else
    candidates_kernel<false><<<grid1, kThreads1, smem1, s>>>(metric, sync,
                                                             thr, g, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem2 = (kTpCap + 6 * kWindow) * sizeof(unsigned);
  e = cudaFuncSetAttribute(chain_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem2));
  if (e != cudaSuccess) return static_cast<int>(e);
  chain_kernel<<<rows, kThreads2, smem2, s>>>(metric, sin, events, n_ev, sout,
                                              g, sc);
  return static_cast<int>(cudaGetLastError());
}
