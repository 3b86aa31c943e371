// The ACARS decoder's FSM on the card.
//
// Replaces the per-sample lax.scan of ACARSDecoder.apply
// (grbaz_tpu/ops/decode.py:204, scan at :305). Each row of bit metrics
// [B, n] is one stream: searching, a 32-bit correlator of the air bits
// against the preamble 0x3FFE5C5C with a wrong-bit threshold; assembling,
// differential decoding, bytes LSB first with odd parity, bit reversal &
// 0x7F, and SOH/STX/ETX/DEL framing. Finished packets are rows
// [n_bytes, parity errors, bytes...]; the fourth and later of a call are
// added into row 3 in order, the JAX scatter-add's rule.
//
// Sync to sync. The FSM's state matters in two places only, and both
// follow from the input. A sync can fire at bit i only while searching,
// and fires where popc(shift_i ^ preamble) <= threshold: shift_i is the
// last 32 air bits whatever the state (the carried register supplying
// the bits before the call), so the candidates are a mask of the input.
// A packet's bytes are fixed by its sync s: the decoded bit at i is the
// XOR of the air bits s + 1 .. i (prev_bit is 0 at the sync), i.e. the
// running parity of the air bits at i and at s; byte k is decoded bits
// s + 1 + 8k .. s + 8 + 8k; its length is etx + 4 if the byte at
// etx + 3 is DEL (etx the first ETX after byte 13), else 252. The search
// resumes on the bit after the packet's last (the JAX sync reads the old
// `searching`, so a candidate on that bit is not taken).
//
// A block a row, in segments of `seg` bits. The block stages a segment's
// air bits, with the 32 before it and the 2080 after it (a packet synced
// in the segment ends in them), as ballot words (a warp's loads of 16
// words at once); the candidate mask (a funnel shift and a popcount a bit); and
// the running parity (a prefix
// XOR a word and a block scan of the words' parities). One warp then
// walks: the next candidate by a ballot over 32 words and __ffs; the
// packet 32 bytes a round (lane l of round j byte 32 j + l - 2) until its
// end is known, its first ETX by ballots, the DEL test by the lane that
// holds etx + 3, its parity errors by a warp sum; each finished packet
// is listed (its first bit, the parity at its sync, its last byte and
// parity errors). The block then writes the listed packets' rows, thread
// e taking row entry e: rows 0-2 stored, coalesced, row 3 summed in
// packet order. Every value is a float32 integer, but a long call's
// row-3 sums may pass 2^24, so the order of the sums is kept (each
// thread adds its entry packet by packet, as the plain version adds
// rows) and the bits are the plain version's in any case.
//
// A carried packet (the state assembling) is finished first from its
// carried fields, its first byte from the carried partial byte; one
// whose fields no walk leaves (a partial byte outside 0-7 bits or above
// 255, a byte count outside 0-251) is walked bit by bit by the warp, its
// air bits read from global memory. The end state: an open packet's
// fields; else searching, and the carried fields untouched if nothing
// synced or finished; prev_bit the XOR of the air bits since the last
// sync, the register the last 32 air bits.
//
// Bound: staging reads the row once (4n bytes); the walk is a dependent
// chain of packets, each found, decoded to its end and listed
// (`acars_packet_probe` times one alone).
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch. The state's fields are [B] tensors of the
// block's own types, read and written in place of a packed copy:
// searching and got_etx bool, shift int64 (its uint32 bits), prev_bit,
// cur_byte, bit_count, byte_count, parity_errors and etx_index int32;
// packets [B, 252] float.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

struct AcarsFields {
  void *searching, *shift, *prev, *cur, *bits, *bytes, *parity, *etx, *got;
};

namespace {

constexpr int kThreads = 512;
constexpr int kMaxPacket = 252;
constexpr int kMaxPkts = 4;
constexpr int kRow = 2 + kMaxPacket;
constexpr int kSlots = (kRow + 31) / 32;   // row entries a lane
constexpr int kStxIndex = 13;
constexpr int kFields = 9;
constexpr uint32_t kPreamble = 0x3FFE5C5Cu;
constexpr int kSpan = 2080;   // bits past a segment that its packets reach
constexpr int kMaxSeg = 1 << 14;
constexpr int kBatch = 16;    // words a warp stages a round
constexpr int kWords = (32 + kMaxSeg + kSpan) / 32 + 1;
// packets synced in a segment: each takes its sync bit and 18 bytes at
// least
constexpr int kMaxList = kMaxSeg / (1 + 8 * 18) + 2;

// A finished packet of the walk: its first air bit, the parity at its
// sync (the decoded bit at i is q ^ parity(i)), its last byte and its
// parity errors.
struct Listed {
  int p0, q, fin, parity;
};

struct Smem {
  uint32_t air[kWords + 1], cand[kWords + 1], par[kWords + 1];
  Listed list[kMaxList];
  int scan[33];
  int px_next;              // running parity before the next window
  int n_list, k_base, k;    // the segment's packets, the ones before, all
  float pkt[kMaxPacket];    // the bit-by-bit walk's packet
};
static_assert(sizeof(Smem) <= 48 * 1024, "no opt-in to more shared memory");

// A packet's start, the same on every lane: its first air bit p0, the
// decoded bit at i being q ^ parity(i), and the carried partial byte,
// counts and ETX index (a fresh packet: 0, 0, 0, 0, -1, 0).
struct Start {
  int p0, q, cur0, bits0, byte0, par0, etx0, got0;
};

// The decoded packet, the same on every lane.
struct Packet {
  int finished, last_bit, length, parity;  // length: bytes of a finished one
  int cur, bits, bytes, etx, got;          // an open one's fields at n
};

// The air bit of metric m: > 0 is 0, anything else (NaN too) 1.
__device__ __forceinline__ bool air_bit(float m) { return !(m > 0.0f); }

// `len` (1-32) bits of a staged bit array from bit `at` on (bit b of word
// w is bit 32 w + b), the first in bit 0; reads words at/32 and at/32 + 1.
__device__ __forceinline__ uint32_t bits_at(const uint32_t* words, int at,
                                            int len) {
  const int w = at >> 5, b = at & 31;
  const uint64_t v = (static_cast<uint64_t>(words[w + 1]) << 32 | words[w]) >>
                     b;
  return static_cast<uint32_t>(v) &
         (len >= 32 ? bscan::kFull : (1u << len) - 1u);
}

// The packet from `p`, 32 bytes a round until its end is known (lane l of
// round j: byte 32 j + l - 2, row entry 32 j + l), over the staged parity
// words (window coordinates: bit i of the call is bit i - lo): its first
// ETX by ballots, the DEL test in the round that holds etx + 3, its
// parity errors by a warp sum. `val` gets each byte it decodes (-1
// elsewhere and past its end); `d` its end, or an open packet's fields at
// the call's end.
__device__ __forceinline__ void decode_packet(const Smem& sm, int lo, int n,
                                              const Start& p, int lane,
                                              int (&val)[kSlots], Packet& d) {
  const int first = p.p0 + 7 - p.bits0;     // the first new byte's last bit
  const uint32_t qmask = p.q ? bscan::kFull : 0u;
  int etx_first = -1, fin = -1, bad = 0;
  bool del_tested = false;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) val[j] = -1;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int bc = lane + 32 * j - 2, kk = bc - p.byte0;
    const int end = first + 8 * kk, len = kk ? 8 : 8 - p.bits0;
    const bool ok = bc >= 0 && bc < kMaxPacket && kk >= 0 && end <= n - 1;
    const uint32_t f =
        bits_at(sm.par, (ok ? end - len + 1 : p.p0) - lo, len) ^ qmask;
    const uint32_t cur = ((kk ? 0u : static_cast<uint32_t>(p.cur0)) << len) |
                         (__brev(f) >> (32 - len));
    const int v = ok ? static_cast<int>(__brev(cur) >> 24) & 0x7F : -1;
    val[j] = v;
    bad |= (ok && (__popc(cur) & 1) == 0) << j;
    const unsigned m =
        __ballot_sync(bscan::kFull, bc > kStxIndex && v == 0x03);
    if (etx_first < 0 && m) etx_first = 32 * j + __ffs(m) - 3;
    // the byte DEL may end the packet at, row entry del_at + 2: in this
    // round or the next
    const int etx = p.etx0 >= 0 ? p.etx0 : etx_first;
    const int del_at = etx + 3;
    if (!del_tested && etx > 0 && del_at < kMaxPacket &&
        del_at + 2 < 32 * (j + 1)) {
      del_tested = true;
      if (__ballot_sync(bscan::kFull,
                        lane == ((del_at + 2) & 31) && v == 0x7F))
        fin = del_at;
    }
    if (fin < 0 && j == kSlots - 1) fin = kMaxPacket - 1;
    if (fin >= 0 || first + 8 * (32 * (j + 1) - 2 - p.byte0) > n - 1) break;
  }
  const int fin_end = first + 8 * (fin - p.byte0);
  d.finished = fin >= 0 && fin_end <= n - 1;
  const int last_byte = d.finished ? fin : kMaxPacket - 1;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {   // bytes past the end: not its own
    const int bc = lane + 32 * j - 2;
    if (bc > last_byte) val[j] = -1;
    mine += (bad >> j & 1) && bc <= last_byte;
  }
  d.parity = p.par0 + __reduce_add_sync(bscan::kFull, mine);
  if (d.finished) {
    d.last_bit = fin_end;
    d.length = fin + 1;
    return;
  }
  // open at the call's end: complete bytes, then the partial one
  const int nb = n - 1 < first ? 0 : min(kMaxPacket - p.byte0,
                                         (n - 1 - first) / 8 + 1);
  const int from = nb ? first + 8 * (nb - 1) + 1 : p.p0;
  const int t = n - from;
  const uint32_t f = t ? bits_at(sm.par, from - lo, t) ^ qmask : 0u;
  d.cur = static_cast<int>(((nb ? 0u : static_cast<uint32_t>(p.cur0)) << t) |
                           (t ? __brev(f) >> (32 - t) : 0u));
  d.bits = (nb ? 0 : p.bits0) + t;
  d.bytes = p.byte0 + nb;
  d.etx = p.etx0 >= 0 ? p.etx0 : (etx_first >= 0 ? etx_first : p.etx0);
  d.got = p.got0 | (etx_first >= 0);
}

// Row entry j of the lane: the packet's length, parity errors, its new
// bytes, else `base` (the carried packet's bytes, or zeros).
__device__ __forceinline__ float entry(int lane, int j, const Packet& d,
                                       const int (&val)[kSlots], float base) {
  const int e = lane + 32 * j;
  if (e == 0) return static_cast<float>(d.length);
  if (e == 1) return static_cast<float>(d.parity);
  return val[j] >= 0 ? static_cast<float>(val[j]) : base;
}

// A packet's row, stored by the warp (a carried packet: always row 0).
__device__ __forceinline__ void store_row(float* row, int lane,
                                          const Packet& d,
                                          const int (&val)[kSlots],
                                          const float (&base)[kSlots]) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = lane + 32 * j;
    if (e < kRow) row[e] = entry(lane, j, d, val, base[j]);
  }
}

// The first candidate at or after `from` and below `to` (call bits), or
// -1: the warp reads 32 candidate words a round.
__device__ __forceinline__ int next_sync(const Smem& sm, int lo, int from,
                                         int to, int lane) {
  for (int w0 = (from - lo) >> 5; 32 * w0 + lo < to; w0 += 32) {
    const int wi = w0 + lane;
    uint32_t m = 32 * wi + lo < to ? sm.cand[wi] : 0u;
    if (wi == (from - lo) >> 5) m &= bscan::kFull << ((from - lo) & 31);
    const unsigned any = __ballot_sync(bscan::kFull, m != 0u);
    if (any) {
      const int src = __ffs(any) - 1;
      const uint32_t mw = __shfl_sync(bscan::kFull, m, src);
      const int i = lo + 32 * (w0 + src) + __ffs(mw) - 1;
      return i < to ? i : -1;
    }
  }
  return -1;
}

struct Serial {
  uint32_t cur;
  int prev, bits, bytes, parity, etx, got;
};

// One assembling step of the JAX scan in its int32 arithmetic (the
// bit-by-bit walk of a carried packet), every lane alike, the packet in
// shared memory; returns the finished packet's length or 0.
__device__ __forceinline__ int serial_step(Serial& s, int bit, float* pkt,
                                           int lane) {
  const int dec = s.prev ^ bit;
  s.prev = dec;
  const uint32_t cur = (s.cur << 1) | static_cast<uint32_t>(dec);
  if (s.bits + 1 != 8) {
    s.cur = cur;
    s.bits += 1;
    return 0;
  }
  const int bc = s.bytes;
  const int v = static_cast<int>(__brev(cur) >> 24) & 0x7F;
  __syncwarp();
  if (lane == 0) pkt[min(max(bc, 0), kMaxPacket - 1)] = static_cast<float>(v);
  __syncwarp();
  const bool got_del = s.etx > 0 && bc == s.etx + 3 && v == 0x7F;
  if (bc > kStxIndex && v == 0x03) {
    s.got = 1;
    if (s.etx < 0) s.etx = bc;
  }
  if ((__popc(cur) & 1) == 0) s.parity += 1;
  s.cur = 0u;
  s.bits = 0;
  if (got_del || bc + 1 >= kMaxPacket) return bc + 1;
  s.bytes = bc + 1;
  return 0;
}

__global__ void __launch_bounds__(kThreads)
acars_sync_walk(const float* __restrict__ metrics, int n, AcarsFields fin,
                const float* __restrict__ pkt_in, int threshold, int seg,
                float* __restrict__ out, int* __restrict__ n_pk,
                AcarsFields fout, float* __restrict__ pkt_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int r = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const float* x = metrics + static_cast<size_t>(r) * n;
  const float* pin = pkt_in + static_cast<size_t>(r) * kMaxPacket;
  float* rows_out = out + static_cast<size_t>(r) * kMaxPkts * kRow;
  const uint32_t pre_r = __brev(kPreamble);
  // the carried state (every thread reads it; warp 0 walks)
  const int searching0 = static_cast<const uint8_t*>(fin.searching)[r];
  const uint32_t shift0 =
      static_cast<uint32_t>(static_cast<const int64_t*>(fin.shift)[r]);
  const int prev0 = static_cast<const int*>(fin.prev)[r],
            cur0 = static_cast<const int*>(fin.cur)[r],
            bits0 = static_cast<const int*>(fin.bits)[r],
            byte0 = static_cast<const int*>(fin.bytes)[r],
            par0 = static_cast<const int*>(fin.parity)[r],
            etx0 = static_cast<const int*>(fin.etx)[r],
            got0 = static_cast<const uint8_t*>(fin.got)[r];
  const bool carried = !searching0;
  const bool fresh_form = bits0 >= 0 && bits0 <= 7 && byte0 >= 0 &&
                          byte0 < kMaxPacket && cur0 >= 0 && cur0 < 256;
  // the walk's state, the same on every lane of warp 0
  int pos = 0, q = prev0, k = 0, touched = 0, open = 0;
  Packet last{};
  float base[kSlots];
  int open_val[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int bc = lane + 32 * j - 2;
    base[j] = bc >= 0 && bc < kMaxPacket ? pin[bc] : 0.0f;
    open_val[j] = -1;
  }
  float acc3 = 0.0f;   // thread e < 254: entry e of row 3, summed in order
  int pending = carried && fresh_form;   // the carried packet, at once
  if (warp == 0 && carried && !fresh_form) {
    // a carried packet no walk leaves: bit by bit from global memory
    for (int j = lane; j < kMaxPacket; j += 32) sm.pkt[j] = pin[j];
    __syncwarp();
    Serial s{static_cast<uint32_t>(cur0), prev0, bits0, byte0, par0, etx0,
             got0};
    int px = 0, i = 0, len = 0;
    for (; i < n && !len; ++i) {
      const int b = air_bit(x[i]);
      px ^= b;
      len = serial_step(s, b, sm.pkt, lane);
    }
    q = s.prev ^ px;
    float from_smem[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int bc = lane + 32 * j - 2;
      from_smem[j] = bc >= 0 && bc < kMaxPacket ? sm.pkt[bc] : 0.0f;
    }
    if (len) {
      const Packet d{1, i - 1, len, s.parity, 0, 0, 0, 0, 0};
      store_row(rows_out, lane, d, open_val, from_smem);
      k = 1;
      touched = 1;
      pos = i;
    } else {
      open = 1;
      last = Packet{0, n - 1, 0, s.parity, static_cast<int>(s.cur), s.bits,
                    s.bytes, s.etx, s.got};
#pragma unroll
      for (int j = 0; j < kSlots; ++j) base[j] = from_smem[j];
    }
  }
  int lo = -32;   // the window's first bit
  for (int s0 = 0; s0 == 0 || s0 < n; s0 += seg) {
    lo = s0 - 32;
    const int hi = min(n, s0 + seg + kSpan);
    const int nwords = (hi - lo + 31) >> 5;
    // stage: air bits as ballot words, a warp 16 words a round with their
    // loads at once (the carried register, bit-reversed, before bit 0)
    for (int w0 = warp; w0 < nwords; w0 += kBatch * (kThreads / 32)) {
      float m[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = lo + 32 * (w0 + u * (kThreads / 32)) + lane;
        m[u] = i >= 0 && i < n ? x[i] : 1.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int wi = w0 + u * (kThreads / 32);
        const int i = lo + 32 * wi + lane;
        const unsigned v = __ballot_sync(bscan::kFull, i < n && air_bit(m[u]));
        if (lane == 0 && wi < nwords)
          sm.air[wi] = lo + 32 * wi < 0 ? __brev(shift0) : v;
      }
    }
    if (t == 0) sm.air[nwords] = 0u;
    __syncthreads();
    // candidates (syncs only in [s0, s0 + seg)) and the running parity
    const int per = (nwords + kThreads - 1) / kThreads;
    int ones = 0;
    for (int j = 0; j < per; ++j) {
      const int wi = t * per + j;
      if (wi >= nwords) break;
      uint32_t c = 0u;
      const int i0 = lo + 32 * wi;
      if (wi > 0 && i0 + 31 >= s0 && i0 < min(n, s0 + seg)) {
        const uint64_t v = static_cast<uint64_t>(sm.air[wi]) << 32 |
                           sm.air[wi - 1];
#pragma unroll 8
        for (int b = 0; b < 32; ++b) {
          const uint32_t f = static_cast<uint32_t>(v >> (b + 1));
          const int i = i0 + b;
          c |= static_cast<uint32_t>(__popc(f ^ pre_r) <= threshold &&
                                     i >= s0 && i < n && i < s0 + seg)
               << b;
        }
      }
      sm.cand[wi] = c;
      ones += i0 < 0 ? 0 : __popc(sm.air[wi]);
    }
    int all = 0;
    const int before = bscan::exclusive_sum(ones, sm.scan, kThreads, all);
    int p = ((s0 ? sm.px_next : 0) + before) & 1;
    for (int j = 0; j < per; ++j) {
      const int wi = t * per + j;
      if (wi >= nwords) break;
      uint32_t v = lo + 32 * wi < 0 ? 0u : sm.air[wi];
      v ^= v << 1;
      v ^= v << 2;
      v ^= v << 4;
      v ^= v << 8;
      v ^= v << 16;
      sm.par[wi] = p ? ~v : v;
      p ^= v >> 31;
    }
    if (t == 0) sm.par[nwords] = 0u;
    __syncthreads();
    if (t == 0 && s0 + seg < n)
      sm.px_next = (sm.par[(seg - 1) >> 5] >> ((seg - 1) & 31)) & 1;
    if (warp == 0) {
      // the walk: the packets' ends only, their rows after it
      int val[kSlots];
      if (pending) {
        pending = 0;
        const Start st{0, prev0, cur0, bits0, byte0, par0, etx0, got0};
        decode_packet(sm, lo, n, st, lane, val, last);
        if (last.finished) {
          store_row(rows_out, lane, last, val, base);
          k = 1;
          touched = 1;
          pos = last.last_bit + 1;
        } else {
          open = 1;
#pragma unroll
          for (int j = 0; j < kSlots; ++j) open_val[j] = val[j];
        }
      }
      const int k_base = k;
      while (!open) {
        const int sync = next_sync(sm, lo, max(pos, s0), min(n, s0 + seg),
                                   lane);
        if (sync < 0) break;
        touched = 1;
        q = (sm.par[(sync - lo) >> 5] >> ((sync - lo) & 31)) & 1;
        const Start st{sync + 1, q, 0, 0, 0, 0, -1, 0};
        decode_packet(sm, lo, n, st, lane, val, last);
        if (last.finished) {
          if (lane == 0)
            sm.list[k - k_base] =
                Listed{sync + 1, q, last.length - 1, last.parity};
          ++k;
          pos = last.last_bit + 1;
        } else {
          open = 1;
#pragma unroll
          for (int j = 0; j < kSlots; ++j) {
            open_val[j] = val[j];
            base[j] = 0.0f;
          }
        }
      }
      if (lane == 0) {
        sm.n_list = k - k_base;
        sm.k_base = k_base;
        sm.k = k;
      }
    }
    __syncthreads();
    // the listed packets' rows: thread e their entry e, in packet order
    if (t < kRow) {
      const int listed = sm.n_list, k_base = sm.k_base;
      for (int i = 0; i < listed; ++i) {
        const Listed pk = sm.list[i];
        const int bc = t - 2;
        float v = 0.0f;
        if (t == 0) {
          v = static_cast<float>(pk.fin + 1);
        } else if (t == 1) {
          v = static_cast<float>(pk.parity);
        } else if (bc <= pk.fin) {
          v = static_cast<float>(
              (bits_at(sm.par, pk.p0 + 8 * bc - lo, 8) ^
               (pk.q ? bscan::kFull : 0u)) & 0x7Fu);
        }
        const int kk = k_base + i;
        if (kk < kMaxPkts - 1) {
          rows_out[kk * kRow + t] = v;
        } else {
          acc3 = __fadd_rn(acc3, v);
        }
      }
    }
    __syncthreads();
  }
  // rows not written, row 3's sums
  if (t < kRow) {
    for (int row = min(sm.k, kMaxPkts - 1); row < kMaxPkts - 1; ++row)
      rows_out[row * kRow + t] = 0.0f;
    rows_out[(kMaxPkts - 1) * kRow + t] = acc3;
  }
  if (warp != 0) return;
  // the state: the register and prev_bit from the last window
  const uint32_t shift = __brev(bits_at(sm.air, n - 32 - lo, 32));
  const int px_end = (sm.par[(n - 1 - lo) >> 5] >> ((n - 1 - lo) & 31)) & 1;
  int f[kFields] = {1, static_cast<int>(shift), q ^ px_end, cur0, bits0,
                    byte0, par0, etx0, got0};
  if (open) {
    f[0] = 0;
    f[3] = last.cur;
    f[4] = last.bits;
    f[5] = last.bytes;
    f[6] = last.parity;
    f[7] = last.etx;
    f[8] = last.got;
  } else if (touched) {
    f[3] = f[4] = f[5] = f[6] = f[8] = 0;
    f[7] = -1;
  }
  if (lane == 0) {
    n_pk[r] = min(k, kMaxPkts);
    static_cast<uint8_t*>(fout.searching)[r] = f[0] != 0;
    static_cast<int64_t*>(fout.shift)[r] = static_cast<uint32_t>(f[1]);
    int* const ints[6] = {
        static_cast<int*>(fout.prev), static_cast<int*>(fout.cur),
        static_cast<int*>(fout.bits), static_cast<int*>(fout.bytes),
        static_cast<int*>(fout.parity), static_cast<int*>(fout.etx)};
    for (int j = 0; j < 6; ++j) ints[j][r] = f[2 + j];
    static_cast<uint8_t*>(fout.got)[r] = f[8] != 0;
  }
  float* po = pkt_out + static_cast<size_t>(r) * kMaxPacket;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int bc = lane + 32 * j - 2;
    if (bc < 0 || bc >= kMaxPacket) continue;
    float v = base[j];
    if (open) {
      if (open_val[j] >= 0) v = static_cast<float>(open_val[j]);
    } else if (touched) {
      v = 0.0f;
    }
    po[bc] = v;
  }
}

// `steps` packets of the walk's dependent work alone on one warp (find
// the next candidate, decode the packet up to its end, list it), over a
// staged window of packets of the least length, 18 bytes (ETX at byte 14,
// DEL at 17: one round of 32 bytes), a candidate every 200 bits
__global__ void packet_probe_kernel(int steps, int* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x;
  constexpr int kEvery = 200, kSyncs = 40, kBits = kEvery * kSyncs + 256;
  for (int wi = lane; wi <= kBits / 32 + 1; wi += 32) {
    uint32_t c = 0u, v = 0u;
    for (int b = 0; b < 32; ++b) {
      const int i = 32 * wi + b, at = i % kEvery - 1, byte = at >> 3;
      // decoded bits (q = 0): byte 14 ETX, byte 17 DEL, the rest 'A'
      const int val = byte == 14 ? 0x03 : byte == 17 ? 0x7F : 0x41;
      v |= static_cast<uint32_t>(at >= 0 && (val >> (at & 7) & 1)) << b;
      c |= static_cast<uint32_t>(i % kEvery == 0 && i < kEvery * kSyncs)
           << b;
    }
    sm.par[wi] = v;
    sm.cand[wi] = c;
  }
  __syncwarp();
  int pos = 0, acc = 0, val[kSlots];
  Packet d{};
  for (int i = 0; i < steps; ++i) {
    int sync = next_sync(sm, 0, pos, kEvery * kSyncs, lane);
    if (sync < 0) sync = next_sync(sm, 0, 0, kEvery * kSyncs, lane);
    const Start st{sync + 1, 0, 0, 0, 0, 0, -1, 0};
    decode_packet(sm, 0, kBits, st, lane, val, d);
    if (lane == 0)
      sm.list[i % kMaxList] = Listed{sync + 1, 0, d.length - 1, d.parity};
    acc += d.parity;
    pos = d.last_bit + 1;
  }
  if (lane == 0) out[0] = acc;
}

}  // namespace

extern "C" int acars_fsm(const float* metrics, int n, int rows,
                         AcarsFields fin, const float* pkt_in, int threshold,
                         int seg, float* out, int* n_pk, AcarsFields fout,
                         float* pkt_out, void* stream) {
  if (n < 1 || rows < 1 || seg < 32 || seg > kMaxSeg || seg % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  acars_sync_walk<<<rows, kThreads, sizeof(Smem),
                 static_cast<cudaStream_t>(stream)>>>(
      metrics, n, fin, pkt_in, threshold, seg, out, n_pk, fout, pkt_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int acars_packet_probe(int steps, void* out, void* stream) {
  packet_probe_kernel<<<1, 32, sizeof(Smem),
                        static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
