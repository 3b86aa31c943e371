// The channel bank's channelizer: C channels over one wideband block,
// complex64, ROTATED outputs and the ROTATED carried tail, one launch.
//
// Replaces, for grbaz_tpu_torch/parallel/channel_bank.py: DynamicChannelBank,
// the per-slot math of grbaz_tpu/parallel/channel_bank.py (apply, :107-118;
// XLA in the JAX package, B1's math of
// grbaz_tpu/ops/pallas/wbfm_frontend.py: xlating_fir_block_pallas_xal per
// slot). For slot c, with lo_c(i) = exp(j*ang(u32(phase0[c] + i*inc[c])))
// and the carried tail[c] of tpad-1 samples already rotated,
//     frame_c = concat(tail[c], x * lo_c)
//     y[c, k] = sum_{t < tpad} h_rev_pad[t] * frame_c[k*decim + t]
//     new_tail[c] = frame_c[-(tpad-1):]
// Angles are __uint2float_rn(ph) * float32(2pi/2^32), rounded as
// grbaz_tpu/ops/exact.py: turns_u32_to_radians; sin/cos the accurate
// sincosf.
//
// The body is a matrix product. An output k >= k_head = ceil((tpad-1)/decim)
// reads only new samples, i = k*decim + t - (tpad-1) >= 0, and the uint32
// phase of sample i is u32(phase0 + k*decim*inc) + u32((t-(tpad-1))*inc),
// exactly, so
//     y[c, k] = lo_c(k*decim) * sum_t g_c[t] * x[k*decim + t - (tpad-1)]
// with the rotated taps g_c[t] = h_rev_pad[t] * lo((t-(tpad-1))*inc[c]).
// In real form that is A @ B: row k of A is the window of x, re and im
// interleaved (2*tpad floats, consecutive rows 2*decim floats apart, so
// the rows overlap), and B packs every slot's taps as the 2x2 blocks
// [[Re g, Im g], [-Im g, Re g]], giving two columns (re, im) a slot. For
// 16 slots at the scanner's shape (2^17 samples in, decim 8, 104 taps)
// that is M = 16371, K = 208, N = 32.
//
// Design (H100):
//   * Grid: x = one block per tile of TILE_M = 128 outputs, then GROUP
//     head blocks; y = slot group of GROUP = 16 slots (N = 32 columns).
//     The tiles come first, so the scheduler spreads them one an SM and
//     the light head blocks fill in after them. A tile block stages the
//     samples its outputs read ONCE for every slot of its group,
//     (TILE_M-1)*decim + ks of them, one 8-byte cp.async a sample, all
//     issued before any is waited on, zero-filled past the block's end
//     (a grid row per slot, as on the single-slot polyphase core, would
//     stage every sample once a slot).
//   * Slabs: B takes 512 bytes a tap and the samples 16 a tap, so a tile
//     takes the taps in slabs of ks (a multiple of 8), the widest that
//     fits shared memory, evened out over as few slabs as that allows,
//     and keeps its accumulators across them: stage, split and multiply
//     a slab, then the next. The scanner's 104 taps are one slab (73 KB);
//     a narrow-band plan's 1544 taps at decim 8 four of 392. A slab of
//     fewer taps than decim stages only the ks phases it reads, so the
//     shared memory grows with neither the taps nor decim.
//   * Layout: the samples lie PHASE-PLANAR, xh[(u % decim)*PS + u/decim]
//     (float2), so A(r, t) lies at (t % decim)*PS + t/decim + r. The K
//     order inside a step of 8 is permuted (free, since B is permuted
//     alike): step s covers samples t = 4s..4s+3, its columns q and q+4
//     the re and im of sample 4s+q. A lane's A fragment (rows g and g+8,
//     columns q and q+4) is then two float2 loads, and with the plane
//     stride PS = 4 mod 16 the 16 lanes of a half-warp read 16 distinct
//     bank pairs (decim 8: four planes, rows g..g+3).
//   * The product: 3xTF32 on wgmma.m64n32k8 (tf32 in, f32 sums), one
//     warpgroup a 64-output half of the tile, A from registers (its rows
//     overlap, so no shared-memory layout of it exists), B from shared
//     memory. Each operand is split a = hi + lo, hi = tf32(a), lo =
//     tf32(a - hi), and the sum takes lo*hi + hi*lo + hi*hi, dropping
//     only lo*lo: ~21 bits of each operand, against 1xTF32's ~11, which
//     misses the port's 1e-5 bar (tests/test_torch_bank_gemm.py emulates
//     both). The taps are split while the copies fly, into B hi and B lo
//     (K-major, no swizzle: core matrices of 8 columns x 4 K values); the
//     samples once after they land, into hi planes and lo planes (each
//     feeds ~tpad/decim rows).
//   * Latency: each term and the steps of each parity sum into
//     accumulators of their own (six chains of dependent products, not
//     one), and two A fragments take turns, so step s+1's loads run while
//     step s's products do (three fragments, loading two steps ahead,
//     measured slower: PERF.md).
//   * Long sums: the tensor cores' f32 sums lose more than round-to-
//     nearest adds (8192 taps in one chain of 1024 steps: 1.4-2.1e-5 of
//     the max against the CPU emulation's 1.5e-6), so every FOLD steps
//     the six chains are added into plain f32 sums and start from zero.
//     The scanner's 26 steps are one fold.
//   * Taps: lo((t-(tpad-1))*inc) = lo((8a-(tpad-1))*inc) * lo(b*inc) for
//     t = 8a + b, both exact uint32 phases: a table of ks/8 + 9 sincosf
//     a slot and slab, one complex product a tap (one sincosf a tap, in
//     every block, measured 11.7 against 10.5 us: PERF.md).
//   * Epilogue: the accumulators of column pair (2q, 2q+1) of column tile
//     j are slot 4j+q's (re, im), so each lane rotates its own outputs by
//     lo_c(k*decim), one accurate sincosf of the exact phase each, and
//     stores them.
//   * Head outputs k < k_head reach into each slot's own history and share
//     nothing across slots: one head block a slot builds the head of its
//     frame (the rotated tail, then x * lo_c over the first k_head*decim
//     samples) in shared memory and sums it in rotate-then-filter form,
//     8 lanes an output, 32 outputs a pass; a pass stages its frame in
//     slabs of at most HEAD_F samples, so long filters fit too. It also
//     writes the slot's new tail (the old tail's remainder when
//     n < tpad-1).
//
// Bounds on an H100 at the scanner's shape. The function, rotate-then-
// filter per slot, is 16 x (6 x 2^17 + 4 x 104 x 16384) = 121.6 MFLOP,
// 1.8 us at the 67 TFLOP/s f32 peak; that is the bound chip_smoke.py
// reports. Computed to the same 1e-5 bar on TF32 tensor cores, rotate-
// then-filter in 3xTF32 is ~327 MFLOP, 0.66 us at the 495 TFLOP/s dense
// peak, plus 12.6 MFLOP of rotation, so the card's floor is the bytes:
// 1 MiB of block, 16 x 103 x 8 of tails in and out and 2 MiB of outputs,
// 0.9 us at 3.35 TB/s. This kernel's own real-form method is 654 MFLOP
// of TF32, 1.3 us. At 10.5 us it is ~11x the 0.9 us floor. What holds
// it (PERF.md): one tile an SM runs its phases in turn (launch, copies
// and taps, split, product, epilogue), each short of warps to hide its
// latency.
//
// The phases and increments arrive as POINTERS to int64 device arrays
// (uint32 values), so a launch never reads device state back to the host.

#include "polyphase_fir.cuh"

namespace bank {

constexpr int GROUP = 16;              // slots a block serves: N = 32
constexpr int WARPS = 8;               // two warpgroups
constexpr int TILE_M = WARPS * 16;     // outputs a tile block owns
constexpr int THREADS = WARPS * 32;
constexpr int HEAD_LANES = 8;          // lanes summing one head output
constexpr int HEAD_F = 4096;           // frame samples a head block stages
constexpr int FOLD = 32;               // MMA steps an accumulator chain takes
constexpr int MAX_TAPS = 1 << 24;      // past these, int sizes could wrap
constexpr int MAX_DECIM = 1 << 20;

// Every size that follows from a problem, worked out on the host.
struct Layout {
  int k_head;  // outputs that reach into the history: ceil((tpad-1)/decim)
  int kh;      // head outputs stored: min(k_head, n_out)
  int tiles;   // tile blocks: ceil((n_out - k_head) / TILE_M), or 0
  int groups;  // slot groups
  int tpad4;   // taps padded with zeros to a multiple of 4 (MMA steps)
  int ks;      // taps a slab, a multiple of 8: all of them when they fit
  int np;      // sample planes a slab stages: min(decim, ks)
  int span;    // samples a slab's staging walks: (TILE_M-1)*decim + ks
  int plane;   // plane stride in samples, 4 mod 16
  int hper;    // head outputs a pass: min(32, (HEAD_F/2)/decim + 1)
  int hts;     // head taps a frame slab: HEAD_F - (hper-1)*decim
  int64_t smem;
};

__host__ __device__ constexpr int steps(int taps) { return taps / 4; }
// bytes before the taps: the samples' hi and lo planes, rounded up to 128
__host__ __device__ constexpr int64_t taps_at(int planes, int plane) {
  return ((int64_t)planes * plane * 16 + 127) / 128 * 128;
}
// the taps' LO table a slot: ks/8 + 1 coarse phasors, then 8 fine
__host__ __device__ constexpr int lo_table(int ks) { return ks / 8 + 9; }

// a tile block's shared memory for slabs of ks taps; sets np, span, plane
inline int64_t tile_smem(Layout& l, int ks, int decim) {
  l.np = decim < ks ? decim : ks;
  l.span = (TILE_M - 1) * decim + ks;
  const int rows = TILE_M + (ks - 1) / decim;
  l.plane = rows + ((4 - rows) % 16 + 16) % 16;
  return taps_at(l.np, l.plane) +                    // samples
         (int64_t)steps(ks) * 2 * 256 * 4 +          // B hi, lo
         (int64_t)GROUP * lo_table(ks) * 8;          // LO table
}

inline Layout layout(int64_t n_out, int tpad, int decim, int slots) {
  Layout l;
  l.k_head = (tpad - 1 + decim - 1) / decim;
  l.kh = (int)(n_out < l.k_head ? n_out : l.k_head);
  const int64_t body = n_out - l.k_head;
  l.tiles = body > 0 ? (int)((body + TILE_M - 1) / TILE_M) : 0;
  l.groups = (slots + GROUP - 1) / GROUP;
  l.tpad4 = (tpad + 3) / 4 * 4;
  // the widest slab (in eighths of taps) that fits; 8 taps always fit
  int lo = 1, hi = (l.tpad4 + 7) / 8;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_smem(l, 8 * mid, decim) <= pfir::MAX_SMEM) lo = mid;
    else hi = mid - 1;
  }
  // as few slabs as that allows, evened out
  const int slabs = (l.tpad4 + 8 * lo - 1) / (8 * lo);
  l.ks = ((l.tpad4 + slabs - 1) / slabs + 7) / 8 * 8;
  const int64_t tile = tile_smem(l, l.ks, decim);
  l.hper = THREADS / HEAD_LANES;
  if ((HEAD_F / 2) / decim + 1 < l.hper) l.hper = (HEAD_F / 2) / decim + 1;
  l.hts = HEAD_F - (l.hper - 1) * decim;
  const int64_t frame = (int64_t)(tpad - 1) + (int64_t)l.kh * decim;
  const int64_t head = (frame < HEAD_F ? frame : HEAD_F) * 8;
  l.smem = tile > head ? tile : head;
  return l;
}

struct Problem {
  const float2* x;     // the shared block, n samples
  const float2* tail;  // [slots, tpad-1], rotated
  int64_t n;
  const float* h;      // [tpad] real reversed taps
  const int64_t* phase0;  // [slots], the phase of x[0]
  const int64_t* inc;     // [slots]
  float2* y;           // [slots, n_out]
  float2* new_tail;    // [slots, tpad-1]
  int n_out, tpad, decim, slots;
};

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 lo_at(uint32_t ph) {
  float s, c;
  sincosf(__uint2float_rn(ph) * pfir::TO_RAD, &s, &c);
  return make_float2(c, s);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// round to TF32 (nearest, ties away): the low 13 mantissa bits zero
__device__ __forceinline__ float tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

struct Split {
  float hi, lo;
};
__device__ __forceinline__ Split split(float v) {
  const float hi = tf32(v);
  return {hi, tf32(v - hi)};
}

// ---------------------------------------------------------------------------
// wgmma m64n32k8: d (16 rows a warp x 32 columns; d[4j..4j+3] is column
// tile j as an mma.m16n8 accumulator: rows g, g+8, columns 2q, 2q+1)
// += a (this warp's 16 rows: a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3
// (g+8, q+4)) * B (8 x 32 in shared memory, K-major, no swizzle: core
// matrices of 8 columns x 4 K values, 128 bytes; LBO between the two
// along K, SBO between those along N)
// ---------------------------------------------------------------------------

constexpr uint32_t WG_LBO = 128, WG_SBO = 256;

__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(WG_LBO >> 4) << 16) |
         ((uint64_t)(WG_SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const float (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(b),
        "r"(1));
}

// keep the compiler from moving registers the asynchronous product reads
// or writes across this point: the accumulators, and an A fragment until
// the product that reads it is known complete
template <int N>
__device__ __forceinline__ void wg_fence_operand(float (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(r[e])::"memory");
}

__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// head block: slot c's outputs k < kh and its new tail
// ---------------------------------------------------------------------------

__device__ void head(const Problem& pr, const Layout& lay, int c,
                     float2* fr) {
  const int tid = threadIdx.x, D = pr.decim, hist = pr.tpad - 1;
  const uint32_t p0 = (uint32_t)pr.phase0[c], inc = (uint32_t)pr.inc[c];
  const float2* tail = pr.tail + (int64_t)c * hist;
  // frame_c[u], u < hist + kh*decim: the tail, then sample i = u - hist
  const int nf_all = hist + lay.kh * D;
  // HEAD_LANES lanes an output, hper outputs a pass; each pass stages its
  // frame in slabs of hts taps, at most HEAD_F samples. The loop bounds
  // are block-uniform, so every lane of a warp reaches the barriers and
  // the shuffles.
  const int l = tid % HEAD_LANES, oo = tid / HEAD_LANES;
  for (int o0 = 0; o0 < lay.kh; o0 += lay.hper) {
    const int o = o0 + oo;
    const bool mine = oo < lay.hper && o < lay.kh;
    float2 a = make_float2(0.f, 0.f);
    for (int t0 = 0; t0 < pr.tpad; t0 += lay.hts) {
      // fr[v] = frame_c[base + v]
      const int base = o0 * D + t0;
      const int span = (lay.hper - 1) * D + lay.hts;
      const int nf = span < nf_all - base ? span : nf_all - base;
      __syncthreads();  // the previous slab is summed
      for (int v = tid; v < nf; v += THREADS) {
        const int i = base + v - hist;
        fr[v] = i < 0 ? tail[base + v]
                      : cmul(pr.x[i], lo_at(p0 + (uint32_t)i * inc));
      }
      __syncthreads();
      if (mine) {
        const int te = t0 + lay.hts < pr.tpad ? t0 + lay.hts : pr.tpad;
        for (int t = t0 + l; t < te; t += HEAD_LANES) {
          const float2 v = fr[(o - o0) * D + t - t0];
          a.x = fmaf(pr.h[t], v.x, a.x);
          a.y = fmaf(pr.h[t], v.y, a.y);
        }
      }
    }
    for (int off = HEAD_LANES / 2; off; off >>= 1) a = pfir::shfl_add(a, off);
    if (l == 0 && mine) pr.y[(int64_t)c * pr.n_out + o] = a;
  }
  // the new tail: frame_c's last hist samples, i = n - hist + j
  float2* nt = pr.new_tail + (int64_t)c * hist;
  for (int j = tid; j < hist; j += THREADS) {
    const int64_t i = pr.n - hist + j;
    nt[j] = i < 0 ? tail[hist + i]
                  : cmul(pr.x[i], lo_at(p0 + (uint32_t)i * inc));
  }
}

// ---------------------------------------------------------------------------
// tile block: outputs [k0, k0 + TILE_M) of every slot of the group
// ---------------------------------------------------------------------------

__device__ void tile(const Problem& pr, const Layout& lay, int64_t k0,
                     int c0, unsigned char* smem) {
  const int tid = threadIdx.x, D = pr.decim, PS = lay.plane, NP = lay.np;
  const int ks = lay.ks, nlo = lo_table(ks), na = nlo - 8;
  // the samples' hi planes, their lo planes, B (per step: hi, then lo,
  // 256 floats each), the LO table
  float2* xh = reinterpret_cast<float2*>(smem);
  float2* xl = xh + NP * PS;
  float* bw = reinterpret_cast<float*>(smem + taps_at(NP, PS));
  float2* lot = reinterpret_cast<float2*>(bw + steps(ks) * 512);

  // the product: lane (g, q) of warp w owns rows 16w + g and 16w + g + 8
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4, r0 = warp * 16 + g;
  // this lane's sample t = 4s + q of step s (t counted from the slab's
  // first tap) lies in plane t % D, row t / D; (tph, tj) walks t in
  // steps of 4
  int tph = 0, tj = 0;
  // accumulators: [step parity][lo*hi, hi*lo, hi*hi] over at most FOLD
  // steps, then their sum in acc
  float d[2][3][16], acc[16], ah0[4], al0[4], ah1[4], al1[4];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    acc[e] = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int t = 0; t < 3; ++t) d[p][t][e] = 0.f;
  }
  auto fence_d = [&] {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int t = 0; t < 3; ++t) wg_fence_operand(d[p][t]);
  };
  // the six chains into acc, the small terms first; they start again
  auto fold = [&] {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[i] += ((d[0][0][i] + d[1][0][i]) + (d[0][1][i] + d[1][1][i])) +
                (d[0][2][i] + d[1][2][i]);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int t = 0; t < 3; ++t) d[p][t][i] = 0.f;
    }
  };
  // step s: load this warp's A fragment (hi, lo), then issue its three
  // products as one group
  auto issue = [&](int s, float (&ah)[4], float (&al)[4],
                   float (&dd)[3][16]) {
    const int off = tph * PS + tj + r0;
    const float2 h0 = xh[off], h1 = xh[off + 8];
    const float2 l0 = xl[off], l1 = xl[off + 8];
    ah[0] = h0.x, ah[1] = h1.x, ah[2] = h0.y, ah[3] = h1.y;
    al[0] = l0.x, al[1] = l1.x, al[2] = l0.y, al[3] = l1.y;
    tph += 4;
    while (tph >= D) {
      tph -= D;
      ++tj;
    }
    const float* b = bw + s * 512;
    wg_arrive();
    wgmma_tf32(dd[0], al, wg_desc(b));
    wgmma_tf32(dd[1], ah, wg_desc(b + 256));
    wgmma_tf32(dd[2], ah, wg_desc(b));
    wg_commit();
  };

  // the taps in slabs of ks (one slab when they all fit): tap t = kb + tl
  for (int kb = 0; kb < lay.tpad4; kb += ks) {
    if (kb) {
      // every product of the last slab is complete; its planes and taps
      // are free for this one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    // stage span u of the block, sample i = s0 + u, phase-planar: plane
    // u % D, row u / D; a slab of fewer taps than decim reads only planes
    // below ks
    {
      const int64_t s0 = k0 * D - (pr.tpad - 1) + kb;  // >= 0: k0 >= k_head
      int ph = tid % D, j = tid / D;
      const int dj = THREADS / D, dp = THREADS % D;
      for (int u = tid; u < lay.span; u += THREADS) {
        if (ph < NP) {
          const int64_t i = s0 + u;
          const bool in = i < pr.n;
          pfir::cp_async<8>(xh + ph * PS + j, pr.x + (in ? i : 0),
                            in ? 8 : 0);
        }
        j += dj;
        ph += dp;
        if (ph >= D) {
          ph -= D;
          ++j;
        }
      }
    }
    // while the copies fly: the LO table (slot q's coarse[a], the phasor of
    // (kb + 8a - (tpad-1))*inc, at q*nlo + a, fine[b] at q*nlo + na + b),
    // then the group's split taps. Tap tl of slot q is B's K rows tl%4
    // (re) and tl%4 + 4 (im) of step tl/4, in columns n = 2q (re) and
    // 2q + 1 (im): core matrix (n/8, K/4) at (n/8)*64 + (K/4)*32 floats,
    // its row n%8 at (n%8)*4. Consecutive threads take consecutive taps,
    // then slots, so a warp's stores hit each bank twice.
    for (int idx = tid; idx < GROUP * nlo; idx += THREADS) {
      const int qq = idx / nlo, e = idx % nlo, c = c0 + qq;
      const uint32_t inc = c < pr.slots ? (uint32_t)pr.inc[c] : 0u;
      const int m = e < na ? kb + 8 * e - (pr.tpad - 1) : e - na;
      lot[idx] = lo_at((uint32_t)m * inc);
    }
    __syncthreads();
    const int kn = lay.tpad4 - kb < ks ? lay.tpad4 - kb : ks;
#pragma unroll 4
    for (int idx = tid; idx < kn * GROUP; idx += THREADS) {
      const int qq = idx / 4 % GROUP;
      const int tl = idx / (4 * GROUP) * 4 + idx % 4, t = kb + tl;
      float2 gt = make_float2(0.f, 0.f);
      if (t < pr.tpad && c0 + qq < pr.slots) {
        const float2 lo =
            cmul(lot[qq * nlo + tl / 8], lot[qq * nlo + na + tl % 8]);
        gt = make_float2(pr.h[t] * lo.x, pr.h[t] * lo.y);
      }
      const Split re = split(gt.x), im = split(gt.y);
      float* e = bw + (tl / 4) * 512 + qq / 4 * 64 + 2 * (qq % 4) * 4 + tl % 4;
      e[0] = re.hi;    // (re column, re row)
      e[4] = im.hi;    // (im column, re row)
      e[32] = -im.hi;  // (re column, im row)
      e[36] = re.hi;   // (im column, im row)
      e[256] = re.lo;
      e[260] = im.lo;
      e[288] = -im.lo;
      e[292] = re.lo;
    }
    pfir::cp_async_wait_all();
    __syncthreads();
    // split every staged sample once: hi in place, lo beside it
    for (int i = tid; i < NP * PS; i += THREADS) {
      const float2 v = xh[i];
      const Split re = split(v.x), im = split(v.y);
      xh[i] = make_float2(re.hi, im.hi);
      xl[i] = make_float2(re.lo, im.lo);
    }
    // the taps written by threads, read by wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // two fragments in turn: step s+1 loads while step s's products run
    const int ns = steps(kn);
    tph = q % D;
    tj = q / D;
    fence_d();
    for (int s = 0; s < ns; s += 2) {
      issue(s, ah0, al0, d[0]);
      wg_wait<1>();  // step s-1 done: fragment 1 is free
      wg_fence_operand(ah1);
      wg_fence_operand(al1);
      if (s + 1 < ns) {
        issue(s + 1, ah1, al1, d[1]);
        wg_wait<1>();  // step s done: fragment 0 is free
        wg_fence_operand(ah0);
        wg_fence_operand(al0);
      }
      if ((s + 2) % FOLD == 0 && s + 2 < ns) {
        wg_wait<0>();
        fence_d();
        fold();
        fence_d();
      }
    }
    wg_wait<0>();
    fence_d();
    fold();
  }

  // epilogue: column tile j's (2h, 2h+1) is slot 4j + q's (re, im) at
  // row r0 + 8h
#pragma unroll
  for (int j = 0; j < GROUP / 4; ++j) {
    const int c = c0 + 4 * j + q;
    if (c >= pr.slots) continue;
    const uint32_t p0 = (uint32_t)pr.phase0[c];
    const uint32_t dinc = (uint32_t)D * (uint32_t)pr.inc[c];
    float2* yc = pr.y + (int64_t)c * pr.n_out;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t k = k0 + r0 + h * 8;
      const int i = 4 * j + 2 * h;
      if (k < pr.n_out)
        yc[k] = cmul(make_float2(acc[i], acc[i + 1]),
                     lo_at(p0 + (uint32_t)k * dinc));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
channel_bank_kernel(Problem pr, Layout lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c0 = blockIdx.y * GROUP;
  if ((int)blockIdx.x < lay.tiles) {
    tile(pr, lay, lay.k_head + (int64_t)blockIdx.x * TILE_M, c0, smem);
    return;
  }
  const int c = c0 + (int)blockIdx.x - lay.tiles;
  if (c < pr.slots) head(pr, lay, c, reinterpret_cast<float2*>(smem));
}

}  // namespace bank

// y[slots, n/decim] and new_tail[slots, tpad-1] of x[n] under every slot's
// rotated tail[slots, tpad-1], phase0[slots] (the phase of x[0]) and
// inc[slots]. x, tail, y and new_tail are complex64 (8-byte aligned).
// Returns the CUDA error code: cudaErrorInvalidValue for a problem the
// kernel does not take (no slot, decim < 1 or past MAX_DECIM, taps not a
// multiple of decim or past MAX_TAPS, an output count other than
// n / decim) and never launches it. Any number of taps and any decim up
// to those fit: the taps are taken in slabs that fit shared memory.
extern "C" int channel_bank(const void* x, const void* tail, int64_t n,
                            const float* h, const int64_t* phase0,
                            const int64_t* inc, void* y, void* new_tail,
                            int n_out, int tpad, int decim, int slots,
                            void* stream) {
  if (slots < 1 || decim < 1 || decim > bank::MAX_DECIM || tpad < decim ||
      tpad > bank::MAX_TAPS || tpad % decim || n < 0 || n_out < 0 ||
      (int64_t)n_out != n / decim)
    return (int)cudaErrorInvalidValue;
  const bank::Layout lay = bank::layout(n_out, tpad, decim, slots);
  if (lay.smem > pfir::MAX_SMEM || lay.groups > 65535)
    return (int)cudaErrorInvalidValue;
  // set on every launch that needs it (see polyphase_fir.cuh: launch_r)
  if (lay.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bank::channel_bank_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bank::Problem pr{
      static_cast<const float2*>(x), static_cast<const float2*>(tail), n, h,
      phase0, inc, static_cast<float2*>(y), static_cast<float2*>(new_tail),
      n_out, tpad, decim, slots};
  bank::channel_bank_kernel<<<dim3(lay.tiles + bank::GROUP, lay.groups),
                              bank::THREADS, (size_t)lay.smem,
                              static_cast<cudaStream_t>(stream)>>>(pr, lay);
  return (int)cudaGetLastError();
}
