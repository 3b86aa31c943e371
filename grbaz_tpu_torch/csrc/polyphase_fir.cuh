// Polyphase decimating FIR core shared by the port's FIR kernels.
//
//     y[k] = sum_{t < tpad} g[t] * s(k*decim + t - (tpad-1))
//
// with the sample s(i) = hist[tpad + i] for i < 0 (the carried history),
// body[i] for 0 <= i < n and 0 past the block's end. A kernel picks the
// sample type S (float or float2), the tap policy (real taps copied from
// h, or complex taps built from h and the LO increment), the epilogue
// (store, or rotate by the output's LO phase, then store) and the row
// policy: one stream (Contiguous), or `rows` streams interleaved sample
// by sample (Interleaved: sample i of row r at [i * rows + r] in hist,
// body and y, as an antenna array delivers its snapshots), every row
// filtered with the same taps and LO.
//
// Design (H100). The host picks the Geometry (threads, R, split) in
// grbaz_tpu_torch/ops/cuda/tiling.py; every size that follows from it
// (tile, rows, plane stride, shared memory, grid) is worked out here, by
// layout(), so no geometry can make the kernel reach past its shared
// memory. tiling.py mirrors layout() only to choose a geometry that fits.
//
// * Interleaved rows: every (tile, row) pair has its own block, the rows
//   of one tile in neighbouring blocks, so that the tile's span of the
//   interleaved block is read from device memory about once and the
//   other rows' reads of the same sectors hit L2. A row's copies are
//   rows * sizeof(S) bytes apart, one sector each: the staging moves
//   `rows` times the sectors of a contiguous row, from L2.
// * A tile of TILE outputs needs ROWS = TILE + mp - 1 polyphase rows of
//   decim samples (mp: the taps of one phase, tpad/decim, padded with
//   zero taps to a multiple of R). Every tile has its own block, and at
//   the main path's shapes every block is resident at once. A ring of
//   tiles on persistent blocks, which would overlap one tile's copies
//   with another's dot, measured slower at these shapes (PERF.md): with
//   ~1000 channel outputs per SM it leaves each SM too few warps to hide
//   their latency.
// * Copies are cp.async of one sample (4 or 8 bytes), all of a tile's
//   issued before any is waited on, the taps built while they fly. Not
//   TMA bulk copies: the dot wants the samples PHASE-PLANAR (plane p
//   holds the p-th sample of every row), with a padding slot after every
//   R rows, and a bulk copy can only land the raw interleaved order.
//   cp.async's src-size operand zero-fills samples past the block's end,
//   and each sample picks its own source (history or block), so the
//   first tile straddles the carried tail and the block with no
//   alignment rule; interior tiles take a loop with no per-sample branch.
// * A lane group of `split` lanes owns R consecutive outputs; lane s of
//   the group sums the phases p = s, s + split, ...; the group's partial
//   sums meet through __shfl_xor_sync. Per phase the lane slides a
//   register window of R samples down the plane in whole R-step chunks
//   with no guard: each step loads ONE new sample and one tap and does R
//   multiply-adds, so a tap is read once per R outputs.
// * Bank conflicts: row r of a plane sits at slot r + r/R (R even) or r
//   (R odd), so lane groups are Q = R+1 (or R) slots apart, an odd
//   stride. The plane stride is P = (W/split)*Q mod W past the last row
//   (W = samples one wavefront serves: 32 floats or 16 float2), so the
//   `split` lanes of a group (planes s*P apart) and the groups of a warp
//   hit distinct banks: a float2 window load is 2 wavefronts per warp, a
//   float one 1. The taps lie phase-major with a phase stride of 2 mod 4,
//   so the `split` phases a warp reads at once are 1 wavefront.
//
//   One pass of a warp over one phase per lane (float2 samples) issues
//   mp + R - 1 window loads (2 wavefronts each) and mp tap loads (1 each)
//   for R*M useful output-taps per lane: (2*(mp + R - 1) + mp) / (R*M)
//   wavefronts per 32 output-taps. At the WBFM channel shape (M = 13,
//   mp = 16, R = 8) that is 62 / 104 = 0.60, where the one-output-per-
//   thread kernels this replaces spent 3 (a 2-wavefront sample load and
//   a tap broadcast per tap).
// * Lane s stores the group's outputs s, s + split, ..., picked from the
//   registers by selects, so the whole warp runs the epilogue at once.
// * Sums are float32 FMAs with separate real and imaginary accumulators:
//   no TF32 and no tensor cores (a 10-bit product mantissa would miss
//   the port's 1e-5 bar, and the FIR is below the card's f32 balance of
//   ~20 FLOP/byte anyway).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pfir {

constexpr float TO_RAD = 0x1.921fb6p-30f;  // float32(2pi / 2^32)
constexpr int MAX_THREADS = 256;
constexpr int64_t MAX_SMEM = 232448;       // 227 KB, the most a block may use
constexpr int WAVEFRONT_BYTES = 128;       // 32 banks x 4 bytes a pass

// Launch geometry, chosen on the host (ops/cuda/tiling.py: Geometry);
// the field order is the ctypes structure's.
struct Geometry {
  int threads;  // per block, a multiple of 32, <= MAX_THREADS
  int r;        // consecutive outputs per lane group (1, 2, 4 or 8)
  int split;    // lanes per group, a power of two <= 32
};

struct Problem {
  const void* hist;  // sample i < 0 of row r is hist[(tpad + i) * rows + r]
  const void* body;  // sample 0 <= i < n of row r is body[i * rows + r]
  int64_t n;
  const float* h;          // real reversed taps, tpad of them
  const int64_t* phase0;   // 0-d uint32 values, read on the card
  const int64_t* inc;
  void* y;                 // output k of row r is y[k * rows + r]
  int n_out, tpad, decim;
  int rows = 1;  // streams interleaved in hist, body, y (Interleaved only);
                 // not the polyphase rows of a tile (Layout::rows)
};

// row policies: one stream, or `rows` streams interleaved sample by sample
struct Contiguous {
  static constexpr bool kRows = false;
};
struct Interleaved {
  static constexpr bool kRows = true;
};

// ---------------------------------------------------------------------------
// layout: every size that follows from a geometry and a problem
// ---------------------------------------------------------------------------

// slot of row c of a lane group's window (rows counted from the group's
// first row, which is a multiple of r): a padding slot after every r rows
// when r is even
__host__ __device__ constexpr int row_slot(int c, int r) {
  return (r % 2 == 0) ? c + c / r : c;
}
__host__ __device__ constexpr int group_stride(int r) {
  return (r % 2 == 0) ? r + 1 : r;
}
// phase stride of the taps: mp rounded up to 2 mod 4
__host__ __device__ constexpr int tap_stride(int mp) {
  return mp + ((2 - mp) % 4 + 4) % 4;
}

struct Layout {
  int split;  // lanes per group
  int tile;   // outputs per block
  int mp;     // taps per phase, padded to a multiple of R
  int ts;     // phase stride of the taps
  int rows;   // polyphase rows a tile reads
  int plane;  // plane stride in samples
  int grid;   // blocks: one per tile and row
  int64_t smem;  // dynamic shared-memory bytes
};

inline Layout layout(const Problem& pr, const Geometry& geo, int sample_bytes,
                     int tap_bytes) {
  Layout l;
  l.split = geo.split;
  l.tile = geo.threads / geo.split * geo.r;
  l.mp = (pr.tpad / pr.decim + geo.r - 1) / geo.r * geo.r;
  l.ts = tap_stride(l.mp);
  l.rows = l.tile + l.mp - 1;
  const int w = WAVEFRONT_BYTES / sample_bytes;
  const int want = (w / geo.split) * group_stride(geo.r) % w;
  const int last = row_slot(l.rows - 1, geo.r) + 1;
  l.plane = last + ((want - last) % w + w) % w;
  l.grid = (pr.n_out + l.tile - 1) / l.tile * pr.rows;
  l.smem = (int64_t)pr.decim * l.plane * sample_bytes +
           (int64_t)pr.decim * l.ts * tap_bytes;
  return l;
}

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}

__device__ __forceinline__ void mac(float& a, float g, float x) {
  a = fmaf(g, x, a);
}
__device__ __forceinline__ void mac(float2& a, float g, float2 x) {
  a.x = fmaf(g, x.x, a.x);
  a.y = fmaf(g, x.y, a.y);
}
__device__ __forceinline__ void mac(float2& a, float2 g, float2 x) {
  a.x = fmaf(g.x, x.x, a.x);
  a.x = fmaf(-g.y, x.y, a.x);
  a.y = fmaf(g.x, x.y, a.y);
  a.y = fmaf(g.y, x.x, a.y);
}

__device__ __forceinline__ float shfl_add(float v, int off) {
  return v + __shfl_xor_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ float2 shfl_add(float2 v, int off) {
  return make_float2(shfl_add(v.x, off), shfl_add(v.y, off));
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(s), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}
// wait for every cp.async this thread issued
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// tap policies: tap t = m*decim + p of the tpad real reversed taps h, laid
// out PHASE-MAJOR in shared memory, gs[p*ts + m], with m padded to mp (a
// multiple of R) by zero taps, so the dot runs whole R-step chunks with
// no guard and immediate tap offsets. The phase stride ts >= mp is 2 mod
// 4, so the `split` lanes of a group, which read `split` phases at once,
// hit distinct banks (and pairs of taps stay 8-byte aligned)
// ---------------------------------------------------------------------------

template <class Tap>
__device__ void build_taps(typename Tap::G* gs, const Problem& pr, int ts,
                           const Tap& tap) {
  const int D = pr.decim, M = pr.tpad / D;
  for (int idx = threadIdx.x; idx < D * ts; idx += blockDim.x) {
    const int p = idx / ts, m = idx - p * ts;
    gs[idx] = m < M ? tap(m * D + p) : zero<typename Tap::G>();
  }
}

struct RealTaps {
  using G = float;
  const float* h;
  __device__ explicit RealTaps(const Problem& pr) : h(pr.h) {}
  __device__ float operator()(int t) const { return h[t]; }
};

// g[t] = h[t] * exp(j*ang(u32((t - (tpad-1)) * inc))), the angle rounded
// as grbaz_tpu_torch/ops/exact.py: turns_u32_to_radians; accurate sincosf
struct RotatedTaps {
  using G = float2;
  const float* h;
  uint32_t inc;
  int tpad;
  __device__ explicit RotatedTaps(const Problem& pr)
      : h(pr.h), inc((uint32_t)(*pr.inc)), tpad(pr.tpad) {}
  __device__ float2 operator()(int t) const {
    const uint32_t rel = (uint32_t)(t - (tpad - 1)) * inc;
    float s, c;
    sincosf(__uint2float_rn(rel) * TO_RAD, &s, &c);
    return make_float2(h[t] * c, h[t] * s);
  }
};

// ---------------------------------------------------------------------------
// epilogues
// ---------------------------------------------------------------------------

// store(k, at, v): output k of its row, at y[at]
struct StorePlain {
  void* y;
  __device__ explicit StorePlain(const Problem& pr) : y(pr.y) {}
  template <typename S>
  __device__ void store(int64_t, int64_t at, S v) const {
    static_cast<S*>(y)[at] = v;
  }
};

// v with +0 for a zero of either sign (every other value exact): a zero
// output rotated by a cosine < 0 is -0, whose sign atan2 downstream reads
// (atan2(+0, -0) = pi), where the plain versions give +0
__device__ __forceinline__ float2 plus_zeros(float2 v) {
  return make_float2(__fadd_rn(v.x, 0.f), __fadd_rn(v.y, 0.f));
}

// y[k] = lo(phase0 + k*decim*inc) * v: one accurate sincosf per output
struct StoreRotated {
  float2* y;
  uint32_t phase0, dinc;
  __device__ explicit StoreRotated(const Problem& pr)
      : y(static_cast<float2*>(pr.y)), phase0((uint32_t)(*pr.phase0)),
        dinc((uint32_t)pr.decim * (uint32_t)(*pr.inc)) {}
  __device__ void store(int64_t k, int64_t at, float2 v) const {
    const uint32_t ph = phase0 + (uint32_t)k * dinc;
    float s, c;
    sincosf(__uint2float_rn(ph) * TO_RAD, &s, &c);
    y[at] = plus_zeros(make_float2(c * v.x - s * v.y, c * v.y + s * v.x));
  }
};

// ---------------------------------------------------------------------------
// the kernel: block b computes outputs [t*tile, (t+1)*tile) of row r, with
// (t, r) = (b, 0) for one stream and (b / rows, b % rows) for interleaved
// rows
// ---------------------------------------------------------------------------

template <typename S, int R, class Taps, class Epi, class Rows>
__global__ void __launch_bounds__(MAX_THREADS)
polyphase_fir_kernel(Problem pr, Layout lay) {
  using G = typename Taps::G;
  // the taps follow the planes with no padding
  static_assert(sizeof(G) <= sizeof(S), "taps wider than samples");
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = pr.decim, P = lay.plane, split = lay.split;
  S* xs = reinterpret_cast<S*>(smem);
  G* gs = reinterpret_cast<G*>(xs + D * P);
  // one stream: row 0, stride 1, so the addressing is a contiguous row's
  const int row = Rows::kRows ? (int)(blockIdx.x % pr.rows) : 0;
  const int64_t st = Rows::kRows ? pr.rows : 1;
  const S* hist = static_cast<const S*>(pr.hist) + row;
  const S* body = static_cast<const S*>(pr.body) + row;
  const int tid = threadIdx.x;
  const int64_t k0 =
      (int64_t)(Rows::kRows ? blockIdx.x / pr.rows : blockIdx.x) * lay.tile;

  // stage the tile: sample j of the span is row j / D, phase j % D, at
  // xs[p*P + row_slot(row)]
  {
    const int64_t i0 = k0 * D - (pr.tpad - 1);
    const int total = lay.rows * D;
    const int dr = blockDim.x / D, dp = blockDim.x % D;
    int r = tid / D, p = tid % D;
    if (dp == 0 && dr % R == 0 && i0 >= 0 && i0 + total <= pr.n) {
      // inside the block, with a stride of whole window groups: every
      // copy of this lane lands in one plane, a constant step apart
      S* d = xs + p * P + row_slot(r, R);
      const S* src = body + (i0 + tid) * st;
      const int step = row_slot(dr, R);
      const int64_t src_step = blockDim.x * st;
#pragma unroll 4
      for (int j = tid; j < total; j += blockDim.x) {
        cp_async<sizeof(S)>(d, src, sizeof(S));
        d += step;
        src += src_step;
      }
    } else {
      for (int j = tid; j < total; j += blockDim.x) {
        const int64_t i = i0 + j;
        const S* src = body;
        int bytes = 0;
        if (i < 0) {
          src = hist + (pr.tpad + i) * st;
          bytes = sizeof(S);
        } else if (i < pr.n) {
          src = body + i * st;
          bytes = sizeof(S);
        }
        cp_async<sizeof(S)>(xs + p * P + row_slot(r, R), src, bytes);
        r += dr;
        p += dp;
        if (p >= D) {
          p -= D;
          ++r;
        }
      }
    }
  }
  build_taps(gs, pr, lay.ts, Taps(pr));  // while the copies fly
  cp_async_wait_all();
  __syncthreads();

  // the tap dot
  const int g = tid / split, s = tid % split;
  const S* xg = xs + g * group_stride(R);
  S acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = zero<S>();
  for (int p = s; p < D; p += split) {
    const S* pl = xg + p * P;
    const G* gp = gs + p * lay.ts;
    S w[R];
#pragma unroll
    for (int c = 0; c < R - 1; ++c) w[c] = pl[row_slot(c, R)];
    // chunk m0 of R steps: rows m0 .. m0 + 2R - 2 of the window start at
    // slot row_slot(m0) = m0 + m0/R (R even), so every offset below is
    // an immediate
    for (int m0 = 0; m0 < lay.mp; m0 += R) {
      const S* pc = pl + row_slot(m0, R);
      const G* gc = gp + m0;
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        w[(jj + R - 1) % R] = pc[row_slot(jj + R - 1, R)];
        const G gm = gc[jj];
#pragma unroll
        for (int i = 0; i < R; ++i) mac(acc[i], gm, w[(jj + i) % R]);
      }
    }
  }
  for (int off = split >> 1; off; off >>= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = shfl_add(acc[i], off);
  }

  // lane s stores the group's outputs s, s + split, ...: each picked from
  // the registers by selects, so every lane runs the epilogue (a sincosf
  // in B1's) at once
  const Epi epi(pr);
  const int64_t kg = k0 + (int64_t)g * R;
  for (int i0 = s; i0 < R; i0 += split) {
    S v = acc[0];
#pragma unroll
    for (int i = 1; i < R; ++i) v = i == i0 ? acc[i] : v;
    if (kg + i0 < pr.n_out) epi.store(kg + i0, (kg + i0) * st + row, v);
  }
}

template <typename S, int R, class Taps, class Epi, class Rows>
int launch_r(const Problem& pr, const Layout& lay, int threads,
             cudaStream_t stream) {
  // set on every such launch: a static "already set" flag would be one
  // object for every library that instantiates this kernel
  if (lay.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        polyphase_fir_kernel<S, R, Taps, Epi, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
    if (e != cudaSuccess) return (int)e;
  }
  polyphase_fir_kernel<S, R, Taps, Epi, Rows>
      <<<lay.grid, threads, (size_t)lay.smem, stream>>>(pr, lay);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns the CUDA error code, cudaErrorInvalidValue
// for a geometry or problem the kernel does not take or a layout that
// does not fit in shared memory.
template <typename S, class Taps, class Epi, class Rows = Contiguous>
int launch(const Problem& pr, const Geometry& geo, cudaStream_t stream) {
  if (pr.n_out <= 0) return 0;
  // every field is checked before layout() divides by it
  if (geo.threads <= 0 || geo.threads > MAX_THREADS || geo.threads % 32 ||
      geo.split <= 0 || (geo.split & (geo.split - 1)) || geo.split > 32 ||
      geo.r <= 0 || (geo.r & (geo.r - 1)) || geo.r > 8 ||
      pr.decim <= 0 || pr.tpad < pr.decim || pr.tpad % pr.decim ||
      pr.rows <= 0 || (!Rows::kRows && pr.rows != 1))
    return (int)cudaErrorInvalidValue;
  const Layout lay =
      layout(pr, geo, sizeof(S), sizeof(typename Taps::G));
  if (lay.smem > MAX_SMEM ||
      (int64_t)((pr.n_out + lay.tile - 1) / lay.tile) * pr.rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  switch (geo.r) {
    case 1: return launch_r<S, 1, Taps, Epi, Rows>(pr, lay, geo.threads,
                                                   stream);
    case 2: return launch_r<S, 2, Taps, Epi, Rows>(pr, lay, geo.threads,
                                                   stream);
    case 4: return launch_r<S, 4, Taps, Epi, Rows>(pr, lay, geo.threads,
                                                   stream);
    case 8: return launch_r<S, 8, Taps, Epi, Rows>(pr, lay, geo.threads,
                                                   stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pfir
