// The ACARS decoder's FSM on the card.
//
// Replaces the per-sample lax.scan of ACARSDecoder.apply
// (grbaz_tpu/ops/decode.py:204, scan at :305). Each row of bit metrics
// [B, n] is one stream: one thread walks it serially. Searching, a 32-bit
// correlator of the air bits against the preamble 0x3FFE5C5C with a
// wrong-bit threshold; assembling, differential decoding, bytes LSB first
// with odd parity, bit reversal & 0x7F, and SOH/STX/ETX/DEL framing. The
// packet being assembled lives in the row's new state (252 floats, a copy
// of the carried one) and is written a byte at a time; a sync or a
// finished packet zeroes it. Finished packets are rows [n_bytes, parity
// errors, bytes...] at the thread's running count; the fifth and later
// of a call are added into row 3 in order, the JAX scatter-add's rule
// (sums of small integers in float32, exact).
//
// Bound: a serial walk, a few integer ops a sample while searching;
// `acars_chain_probe` times a step alone. Its state forgets (while
// searching only the last 32 air bits and a running XOR matter, and a
// packet ends within 252 bytes), so a speculative chunk-parallel form
// like csrc/peak_fsm.cu's is possible: the follow-up. The bytes (4n in,
// the packets out) bound nothing next to the chain.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch. State rows: int32 [9, B] = searching, shift
// (uint32 bits), prev_bit, cur_byte, bit_count, byte_count,
// parity_errors, etx_index, got_etx; packets [B, 252] float.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // a warp a block: rows spread over SMs
constexpr int kMaxPacket = 252;
constexpr int kMaxPkts = 4;
constexpr int kRow = 2 + kMaxPacket;
constexpr int kStxIndex = 13;
constexpr int kFields = 9;
constexpr uint32_t kPreamble = 0x3FFE5C5Cu;

struct AcarsState {
  int searching;
  uint32_t shift;
  int prev, cur, bits, bytes, parity, etx, got_etx;
};

__device__ __forceinline__ void zero_packet(float* pkt) {
  for (int j = 0; j < kMaxPacket; ++j) pkt[j] = 0.0f;
}

// One step of the JAX scan on air bit `bit`, the packet in `pkt`.
// Returns whether a packet finished (its length in `len`); the caller
// emits it from `pkt` and then calls finish().
__device__ __forceinline__ bool acars_step(AcarsState& s, uint32_t bit,
                                           int threshold, float* pkt,
                                           int& len) {
  s.shift = (s.shift << 1) | bit;
  const int dec = s.prev ^ static_cast<int>(bit);
  if (s.searching) {
    if (__popc(s.shift ^ kPreamble) <= threshold) {
      s.searching = 0;
      s.prev = 0;
      s.cur = 0;
      s.bits = 0;
      s.bytes = 0;
      s.parity = 0;
      s.etx = -1;
      s.got_etx = 0;
      zero_packet(pkt);
    } else {
      s.prev = dec;
    }
    return false;
  }
  s.prev = dec;
  const int cur = (s.cur << 1) | dec;
  if (s.bits + 1 != 8) {
    s.cur = cur;
    s.bits += 1;
    return false;
  }
  const int bc = s.bytes;
  const int val = static_cast<int>(__brev(static_cast<uint32_t>(cur)) >> 24) &
                  0x7F;
  pkt[min(max(bc, 0), kMaxPacket - 1)] = static_cast<float>(val);
  const bool is_etx = bc > kStxIndex && val == 0x03;
  const bool got_del = s.etx > 0 && bc == s.etx + 3 && val == 0x7F;
  if (is_etx) {
    s.got_etx = 1;
    if (s.etx < 0) s.etx = bc;
  }
  if ((__popc(static_cast<uint32_t>(cur)) & 1) == 0) s.parity += 1;
  s.cur = 0;
  s.bits = 0;
  if (got_del || bc + 1 >= kMaxPacket) {
    len = bc + 1;
    return true;
  }
  s.bytes = bc + 1;
  return false;
}

__device__ __forceinline__ void finish(AcarsState& s, float* pkt) {
  s.searching = 1;
  s.bytes = 0;
  s.parity = 0;
  s.etx = -1;
  s.got_etx = 0;
  zero_packet(pkt);
}

__global__ void __launch_bounds__(kThreads)
acars_kernel(const float* __restrict__ metrics, int n, int rows,
             const int* __restrict__ sin, const float* __restrict__ pkt_in,
             int threshold, float* __restrict__ out, int* __restrict__ n_pk,
             int* __restrict__ sout, float* __restrict__ pkt_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* x = metrics + static_cast<size_t>(r) * n;
  float* pkt = pkt_out + static_cast<size_t>(r) * kMaxPacket;
  float* rows_out = out + static_cast<size_t>(r) * kMaxPkts * kRow;
  for (int j = 0; j < kMaxPacket; ++j)
    pkt[j] = pkt_in[static_cast<size_t>(r) * kMaxPacket + j];
  for (int j = 0; j < kMaxPkts * kRow; ++j) rows_out[j] = 0.0f;
  AcarsState s;
  s.searching = sin[r];
  s.shift = static_cast<uint32_t>(sin[rows + r]);
  s.prev = sin[2 * rows + r];
  s.cur = sin[3 * rows + r];
  s.bits = sin[4 * rows + r];
  s.bytes = sin[5 * rows + r];
  s.parity = sin[6 * rows + r];
  s.etx = sin[7 * rows + r];
  s.got_etx = sin[8 * rows + r];
  int k = 0;
  for (int i = 0; i < n; ++i) {
    int len = 0;
    if (acars_step(s, x[i] > 0.0f ? 0u : 1u, threshold, pkt, len)) {
      float* row = rows_out + min(k, kMaxPkts - 1) * kRow;
      row[0] = __fadd_rn(row[0], static_cast<float>(len));
      row[1] = __fadd_rn(row[1], static_cast<float>(s.parity));
      for (int j = 0; j < kMaxPacket; ++j)
        row[2 + j] = __fadd_rn(row[2 + j], pkt[j]);
      ++k;
      finish(s, pkt);
    }
  }
  n_pk[r] = min(k, kMaxPkts);
  const int fields[kFields] = {s.searching, static_cast<int>(s.shift),
                               s.prev, s.cur, s.bits, s.bytes, s.parity,
                               s.etx, s.got_etx};
  for (int j = 0; j < kFields; ++j) sout[j * rows + r] = fields[j];
}

// `steps` steps of acars_step alone on one thread, air bits from a
// shared-memory table (searching, the walk's common case; timed for its
// chain bound)
__global__ void chain_probe_kernel(int steps, int* out) {
  __shared__ uint8_t tab[1024];
  __shared__ float pkt[kMaxPacket];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = static_cast<uint8_t>((i * 2654435761u) >> 31);
  __syncthreads();
  if (threadIdx.x != 0) return;
  AcarsState s{1, 0u, 0, 0, 0, 0, 0, -1, 0};
  int acc = 0;
  for (int i = 0; i < steps; ++i) {
    int len = 0;
    if (acars_step(s, tab[i & 1023], 2, pkt, len)) {
      acc += len;
      finish(s, pkt);
    }
  }
  out[0] = acc + static_cast<int>(s.shift) + s.prev;
}

}  // namespace

extern "C" int acars_fsm(const float* metrics, int n, int rows,
                         const int* sin, const float* pkt_in, int threshold,
                         float* out, int* n_pk, int* sout, float* pkt_out,
                         void* stream) {
  if (n < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  acars_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      metrics, n, rows, sin, pkt_in, threshold, out, n_pk, sout, pkt_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int acars_chain_probe(int steps, void* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
