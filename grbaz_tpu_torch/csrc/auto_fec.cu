// The served auto-FEC Block's work beside the Viterbi decoder
// (models/auto_fec.py AutoFECBlock), one launch each, with no host sync.
// Their plain versions (models/auto_fec.py pairs_plain, ber_plain,
// search_plain) launch ~5, ~7 and ~8 small PyTorch kernels a block; the
// arithmetic is microseconds, so the host's launches were the cost.
//
// pairs_kernel: the soft pairs of [carry, block] under the search state's
// transform. Pair i reads two of the four floats (re, im of symbols i and
// i + 1 of [carry, block], read in place) picked by the state's transform
// (its low 5 bits), each times its sign (+-1: exact): the conjugation,
// rotation and swap of a symbol, and the pair delay's one code bit from the
// symbol before. One thread a pair.
//
// ber_kernel: the block's BER. For each evaluated pair p (the block's,
// after the warm-up's `ov`, all but the last 16) the encoder's register
// holds the decoded bits p-k+1 .. p, the newest at its MSB; its two code
// bits (parities against the generators) are compared with the hard slice
// of the pair (> 0). One block of 1024 threads counts, a warp-shuffle and
// shared-memory reduction totals, and thread 0 writes the count in float32
// times the float32 reciprocal (one rounding), as the plain version does.
//
// search_kernel: FECSearch's step. The float32 BER is compared in float64
// with the two levels (a NaN is neither below nor above), and the next
// state read from the rule's table at state * 4 + 2 * above + below.
//
// Plain C interface (bound from Python with ctypes): each returns the CUDA
// error code of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairThreads = 256;
constexpr int kBerThreads = 1024;

__global__ void __launch_bounds__(kPairThreads)
pairs_kernel(const float* __restrict__ carry, int n_carry,
             const float* __restrict__ block, long long n,
             const int* __restrict__ state, const long long* __restrict__ pick,
             const float* __restrict__ sign, float* __restrict__ ext) {
  const long long pairs = n_carry - 1 + n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= pairs) return;
  const int s = *state & 31;  // the transform
  const long long in_carry = 2LL * n_carry;  // floats of the carry
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long q = 2 * i + pick[2 * s + j];
    const float v = q < in_carry ? carry[q] : block[q - in_carry];
    ext[2 * i + j] = v * sign[2 * s + j];
  }
}

__global__ void __launch_bounds__(kBerThreads)
ber_kernel(const uint8_t* __restrict__ bits, const float2* __restrict__ ext,
           int ov, long long n_eval, int k, unsigned poly0, unsigned poly1,
           float recip, float* __restrict__ ber) {
  __shared__ unsigned warp_sums[kBerThreads / 32];
  unsigned count = 0;
  for (long long i = threadIdx.x; i < n_eval; i += blockDim.x) {
    const long long p = ov + i;
    unsigned reg = 0;
    for (int m = 0; m < k; ++m)
      reg |= static_cast<unsigned>(bits[p - m]) << (k - 1 - m);
    const float2 e = ext[p];
    count += static_cast<unsigned>((__popc(reg & poly0) & 1) != (e.x > 0.f)) +
             static_cast<unsigned>((__popc(reg & poly1) & 1) != (e.y > 0.f));
  }
  for (int o = 16; o > 0; o >>= 1)
    count += __shfl_down_sync(0xFFFFFFFFu, count, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned c = threadIdx.x < (blockDim.x >> 5) ? warp_sums[threadIdx.x] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      c += __shfl_down_sync(0xFFFFFFFFu, c, o);
    if (threadIdx.x == 0) *ber = __fmul_rn(static_cast<float>(c), recip);
  }
}

__global__ void search_kernel(const int* __restrict__ state,
                              const float* __restrict__ ber,
                              const int* __restrict__ table, double threshold,
                              double unlock, int* __restrict__ out) {
  const double b = static_cast<double>(*ber);
  *out = table[*state * 4 + (b > unlock ? 2 : 0) + (b < threshold ? 1 : 0)];
}

}  // namespace

// ext [n_carry - 1 + n, 2] float32: the pairs of [carry (n_carry complex64),
// block (n complex64)] under the transform *state & 31; pick [32, 2] int64
// and sign [32, 2] float32 by transform.
extern "C" int fec_pairs(const void* carry, int n_carry, const void* block,
                         long long n, const int* state, const long long* pick,
                         const float* sign, float* ext, void* stream) {
  if (n_carry < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = n_carry - 1 + n;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kPairThreads - 1) / kPairThreads);
  pairs_kernel<<<blocks, kPairThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(carry), n_carry,
      static_cast<const float*>(block), n, state, pick, sign, ext);
  return static_cast<int>(cudaGetLastError());
}

// ber [1] float32 of the decoded bits [ov + n_eval + 16] uint8 against the
// pairs ext [ov + n_eval + 16, 2] float32; rate 1/2, constraint length k.
extern "C" int fec_ber(const uint8_t* bits, const float* ext, int ov,
                       long long n_eval, int k, unsigned poly0,
                       unsigned poly1, float recip, float* ber, void* stream) {
  if (k < 1 || k > 32 || ov < k - 1 || n_eval < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ber_kernel<<<1, kBerThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bits, reinterpret_cast<const float2*>(ext), ov, n_eval, k, poly0, poly1,
      recip, ber);
  return static_cast<int>(cudaGetLastError());
}

// out [1] int32: the search state after a block of BER *ber from *state.
extern "C" int fec_search(const int* state, const float* ber,
                          const int* table, double threshold, double unlock,
                          int* out, void* stream) {
  search_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      state, ber, table, threshold, unlock, out);
  return static_cast<int>(cudaGetLastError());
}
