// Soft-decision rate-1/2 Viterbi decoding on the card.
//
// Replaces viterbi_decode's add-compare-select scan and traceback scan
// (grbaz_tpu/ops/fec.py:244, scans at :268 and :276). One warp decodes one
// stream of T soft pairs over the 2^(K-1)-state trellis, K from 3 to 9.
//
// Layout. State t's predecessors are 2t mod ns and 2t+1 mod ns (the
// newest bit sits at the register's MSB), and states t and t + ns/2 share
// them. Lane l holds states l + 32i, i < S = ns/32 (for fewer than 32
// states, lane l holds state l mod ns and the lanes repeat one another).
// The two predecessors of states l + 32i and l + 32i + ns/2 sit in lanes
// 2l mod 32 and 2l+1 mod 32, slot 2i (lanes below 16) or 2i+1: four
// shuffles fetch them. The expected +-1 outputs of every branch come in
// as an argument (`exp` [ns, 2, 2]), so any pair of polynomials works.
//
// Arithmetic, bit-equal to the JAX scan on the CPU: branch metrics
// e0*r0 + e1*r1 (exact products, one rounding), candidates pm[pred] + bm,
// the second predecessor only where strictly greater (jnp.argmax takes the
// first of equal maxima), every step normalised by the warp's max.
//
// Decisions go to a global buffer as ballots, S words (ns/8 bytes) a step.
// The traceback starts from the lowest-index best final state and runs on
// one lane over chunks of decisions the warp first stages in shared
// memory; the soft pairs come in the same way.
//
// Bound: the step's dependent chain (four shuffles, two adds, a compare,
// five shuffles of the max reduction, a subtract: ~10 dependent shuffles),
// not memory (8 B in and 1 B out a pair, plus the decisions);
// `viterbi_chain_probe` times a step alone. Many streams or blocks a
// launch, and chunked decoding, are the follow-ups.
//
// Plain C interface (bound from Python with ctypes): returns the CUDA
// error code of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChunk = 1024;   // steps staged in shared memory at a time

// One add-compare-select step of the warp: pm normalised in place, the
// lane's choices in c. e[q] holds the expected outputs (+-1) of state q's
// two branches; src0/src1 are the lanes of the predecessors and hi picks
// their slot. Scalars and register arrays only: a first form that passed
// the lane's constants as a struct and its branch table by pointer ran
// each step ~12x slower on the H100.
template <int S>
__device__ __forceinline__ void step(float (&pm)[S], const float (&e)[S][4],
                                     int src0, int src1, bool hi, float r0,
                                     float r1, bool (&c)[S]) {
  float np[S];
#pragma unroll
  for (int i = 0; i < (S + 1) / 2; ++i) {
    float p0, p1;
    if (S == 1) {
      p0 = __shfl_sync(kFull, pm[0], src0);
      p1 = __shfl_sync(kFull, pm[0], src1);
    } else {
      const float a0 = __shfl_sync(kFull, pm[2 * i], src0);
      const float a1 = __shfl_sync(kFull, pm[2 * i + 1], src0);
      const float b0 = __shfl_sync(kFull, pm[2 * i], src1);
      const float b1 = __shfl_sync(kFull, pm[2 * i + 1], src1);
      p0 = hi ? a1 : a0;
      p1 = hi ? b1 : b0;
    }
    // states i and i + S/2 share these predecessors
#pragma unroll
    for (int h = 0; h < (S == 1 ? 1 : 2); ++h) {
      const int q = i + h * (S / 2);
      const float bm0 = __fadd_rn(__fmul_rn(e[q][0], r0),
                                  __fmul_rn(e[q][1], r1));
      const float bm1 = __fadd_rn(__fmul_rn(e[q][2], r0),
                                  __fmul_rn(e[q][3], r1));
      const float c0 = __fadd_rn(p0, bm0);
      const float c1 = __fadd_rn(p1, bm1);
      c[q] = c1 > c0;
      np[q] = c[q] ? c1 : c0;
    }
  }
  float m = np[0];
#pragma unroll
  for (int i = 1; i < S; ++i) m = fmaxf(m, np[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
#pragma unroll
  for (int i = 0; i < S; ++i) pm[i] = __fsub_rn(np[i], m);
}

// The lane's branch table and initial path metrics: state 0 at 0, the
// others at -1e9, as the JAX scan starts.
template <int S>
__device__ __forceinline__ void setup(float (&e)[S][4], float (&pm)[S],
                                      const float* exp, int ns, int lane) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int t = (lane + 32 * i) % ns;
#pragma unroll
    for (int j = 0; j < 4; ++j) e[i][j] = exp[4 * t + j];
    pm[i] = t == 0 ? 0.0f : -1e9f;
  }
}

template <int S>
__global__ void __launch_bounds__(32)
viterbi_kernel(const float2* __restrict__ metrics, int T,
               const float* __restrict__ exp, int k,
               uint8_t* __restrict__ bits, float* __restrict__ pm_out,
               uint32_t* __restrict__ dec) {
  __shared__ float2 sr[kChunk];
  __shared__ uint32_t sdec[kChunk * S];
  __shared__ uint8_t sbits[kChunk];
  const int lane = threadIdx.x;
  const int ns = 1 << (k - 1);
  const int src0 = (2 * lane) & 31, src1 = (2 * lane + 1) & 31;
  const bool hi = lane >= 16;
  float e[S][4], pm[S];
  setup<S>(e, pm, exp, ns, lane);

  // forward: add-compare-select over chunks of staged soft pairs
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int len = min(kChunk, T - t0);
    __syncwarp();
    for (int j = lane; j < len; j += 32) sr[j] = metrics[t0 + j];
    __syncwarp();
    for (int j = 0; j < len; ++j) {
      bool c[S];
      step<S>(pm, e, src0, src1, hi, sr[j].x, sr[j].y, c);
      uint32_t word[S];
#pragma unroll
      for (int i = 0; i < S; ++i) word[i] = __ballot_sync(kFull, c[i]);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < S; ++i)
          dec[static_cast<size_t>(t0 + j) * S + i] = word[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i)
    if (lane + 32 * i < ns) pm_out[lane + 32 * i] = pm[i];

  // the lowest-index state holding the final maximum
  float best = pm[0];
#pragma unroll
  for (int i = 1; i < S; ++i) best = fmaxf(best, pm[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kFull, best, off));
  int s = -1;
#pragma unroll
  for (int i = S - 1; i >= 0; --i) {
    uint32_t hit = __ballot_sync(kFull, pm[i] == best);
    if (ns < 32) hit &= (1u << ns) - 1u;
    if (hit) s = 32 * i + __ffs(hit) - 1;
  }
  // traceback on lane 0 over staged chunks of decisions, last chunk first
  __syncwarp();   // decisions written by other lanes are visible
  const int half = ns / 2, msb = k - 2;
  for (int hi_t = T; hi_t > 0; hi_t -= kChunk) {
    const int lo_t = max(hi_t - kChunk, 0);
    const int len = hi_t - lo_t;
    __syncwarp();
    for (int j = lane; j < len * S; j += 32)
      sdec[j] = dec[static_cast<size_t>(lo_t) * S + j];
    __syncwarp();
    if (lane == 0) {
      for (int j = len - 1; j >= 0; --j) {
        const uint32_t word = sdec[j * S + (s >> 5)];
        sbits[j] = static_cast<uint8_t>(s >> msb);
        s = 2 * (s & (half - 1)) + static_cast<int>((word >> (s & 31)) & 1u);
      }
    }
    __syncwarp();
    for (int j = lane; j < len; j += 32) bits[lo_t + j] = sbits[j];
  }
}

// `steps` add-compare-select steps of one warp at K = 7 alone, the soft
// pairs from shared memory, no decisions stored (timed for the decoder's
// chain bound)
__global__ void chain_probe_kernel(int steps, float* out) {
  __shared__ float2 sr[1024];
  const int lane = threadIdx.x;
  for (int j = lane; j < 1024; j += 32)
    sr[j] = make_float2((j * 37 % 11) - 5.0f, (j * 53 % 7) - 3.0f);
  __syncwarp();
  float e[2][4], pm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      e[i][q] = ((lane * 7 + i * 3 + q) % 5) < 2 ? -1.0f : 1.0f;
    pm[i] = lane + i ? -1e9f : 0.0f;
  }
  const int src0 = (2 * lane) & 31, src1 = (2 * lane + 1) & 31;
  unsigned acc = 0;
  for (int j = 0; j < steps; ++j) {
    bool c[2];
    step<2>(pm, e, src0, src1, lane >= 16, sr[j & 1023].x, sr[j & 1023].y,
            c);
    acc += c[0];
  }
  out[lane] = pm[0] + pm[1] + static_cast<float>(acc);
}

}  // namespace

extern "C" int viterbi(const float* metrics, int T, const float* exp, int k,
                       uint8_t* bits, float* pm_out, uint32_t* dec,
                       void* stream) {
  if (T < 1 || k < 3 || k > 9) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* m = reinterpret_cast<const float2*>(metrics);
  switch (k) {
    case 3: case 4: case 5: case 6:
      viterbi_kernel<1><<<1, 32, 0, s>>>(m, T, exp, k, bits, pm_out, dec);
      break;
    case 7:
      viterbi_kernel<2><<<1, 32, 0, s>>>(m, T, exp, k, bits, pm_out, dec);
      break;
    case 8:
      viterbi_kernel<4><<<1, 32, 0, s>>>(m, T, exp, k, bits, pm_out, dec);
      break;
    default:
      viterbi_kernel<8><<<1, 32, 0, s>>>(m, T, exp, k, bits, pm_out, dec);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viterbi_chain_probe(int steps, void* out, void* stream) {
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
