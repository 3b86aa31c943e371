// CPU emulation of the CUDA pieces csrc/channel_bank.cu, fastrak_fsm.cu,
// vrr_walk.cu and the decoders' kernels (viterbi.cu, acars_fsm.cu,
// manchester_fsm.cu, dpll_walk.cu, block_scan.cuh) use, for tools/cpu_shim/bank_check.py,
// fsm_check.py and decode_check.py: one
// std::thread a CUDA thread, blocks in turn, shared memory filled with NaN
// before each block.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#include <mutex>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
#define __shared__ static  // blocks run in turn: one copy serves each

struct float2 { float x, y; };
struct float3 { float x, y, z; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float3 make_float3(float a, float b, float c) { return {a, b, c}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline unsigned char* shim_smem_ptr;
inline unsigned char* shim_smem_ptr_fwd() { return shim_smem_ptr; }

struct ShimBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<float> slots;  // per thread 16 floats
  std::vector<std::unique_ptr<std::barrier<>>> gbar;  // warpgroups
};
inline ShimBlock* shim_blk;
inline thread_local int shim_tid;

inline void __syncthreads() { shim_blk->bar->arrive_and_wait(); }
inline void shim_warp_sync() { shim_blk->wbar[shim_tid / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  float* s = shim_blk->slots.data();
  s[shim_tid * 16] = v;
  shim_warp_sync();
  float r = s[(shim_tid ^ off) * 16];
  shim_warp_sync();
  return r;
}
// any 4-byte value from lane `src` of the warp (the slot array carries it)
template <class T>
inline T shim_from_lane(T v, int src) {
  static_assert(sizeof(T) <= 64, "a slot holds 64 bytes");
  float* s = shim_blk->slots.data();
  std::memcpy(&s[shim_tid * 16], &v, sizeof(T));
  shim_warp_sync();
  T r;
  std::memcpy(&r, &s[((shim_tid & ~31) + (src & 31)) * 16], sizeof(T));
  shim_warp_sync();
  return r;
}
inline long long __shfl_xor_sync(unsigned, long long v, int off) {
  return shim_from_lane(v, (shim_tid & 31) ^ off);
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int off) {
  return shim_from_lane(v, (shim_tid & 31) ^ off);
}
inline std::mutex shim_atomic_mutex;
inline long long atomicMax(long long* a, long long v) {
  std::lock_guard<std::mutex> g(shim_atomic_mutex);
  long long old = *a;
  if (v > old) *a = v;
  return old;
}
inline long long atomicMin(long long* a, long long v) {
  std::lock_guard<std::mutex> g(shim_atomic_mutex);
  long long old = *a;
  if (v < old) *a = v;
  return old;
}
inline int atomicAdd(int* a, int v) {
  std::lock_guard<std::mutex> g(shim_atomic_mutex);
  int old = *a;
  *a = old + v;
  return old;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) { return shim_from_lane(v, src); }
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int lane = shim_tid & 31;
  return shim_from_lane(v, lane >= (int)d ? lane - (int)d : lane);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  float* s = shim_blk->slots.data();
  const int base = shim_tid & ~31;
  const int v = p ? 1 : 0;
  std::memcpy(&s[shim_tid * 16], &v, 4);
  shim_warp_sync();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) {
    int b;
    std::memcpy(&b, &s[(base + l) * 16], 4);
    m |= (b ? 1u : 0u) << l;
  }
  shim_warp_sync();
  return m;
}
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp_sync(); }
// redux.sync: every lane of the warp gets the reduction of all 32 values
template <class T, class F>
inline T shim_warp_reduce(T v, F f) {
  T r = v;
  for (int l = 0; l < 32; ++l) {
    const T o = shim_from_lane(v, l);
    if (l) r = f(r, o); else r = o;
  }
  return r;
}
inline int __reduce_max_sync(unsigned, int v) {
  return shim_warp_reduce(v, [](int a, int b) { return a > b ? a : b; });
}
inline int __reduce_add_sync(unsigned, int v) {
  return shim_warp_reduce(v, [](int a, int b) { return a + b; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return shim_warp_reduce(v, [](int a, int b) { return a < b ? a : b; });
}
inline int __ffs(unsigned v) { return v ? __builtin_ctz(v) + 1 : 0; }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
inline float __int2float_rn(int v) { return (float)v; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline unsigned __vcmpne4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int j = 0; j < 4; ++j)
    if (((a >> (8 * j)) & 0xffu) != ((b >> (8 * j)) & 0xffu)) r |= 0xffu << (8 * j);
  return r;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __popcll(unsigned long long v) { return __builtin_popcountll(v); }
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
  return r;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __float2int_rz(float v) { return (int)v; }
inline unsigned __float2uint_rz(float v) {
  return v <= 0.f ? 0u : v >= 4294967296.f ? 0xffffffffu : (unsigned)v;
}
using std::max;
using std::min;
inline float __uint2float_rn(uint32_t v) { return (float)v; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline void sincosf(float a, float* s, float* c) { *s = std::sin(a); *c = std::cos(a); }
inline unsigned char* shim_smem_ptr_fwd();
inline unsigned __cvta_generic_to_shared(const void* p) { return (unsigned)((const unsigned char*)p - shim_smem_ptr_fwd()); }

// TF32, round to nearest, ties away
inline float shim_tf32(float v) {
  uint32_t b = __float_as_uint(v);
  b = (b + 0x1000u) & 0xFFFFE000u;
  return __uint_as_float(b);
}
template <class K, class... Args>
void shim_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, Args... args) {
  blockDim = block; gridDim = grid;
  std::vector<unsigned char> mem(smem + 64);
  int nthreads = block.x;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      ShimBlock blk;
      blk.bar = std::make_unique<std::barrier<>>(nthreads);
      for (int w = 0; w < nthreads / 32; ++w) blk.wbar.push_back(std::make_unique<std::barrier<>>(32));
      for (int w = 0; w < (nthreads + 127) / 128; ++w) blk.gbar.push_back(std::make_unique<std::barrier<>>(std::min(128, nthreads - 128 * w)));
      blk.slots.assign(nthreads * 16, 0.f);
      shim_blk = &blk;
      // poison shared memory with NaN
      for (size_t i = 0; i + 4 <= mem.size(); i += 4) { float nanv = NAN; std::memcpy(&mem[i], &nanv, 4); }
      shim_smem_ptr = mem.data();
      std::vector<std::thread> ts;
      for (int t = 0; t < nthreads; ++t)
        ts.emplace_back([&, t, bx, by] {
          threadIdx = dim3(t, 0, 0); blockIdx = dim3(bx, by, 0); shim_tid = t;
          kernel(args...);
          // a returning thread must keep serving barriers: drop out
          shim_blk->bar->arrive_and_drop();
          shim_blk->wbar[t / 32]->arrive_and_drop();
          shim_blk->gbar[t / 128]->arrive_and_drop();
        });
      for (auto& th : ts) th.join();
    }
}

// wgmma m64n32k8 tf32, A in registers (mma.sync A fragment per warp), B by
// descriptor: element (k, n) at start + (n/8)*SBO + (k/4)*LBO + (n%8)*16 + (k%4)*4
inline void shim_wgmma(float (&d)[16], const float (&a)[4], uint64_t desc) {
  float* s = shim_blk->slots.data();
  float* me = s + shim_tid * 16;
  for (int e = 0; e < 4; ++e) me[e] = a[e];
  auto gsync = [] { shim_blk->gbar[shim_tid / 128]->arrive_and_wait(); };
  gsync();
  const unsigned start = (unsigned)(desc & 0x3FFF) << 4;
  const unsigned lbo = (unsigned)((desc >> 16) & 0x3FFF) << 4;
  const unsigned sbo = (unsigned)((desc >> 32) & 0x3FFF) << 4;
  const int g0 = (shim_tid / 128) * 128, wi = (shim_tid % 128) / 32, lane = shim_tid % 32, g = lane / 4, q = lane % 4;
  auto A = [&](int r, int k) {  // r in 0..63
    int w = r / 16, rr = r % 16, gg = rr % 8, hi = rr / 8, qq = k % 4, kh = k / 4;
    return s[(g0 + w * 32 + gg * 4 + qq) * 16 + (kh * 2 + hi)]; };
  auto B = [&](int k, int n) {
    float v; std::memcpy(&v, shim_smem_ptr + start + (n / 8) * sbo + (k / 4) * lbo + (n % 8) * 16 + (k % 4) * 4, 4); return v; };
  float out[16];
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 4; ++e) {
      int r = wi * 16 + g + 8 * (e / 2), n = 8 * j + 2 * q + (e % 2);
      float acc = d[4 * j + e];
      for (int k = 0; k < 8; ++k) acc += shim_tf32(A(r, k)) * shim_tf32(B(k, n));
      out[4 * j + e] = acc;
    }
  gsync();
  for (int e = 0; e < 16; ++e) d[e] = out[e];
}
