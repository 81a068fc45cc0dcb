// Host stand-in for the CUDA runtime header, for building the kernels of
// climateparameterizations_jl_tpu_torch/csrc/ with g++ and running them on the
// CPU (tests/test_torch_fused_rk4_host.py, tests/test_torch_gram_host.py,
// tests/test_torch_thomas_host.py).
// Each CUDA thread of a block is a std::thread; __syncthreads, named barriers
// (bar.sync), __shfl_xor_sync and mma.sync m16n8k16 are emulated with
// std::barrier, so a block runs its real schedule with real concurrency;
// cp.async copies synchronously. The build defines CSRC_HOST_EMULATION, which
// makes the sources skip their inline PTX and their launch functions.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim3 threadIdx, blockIdx;
inline HostDim3 gridDim;  // set before a grid's blocks run

// One block's synchronisation objects; host_emulation_run_block sets them up.
struct HostBlockSync {
  std::unique_ptr<std::barrier<>> block;
  std::unique_ptr<std::barrier<>> named[16];
  std::mutex named_mutex;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<float> shfl;                                 // 32 per warp
  std::vector<uint4> mma_a;                                // 32 per warp
  std::vector<uint32_t> mma_b;                             // 64 per warp
};
inline HostBlockSync host_sync;

inline void __syncthreads() { host_sync.block->arrive_and_wait(); }

inline void group_sync(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(host_sync.named_mutex);
    if (!host_sync.named[id]) host_sync.named[id] = std::make_unique<std::barrier<>>(n);
    b = host_sync.named[id].get();
  }
  b->arrive_and_wait();
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  host_sync.shfl[32 * w + lane] = v;
  host_sync.warp[w]->arrive_and_wait();
  const float r = host_sync.shfl[32 * w + (lane ^ lane_mask)];
  host_sync.warp[w]->arrive_and_wait();
  return r;
}

// rcp.approx.ftz + one Newton step gives 1/x rounded for a normal x whose
// reciprocal is normal, a signed zero where the reciprocal is subnormal
// (flushed, then kept by the Newton step), and NaN otherwise.
inline float rcp_rn(float x) {
  if (!std::isnormal(x)) return NAN;
  const float r = 1.0f / x;
  return std::isnormal(r) ? r : std::copysign(0.0f, x);
}
inline float sqrt_rn(float x) { return std::isnormal(x) && x > 0.0f ? std::sqrt(x) : NAN; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float exp2_approx(float x) { return std::exp2(x); }
inline float sqrt_approx(float x) { return std::sqrt(x); }

// cp.async as synchronous copies: a copy has landed when it returns, so the
// waits have nothing to wait for.
inline void copy_async(float* dst, const float* src) { *dst = *src; }
inline void copy_async16(float* dst, const float* src) { std::memcpy(dst, src, 16); }
inline void copy_async_commit() {}
template <int N>
inline void copy_async_wait_group() {}
inline void copy_async_wait() {}

inline void host_emulation_run_block(int threads, int block, void (*body)(void*), void* arg) {
  host_sync.block = std::make_unique<std::barrier<>>(threads);
  for (auto& b : host_sync.named) b.reset();
  const int warps = (threads + 31) / 32;
  host_sync.warp.clear();
  for (int w = 0; w < warps; ++w) host_sync.warp.push_back(std::make_unique<std::barrier<>>(32));
  host_sync.shfl.assign(32 * warps, 0.0f);
  host_sync.mma_a.assign(32 * warps, uint4{});
  host_sync.mma_b.assign(64 * warps, 0u);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([=] {
      threadIdx.x = t;
      blockIdx.x = block;
      body(arg);
    });
  }
  for (auto& th : pool) th.join();
}
