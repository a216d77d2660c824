// CPU emulation of the CUDA runtime subset that dcpt_tpu_torch/csrc uses (see
// ../build.py): one OS thread per CUDA thread, std::barrier for __syncthreads
// and warp shuffles, blocks run one after another, shared memory poisoned with NaN.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <limits>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) { return v > 232448 ? 1 : 0; }
namespace emu {
inline int last_error = 0;
inline thread_local dim3 tl_threadIdx, tl_blockIdx;
inline dim3 g_gridDim, g_blockDim;
inline thread_local float* tl_smem;
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<float> shfl;
};
inline thread_local Block* tl_block;
template <class F> struct Launcher {
  F f; dim3 g, b; size_t s;
  Launcher(F f_, dim3 g_, dim3 b_, size_t s_ = 0, cudaStream_t = nullptr) : f(f_), g(g_), b(b_), s(s_) {}
  template <class... A> void operator()(A... a) {
    if (b.x > 1024 || s > 232448) { last_error = 9; return; }
    g_gridDim = g; g_blockDim = b;
    const int n = b.x;
    for (unsigned z = 0; z < g.z; ++z)
      for (unsigned y = 0; y < g.y; ++y)
        for (unsigned x = 0; x < g.x; ++x) {
          Block blk;
          blk.bar = std::make_unique<std::barrier<>>(n);
          for (int w = 0; w < (n + 31) / 32; ++w) blk.warp.push_back(std::make_unique<std::barrier<>>(std::min(32, n - 32 * w)));
          blk.shfl.assign(n, 0.f);
          std::vector<float> sm(s / 4 + 16, std::numeric_limits<float>::quiet_NaN());
          std::vector<std::thread> ts;
          for (int t = 0; t < n; ++t)
            ts.emplace_back([&, t] {
              tl_threadIdx = dim3(t); tl_blockIdx = dim3(x, y, z); tl_smem = sm.data(); tl_block = &blk;
              f(a...);
              blk.bar->arrive_and_drop();
              blk.warp[t / 32]->arrive_and_drop();
            });
          for (auto& t : ts) t.join();
        }
  }
};
}  // namespace emu
inline cudaError_t cudaGetLastError() { int e = emu::last_error; emu::last_error = 0; return e; }
#define threadIdx (emu::tl_threadIdx)
#define blockIdx (emu::tl_blockIdx)
#define gridDim (emu::g_gridDim)
#define blockDim (emu::g_blockDim)
inline void __syncthreads() { emu::tl_block->bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  emu::Block* b = emu::tl_block;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  b->shfl[t] = v;
  b->warp[w]->arrive_and_wait();
  const float r = b->shfl[w * 32 + (lane ^ m)];
  b->warp[w]->arrive_and_wait();
  return r;
}
