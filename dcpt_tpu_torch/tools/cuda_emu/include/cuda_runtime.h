// CPU emulation of the CUDA runtime subset that dcpt_tpu_torch/csrc uses (see
// ../build.py): a block's CUDA threads run as fibers (ucontext) on the calling
// thread, which switches between them only where one waits at a barrier
// (__syncthreads, or its warp's in a shuffle); blocks run one after another,
// shared memory poisoned with NaN.  A block whose live threads all wait at
// barriers that cannot complete stops the launch with an error.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <vector>
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
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) { return v > 232448 ? 1 : 0; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return 0; }
namespace emu {
inline int last_error = 0;
inline long long launches = 0;  // kernel launches that ran, for a test to count
// the running fiber's indices and block
inline dim3 tl_threadIdx, tl_blockIdx;
inline dim3 g_gridDim, g_blockDim;
inline float* tl_smem;
// a phase completes when every thread still taking part has arrived
struct Barrier {
  int expected = 0, arrived = 0;
  unsigned phase = 0;
  void arrive() {
    if (++arrived == expected) arrived = 0, ++phase;
  }
  void drop() {  // a thread's exit: it takes part in no later phase
    if (--expected == arrived && arrived) arrived = 0, ++phase;
  }
};
struct Fiber {
  ucontext_t ctx;
  Barrier* waiting = nullptr;
  unsigned phase = 0;
  bool done = false;
};
struct Block {
  Barrier bar;
  std::vector<Barrier> warp;
  std::vector<float> shfl;
  std::vector<Fiber> fibers;
  ucontext_t scheduler;
  int current = 0;
};
inline Block* tl_block;
inline std::function<void()>* g_body;
inline void wait(Barrier& b) {
  Block* blk = tl_block;
  Fiber& f = blk->fibers[blk->current];
  f.waiting = &b;
  f.phase = b.phase;
  b.arrive();
  swapcontext(&f.ctx, &blk->scheduler);
}
inline void fiber_main() {
  (*g_body)();
  Block* blk = tl_block;
  blk->fibers[blk->current].done = true;
  blk->bar.drop();
  blk->warp[blk->current / 32].drop();
}  // returns to uc_link, the scheduler
constexpr size_t kStack = 256 * 1024;
template <class F> struct Launcher {
  F f; dim3 g, b; size_t s;
  Launcher(F f_, dim3 g_, dim3 b_, size_t s_ = 0, cudaStream_t = nullptr) : f(f_), g(g_), b(b_), s(s_) {}
  template <class... A> void operator()(A... a) {
    if (b.x > 1024 || s > 232448 || g.y > 65535 || g.z > 65535) { last_error = 9; return; }
    ++launches;
    g_gridDim = g; g_blockDim = b;
    const int n = b.x;
    std::unique_ptr<char[]> stacks(new char[n * kStack]);
    std::function<void()> body = [&] { f(a...); };
    g_body = &body;
    for (unsigned z = 0; z < g.z; ++z)
      for (unsigned y = 0; y < g.y; ++y)
        for (unsigned x = 0; x < g.x; ++x) {
          Block blk;
          blk.bar.expected = n;
          blk.warp.resize((n + 31) / 32);
          for (int w = 0; w < (n + 31) / 32; ++w) blk.warp[w].expected = std::min(32, n - 32 * w);
          blk.shfl.assign(n, 0.f);
          blk.fibers.resize(n);
          std::vector<float> sm(s / 4 + 16, std::numeric_limits<float>::quiet_NaN());
          tl_block = &blk; tl_smem = sm.data(); tl_blockIdx = dim3(x, y, z);
          for (int t = 0; t < n; ++t) {
            ucontext_t& c = blk.fibers[t].ctx;
            getcontext(&c);
            c.uc_stack.ss_sp = stacks.get() + t * kStack;
            c.uc_stack.ss_size = kStack;
            c.uc_link = &blk.scheduler;
            makecontext(&c, fiber_main, 0);
          }
          for (int live = n; live;) {
            bool moved = false;
            for (int t = 0; t < n; ++t) {
              Fiber& fb = blk.fibers[t];
              if (fb.done || (fb.waiting && fb.waiting->phase == fb.phase)) continue;
              fb.waiting = nullptr;
              blk.current = t; tl_threadIdx = dim3(t);
              swapcontext(&blk.scheduler, &fb.ctx);
              moved = true;
              live -= fb.done;
            }
            if (!moved) { last_error = 4; return; }  // every live thread waits on a barrier that cannot complete
          }
        }
  }
};
}  // namespace emu
inline cudaError_t cudaGetLastError() { int e = emu::last_error; emu::last_error = 0; return e; }
// The library's kernel launches so far (a C entry of every emulated build)
extern "C" long long cuda_emu_launches() { return emu::launches; }
#define threadIdx (emu::tl_threadIdx)
#define blockIdx (emu::tl_blockIdx)
#define gridDim (emu::g_gridDim)
#define blockDim (emu::g_blockDim)
inline void __syncthreads() { emu::wait(emu::tl_block->bar); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  emu::Block* b = emu::tl_block;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  b->shfl[t] = v;
  emu::wait(b->warp[w]);
  const float r = b->shfl[w * 32 + (lane ^ m)];
  emu::wait(b->warp[w]);
  return r;
}
