// CPU emulation of csrc/ptx.cuh (see ../build.py, which puts this file in its
// place): the same functions, with the semantics of the PTX they wrap.
//   tf32_round   round to nearest, ties away from zero, on the 13 low mantissa
//                bits (cvt.rna.tf32.f32's bits).
//   mma_tf32     mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, warp
//                collective: each lane leaves its fragments, waits for its
//                warp as __shfl_xor_sync does, computes its four sums from
//                everyone's fragments in the PTX ISA's layout (operands read
//                as TF32, their 13 low bits dropped; products and sums in
//                double, rounded once to fp32), and waits again.
//   cp_async     cp.async with a source size: queued per thread and done at
//                the cp_async_wait that covers its group, so a read before
//                the wait (and a barrier, for other threads) sees the poison;
//                a misaligned address is a launch error.
#pragma once
#include <cstdint>
#include <cstring>
#include <vector>

namespace emu {
inline uint32_t f2u(float x) { uint32_t u; std::memcpy(&u, &x, 4); return u; }
inline float u2f(uint32_t u) { float x; std::memcpy(&x, &u, 4); return x; }
inline std::vector<float> g_mma;  // 10 words a thread of the running block: a[4], b[2], d[4]
struct PendingCopy { void* dst; const void* src; int bytes, src_bytes, group; };
struct CopyQueue { std::vector<PendingCopy> copies; int committed = 0; };
inline std::vector<CopyQueue> g_copies;  // a queue a thread of the running block
inline CopyQueue& my_copies() {
  if (g_copies.size() < g_blockDim.x) g_copies.resize(g_blockDim.x);
  return g_copies[tl_threadIdx.x];
}
}  // namespace emu

inline float tf32_round(float x) {
  return emu::u2f((emu::f2u(x) + 0x1000u) & 0xffffe000u);
}

inline void mma_tf32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  emu::Block* blk = emu::tl_block;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  if (emu::g_mma.size() < 10 * blockDim.x) emu::g_mma.resize(10 * blockDim.x);
  float* mine = &emu::g_mma[10 * t];
  for (int i = 0; i < 4; ++i) mine[i] = a[i], mine[6 + i] = d[i];
  mine[4] = b[0], mine[5] = b[1];
  emu::wait(blk->warp[w]);
  const float* warp = &emu::g_mma[10 * 32 * w];
  auto tf32 = [](float x) { return (double)emu::u2f(emu::f2u(x) & 0xffffe000u); };
  // A(r, k) is a[(r >= 8) + 2 (k >= 4)] of lane 4 (r % 8) + k % 4; B(k, n) is b[k >= 4] of lane 4 n + k % 4
  auto A = [&](int r, int k) { return tf32(warp[10 * (4 * (r % 8) + k % 4) + (r >= 8) + 2 * (k >= 4)]); };
  auto B = [&](int k, int n) { return tf32(warp[10 * (4 * n + k % 4) + 4 + (k >= 4)]); };
  const int g = lane / 4, tq = lane % 4;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), n = 2 * tq + i % 2;
    double s = mine[6 + i];
    for (int k = 0; k < 8; ++k) s += A(r, k) * B(k, n);
    out[i] = (float)s;
  }
  emu::wait(blk->warp[w]);  // every lane has read the warp's fragments
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

template <int kBytes>
inline void cp_async(void* dst, const void* src, int src_bytes) {
  if ((reinterpret_cast<uintptr_t>(dst) % kBytes) || (src_bytes && reinterpret_cast<uintptr_t>(src) % kBytes) ||
      src_bytes < 0 || src_bytes > kBytes)
    emu::last_error = 716;  // cudaErrorMisalignedAddress
  emu::CopyQueue& q = emu::my_copies();
  q.copies.push_back({dst, src, kBytes, src_bytes, q.committed});
}

inline void cp_async_commit() { ++emu::my_copies().committed; }

template <int pending>
inline void cp_async_wait() {
  emu::CopyQueue& q = emu::my_copies();
  std::vector<emu::PendingCopy> later;
  for (const emu::PendingCopy& c : q.copies) {
    if (c.group < q.committed - pending) {
      if (c.src_bytes) std::memcpy(c.dst, c.src, c.src_bytes);
      std::memset(static_cast<char*>(c.dst) + c.src_bytes, 0, c.bytes - c.src_bytes);
    } else {
      later.push_back(c);
    }
  }
  q.copies.swap(later);
}
