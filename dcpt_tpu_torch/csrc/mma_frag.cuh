// Register-level helpers that the port's mma.sync TF32 kernels share (K8 and
// K10 through swin_window.cuh, K9's window passes, tc_gemm.cuh): the split of
// an fp32 operand into TF32 parts that gives three TF32 products fp32
// accuracy (3xTF32), and the softmax of a warp's score fragments.  Both are
// plain device code over ptx.cuh's functions, so the CPU emulation runs them
// as they are.
#pragma once

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

// a = hi + lo, both TF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
// first, is a . b to fp32 accuracy.  With kLo false (a bf16 value, TF32
// already) a is its own high part and lo is 0.
template <bool kLo = true>
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = kLo ? tf32_round(a) : a;
  lo = kLo ? tf32_round(a - hi) : 0.f;
}

// Softmax over the keys below ntok of a warp's 16 x 64 scores in mma_tf32's D
// layout (s[j][0], [1]: row g, keys 8 j + 2 t + {0, 1}; s[j][2], [3]: row g +
// 8): s becomes exp(s - the row's maximum), 0 from key ntok on, and inv0 and
// inv1 1 / the sums of rows g and g + 8.  A row's four lanes combine their
// maxima and sums by shuffles, each ending with the same bits.
__device__ __forceinline__ void softmax_frags(float (&s)[8][4], int ntok, float& inv0, float& inv1) {
  const int t = threadIdx.x & 3;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (8 * j + 2 * t + e < ntok) {
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = 8 * j + 2 * t + e < ntok;
      s[j][e] = live ? expf(s[j][e] - mx0) : 0.f;
      s[j][2 + e] = live ? expf(s[j][2 + e] - mx1) : 0.f;
      sum0 += s[j][e];
      sum1 += s[j][2 + e];
    }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  inv0 = 1.f / sum0;
  inv1 = 1.f / sum1;
}

}  // namespace
