// The SIMT fp32 product of the NAFBlock kernels: 256 threads compute a block of
// rows p < 16 * RM times 64 weight columns, K streamed through shared memory in
// 32-deep chunks.  Thread (tx, ty) = (threadIdx.x % 16, threadIdx.x / 16) ends
// with rows ty + 16 r, columns n0 + tx + 16 i.
#pragma once

#include "common.cuh"

namespace {

constexpr int kKC = 32;        // K-chunk of a streamed product
constexpr int kNB = 64;        // output columns of a block (per half when paired)
constexpr int kWS = kNB + 1;   // padded row stride of a weight chunk in shared memory
constexpr int kWChunk = kKC * kWS;

// Weight element (n, k) for n in [n0, n0 + kNB), k in [k0, k0 + kKC), into
// sW[kk * kWS + n].  !WT: w is (N, K) row-major (PyTorch's (out, in), the
// forward's products), lanes run along k; WT: w is (K, N) row-major (the same
// matrix read transposed, the backward's products), lanes run along n.  Both
// read coalesced; the padded stride keeps the stores free of bank conflicts.
template <bool WT, typename T>
__device__ __forceinline__ void load_w_chunk(float* sW, const T* __restrict__ w, int ldw, int n0, int k0) {
  if (WT) {
    for (int idx = threadIdx.x; idx < kKC * kNB; idx += kThreads) {
      const int kk = idx / kNB, n = idx % kNB;
      sW[kk * kWS + n] = ld(w[(size_t)(k0 + kk) * ldw + n0 + n]);
    }
  } else {
    const int kk = threadIdx.x & 31;
    for (int n = threadIdx.x >> 5; n < kNB; n += kThreads / 32)
      sW[kk * kWS + n] = ld(w[(size_t)(n0 + n) * ldw + k0 + kk]);
  }
}

// acc[r][i] += sum_kk sA[kk][ty + 16r] * sW[kk][tx + 16i] over one K-chunk;
// acc2 likewise against the paired chunk sW2 when PAIRED.
template <int RM, bool PAIRED>
__device__ __forceinline__ void mma_chunk(const float* sA, int lda, const float* sW, const float* sW2,
                                          float (&acc)[RM][4], float (&acc2)[RM][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int kk = 0; kk < kKC; ++kk) {
    float a[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = sA[kk * lda + ty + 16 * r];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = sW[kk * kWS + tx + 16 * i];
      const float w2 = PAIRED ? sW2[kk * kWS + tx + 16 * i] : 0.f;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        acc[r][i] = fmaf(a[r], w, acc[r][i]);
        if (PAIRED) acc2[r][i] = fmaf(a[r], w2, acc2[r][i]);
      }
    }
  }
}

// The block's rows p < 16 * RM times the weight columns [n0, n0 + kNB) (and
// [n0 + pair_off, ...) when PAIRED) of A . W^T, A(p, k) = load_a(p, k), W read
// as load_w_chunk<WT> does, K streamed through shared memory
// (gemm_smem_floats(RM) floats at smem) in kKC chunks.
template <int RM, bool PAIRED, bool WT, typename T, typename LoadA>
__device__ __forceinline__ void gemm_block(float* smem, const T* __restrict__ w, int K, int ldw, int n0,
                                           int pair_off, LoadA load_a, float (&acc)[RM][4], float (&acc2)[RM][4]) {
  constexpr int P = 16 * RM, lda = P + 1;
  float* sA = smem;
  float* sW = sA + kKC * lda;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = acc2[r][i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();
    // lanes run along k: coalesced reads, conflict-free transposing stores (lda is odd)
    for (int idx = threadIdx.x; idx < P * kKC; idx += kThreads) {
      const int p = idx / kKC, kk = idx % kKC;
      sA[kk * lda + p] = load_a(p, k0 + kk);
    }
    load_w_chunk<WT>(sW, w, ldw, n0, k0);
    if (PAIRED) load_w_chunk<WT>(sW + kWChunk, w, ldw, n0 + pair_off, k0);
    __syncthreads();
    mma_chunk<RM, PAIRED>(sA, lda, sW, sW + kWChunk, acc, acc2);
  }
}

constexpr int gemm_smem_floats(int rm) { return kKC * (16 * rm + 1) + 2 * kWChunk; }

}  // namespace
