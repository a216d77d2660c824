// The SIMT fp32 product of the port's kernels: 256 threads compute a block of
// rows p < 16 * RM times 64 weight columns, K streamed through shared memory in
// 32-deep chunks (gemm_block for the NAFBlock's multiples of 64, gemm_masked for
// the TransformerBlock's ragged widths).  Thread (tx, ty) = (threadIdx.x % 16, threadIdx.x / 16) ends
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

// acc[r][i] = sum over k in [kbeg, kend) of A(p, k) * w[n][k] for the block's
// rows p = ty + 16 r and columns n = n0 + tx + 16 i, A(p, k) = load_a(p, k),
// w (N, ldw) row-major (PyTorch's (out, in)), or with WT w (K, ldw), the same
// matrix read transposed (lanes along n).  Columns n >= N and depths
// k >= kend read as zero, so ragged widths need no padding.  Uses
// gemm_smem_floats(RM) floats at smem.
template <int RM, bool WT = false, typename TW, typename LoadA>
__device__ __forceinline__ void gemm_masked(float* smem, const TW* __restrict__ w, int ldw, int N, int n0, int kbeg,
                                            int kend, LoadA load_a, float (&acc)[RM][4]) {
  constexpr int P = 16 * RM, lda = P + 1;
  float* sA = smem;
  float* sW = sA + kKC * lda;
  float unused[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  for (int k0 = kbeg; k0 < kend; k0 += kKC) {
    __syncthreads();
    // lanes run along k: coalesced reads, conflict-free transposing stores (lda is odd)
    for (int idx = threadIdx.x; idx < P * kKC; idx += kThreads) {
      const int p = idx / kKC, kk = idx % kKC;
      sA[kk * lda + p] = k0 + kk < kend ? load_a(p, k0 + kk) : 0.f;
    }
    if (WT) {
      for (int idx = threadIdx.x; idx < kKC * kNB; idx += kThreads) {
        const int kk = idx / kNB, n = idx % kNB;
        sW[kk * kWS + n] = k0 + kk < kend && n0 + n < N ? ld(w[(size_t)(k0 + kk) * ldw + n0 + n]) : 0.f;
      }
    } else {
      const int kk = threadIdx.x & 31;
      const bool kin = k0 + kk < kend;
      for (int n = threadIdx.x >> 5; n < kNB; n += kThreads / 32)
        sW[kk * kWS + n] = kin && n0 + n < N ? ld(w[(size_t)(n0 + n) * ldw + k0 + kk]) : 0.f;
    }
    __syncthreads();
    mma_chunk<RM, false>(sA, lda, sW, sW, acc, unused);
  }
}

// The head-block product of K6's Gram and K7's dattn over one chunk of np
// pixels: acc[r][i] = sum over p of A[p][ty + 16 r] * B[p][tx + 16 i], row p of
// A at a + p * lda and of B at b + p * ldb (each pointer at the tile's first
// channel; channels at or past na, nb read as zero).  With NORMS, threads
// j < kNB also sum A[p][j]^2 into sa and B[p][j]^2 into sb.  Uses 2 kKC kWS
// floats at smem; the pixels are added in order, so the result is the same
// bit for bit from run to run.
template <bool NORMS>
__device__ __forceinline__ void head_tile_product(float* smem, const float* __restrict__ a, int lda,
                                                  const float* __restrict__ b, int ldb, int np, int na, int nb,
                                                  float (&acc)[4][4], float& sa, float& sb) {
  float* sA = smem;  // kKC pixels x kNB channels, row stride kWS
  float* sB = sA + kKC * kWS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  sa = sb = 0.f;
  for (int pp0 = 0; pp0 < np; pp0 += kKC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kKC * kNB; idx += kThreads) {
      const int pp = idx / kNB, c = idx % kNB;  // lanes along channels: coalesced
      const bool in = pp0 + pp < np;
      sA[pp * kWS + c] = in && c < na ? a[(size_t)(pp0 + pp) * lda + c] : 0.f;
      sB[pp * kWS + c] = in && c < nb ? b[(size_t)(pp0 + pp) * ldb + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < kKC; ++pp) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = sA[pp * kWS + ty + 16 * r];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = sB[pp * kWS + tx + 16 * i];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(av[r], bv[i], acc[r][i]);
    }
    if (NORMS && threadIdx.x < kNB)
      for (int pp = 0; pp < kKC; ++pp) {
        const float x = sA[pp * kWS + threadIdx.x], y = sB[pp * kWS + threadIdx.x];
        sa = fmaf(x, x, sa);
        sb = fmaf(y, y, sb);
      }
  }
}

// The masked products of K6 and K7 share one grid: (pixel tiles of 16 * RM, column blocks of kNB, B).
#define GEMM_PROLOGUE                                                    \
  constexpr int P = 16 * RM;                                             \
  extern __shared__ float smem[];                                        \
  const int b = blockIdx.z, p0 = blockIdx.x * P, n0 = blockIdx.y * kNB;  \
  const int np = min(P, HW - p0);                                        \
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;                \
  constexpr int kGemmFloats = kKC * (P + 1) + 2 * kWChunk; /* gemm_smem_floats(RM) */ \
  float acc[RM][4];

// Visit the block's outputs (row p < np, column n < N) with their accumulators.
#define GEMM_EPILOGUE(N, BODY)                                  \
  _Pragma("unroll") for (int r = 0; r < RM; ++r)                \
  _Pragma("unroll") for (int i = 0; i < 4; ++i) {               \
    const int p = ty + 16 * r, n = n0 + tx + 16 * i;            \
    if (p < np && n < (N)) {                                    \
      const float a = acc[r][i];                                \
      BODY                                                      \
    }                                                           \
  }

}  // namespace
