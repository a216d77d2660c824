// The token-wise passes the backward kernels share: the LayerNorm backward
// with per-block partials of its affine's gradients (K7, csrc/mdta_block_bwd.cu,
// and K9, csrc/swin_block_bwd.cu); on the tensor cores (tc_gemm.cuh), a
// weight gradient as per-chunk partials of a product over pixels (K2, K7 and
// K9) and a product into pixel space, cut along its depth where its tiles
// would leave the card idle (K2, csrc/naf_block_bwd.cu, and K7); the partials
// added by colsum<Owner> in a fixed order.  Owner is the number of the
// kernel that launches them, so a profile tells their launches apart.  Each
// map is fp32 (the backward's own) or the I/O type (x, dz and the parameters
// of a bf16 call), read through ld(); the sums are fp32.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int kRP = 32;            // LN: pixels of a block

// LN: out = res + the LayerNorm backward of dln through LN(v), one pixel per
// warp, then per column.  WithBias: vh = (v - mu) rs and
// out = res + rs (dl - mean dl - vh mean(dl vh)); BiasFree (uncentred output,
// centred variance): vh = v rs and out = res + rs dl - rs^3 (v - mu) mean(dl v);
// dl = dln * w.  part (blocks, 2C) gets the column sums over the block's
// pixels of dln * vh and (WithBias) dln, and lnout, unless null, the
// LayerNorm's output vh * w (+ b), the operand of the weight gradient that
// follows (fp32).  out is stored in its type TO.
template <int Owner, typename TV, typename TR, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const TV* __restrict__ v, const float* __restrict__ dln, const TR* __restrict__ res,
              const TW* __restrict__ w, const TW* __restrict__ b, TO* __restrict__ out,
              float* __restrict__ lnout, float* __restrict__ part, int npix, int C, float eps, int ln_bias) {
  extern __shared__ float smem[];  // 4 x kRP: mean, 1/sigma and the two means of the backward
  float *sMu = smem, *sRs = smem + kRP, *sM1 = smem + 2 * kRP, *sM2 = smem + 3 * kRP;
  const int p0 = blockIdx.x * kRP, np = min(kRP, npix - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < np; p += kThreads / 32) {
    const TV* vr = v + (size_t)(p0 + p) * C;
    const float* dr = dln + (size_t)(p0 + p) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += ld(vr[c]);
    const float mu = warp_sum(s) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = ld(vr[c]) - mu;
      var += d * d;
    }
    const float rs = 1.f / sqrtf(warp_sum(var) / C + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dl = dr[c] * ld(w[c]);
      m1 += dl;
      m2 += dl * (ln_bias ? (ld(vr[c]) - mu) * rs : ld(vr[c]));
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    if (lane == 0) {
      sMu[p] = mu;
      sRs[p] = rs;
      sM1[p] = m1;
      sM2[p] = m2;
    }
  }
  __syncthreads();
  float* pr = part + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float wc = ld(w[c]), bc = ln_bias && lnout ? ld(b[c]) : 0.f;
    float sw = 0.f, sb = 0.f;
    for (int p = 0; p < np; ++p) {
      const size_t q = (size_t)(p0 + p) * C + c;
      const float mu = sMu[p], rs = sRs[p], d = dln[q], dl = d * wc;
      const float vq = ld(v[q]);
      float ov, vh;
      if (ln_bias) {
        vh = (vq - mu) * rs;
        ov = rs * (dl - sM1[p] - vh * sM2[p]);
      } else {
        vh = vq * rs;
        ov = rs * dl - rs * rs * rs * (vq - mu) * sM2[p];
      }
      out[q] = st<TO>(ld(res[q]) + ov);
      if (lnout) lnout[q] = vh * wc + bc;
      sw = fmaf(d, vh, sw);
      sb += d;
    }
    pr[c] = sw;
    pr[C + c] = ln_bias ? sb : 0.f;  // BiasFree: the bias is no parameter, its cotangent zero
  }
}

// A product's output: out (T, N) row-major.
struct StoreEpi {
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    float* d = out + (size_t)r * N + n;
    d[0] = v0;
    if (n + 1 < N) d[1] = v1;
  }
};

// A weight gradient's (or a product's) depth chunk z: part[z] (M, N) gets its share.
struct PartEpi {
  float* part;
  int M, N;
  __device__ __forceinline__ void operator()(int z, int m, int n, float v0, float v1) const {
    float* d = part + ((size_t)z * M + m) * N + n;
    d[0] = v0;
    if (n + 1 < N) d[1] = v1;
  }
};

// W: out (M, N) = sum over the T tokens p of a[p][m] b[p][n], a (T, M) and b
// (T, N) token-major (a's rows lda apart, M when 0), and with bias (M,) the
// sums of a's columns: tc::gemm's
// partials over token chunks (part, and part_bias for the bias), then
// colsum<Owner> adds the chunks in a fixed order (scratch: its buffers).  The
// sizes these take: wgrad_floats.
template <int Owner, typename TA, typename TB>
cudaError_t wgrad(const TA* a, int M, const TB* b, int N, int T, float* part, float* part_bias, float* scratch,
                  float* out, float* bias, cudaStream_t stream, int lda = 0) {
  int len;
  const int nch = tc::depth_chunks(M, N, T, &len);
  cudaError_t err = tc::gemm<Owner>(tc::operand<false>(a, lda ? lda : M, M), tc::operand<false>(b, N, N), T, nch, len,
                                    PartEpi{part, M, N}, bias ? part_bias : nullptr, stream);
  if (err != cudaSuccess) return err;
  if ((err = colsum<Owner>(part, 1, nch, M * N, M * N, out, scratch, stream)) != cudaSuccess || !bias) return err;
  return colsum<Owner>(part_bias, 1, nch, M, M, bias, scratch, stream);
}

// The depth chunks of product: one, unless the output's tiles fill at most
// one block an SM (few pixels, the deep stages); then enough to fill two.
inline int product_chunks(int T, int K, int N, int* len) {
  const int tiles = ((T + tc::kBM - 1) / tc::kBM) * ((N + tc::kBN - 1) / tc::kBN);
  *len = K;
  return 2 * tiles <= tc::kTargetBlocks ? tc::depth_chunks(T, N, K, len) : 1;
}

// P: out (T, N) = a (T, K) . W, W (K, N) as stored (a PyTorch (out, in) weight
// read the other way: the backward's products); a's rows lda apart and W's
// ldw (K and N when 0).  Cut along the depth where product_chunks says, its
// chunks' partials (part) added by colsum<Owner> in a fixed order (scratch:
// its buffers).  The sizes this takes: product_floats.
template <int Owner, typename TA, typename TW>
cudaError_t product(const TA* a, const TW* w, int T, int K, int N, float* out, float* part, float* scratch,
                    cudaStream_t stream, int lda = 0, int ldw = 0) {
  int len;
  const int nch = product_chunks(T, K, N, &len);
  const auto A = tc::operand<true>(a, lda ? lda : K, T);
  const auto B = tc::operand<false>(w, ldw ? ldw : N, N);
  if (nch == 1) return tc::gemm<Owner>(A, B, K, 1, K, StoreEpi{out, N}, nullptr, stream);
  const cudaError_t err = tc::gemm<Owner>(A, B, K, nch, len, PartEpi{part, T, N}, nullptr, stream);
  if (err != cudaSuccess) return err;
  return colsum<Owner>(part, 1, nch, T * N, T * N, out, scratch, stream);
}

// Grow *part and *scratch to what product takes for a (T, K) . (K, N) product.
inline void product_floats(int T, int K, int N, size_t* part, size_t* scratch) {
  int len;
  const int nch = product_chunks(T, K, N, &len);
  if (nch == 1) return;
  *part = std::max(*part, (size_t)nch * T * N);
  *scratch = std::max(*scratch, colsum_scratch(1, nch, T * N));
}

// Grow *part, *part_bias and *scratch to what wgrad takes for an M x N gradient over T tokens.
inline void wgrad_floats(int M, int N, int T, size_t* part, size_t* part_bias, size_t* scratch) {
  int len;
  const int nch = tc::depth_chunks(M, N, T, &len);
  *part = std::max(*part, (size_t)nch * M * N);
  *part_bias = std::max(*part_bias, (size_t)nch * M);
  *scratch = std::max(*scratch, colsum_scratch(1, nch, M * N));
}

}  // namespace
