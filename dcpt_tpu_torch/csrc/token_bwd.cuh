// The token-wise passes the block kernels share: the LayerNorm forward (K1,
// csrc/naf_block.cu, and K6, csrc/mdta_block.cu) and backward with per-block
// partials of its affine's gradients (K7, csrc/mdta_block_bwd.cu, and K9,
// csrc/swin_block_bwd.cu); on the tensor cores (tc_gemm.cuh), a weight
// gradient as per-chunk partials of a product over pixels (K2, K7 and K9)
// and a product into pixel space, cut along its depth where its tiles would
// leave the card idle (the forwards K1 and K6, the backwards K2,
// csrc/naf_block_bwd.cu, and K7); the partials added in a fixed order
// (colsum<Owner>, or chunk_epi_kernel<Owner> where an epilogue needs the whole
// sum).  Owner is the number of the kernel that launches them, so a profile
// tells their launches apart.  Each map is fp32 (the kernels' own) or the I/O
// type (x, dz and the parameters of a bf16 call), read through ld(); the sums
// are fp32.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int kRP = 32;            // LN: pixels of a block

constexpr int kLnRows = kThreads / 32;  // LN forward: rows of a block, one a warp

// LN forward: out (rows, C) fp32 = the channel LayerNorm of v's rows, one row a
// warp: mu and the biased variance over C, rs = 1 / sqrt(var + eps); WithBias
// (v - mu) rs w + b, BiasFree (Restormer's) the uncentred v rs w.
template <int Owner, typename TV, typename TW>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const TV* __restrict__ v, const TW* __restrict__ w, const TW* __restrict__ b, float* __restrict__ out,
              int rows, int C, float eps, int ln_bias) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TV* vr = v + (size_t)row * C;
  float* o = out + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += ld(vr[c]);
  const float mu = warp_sum(s) / C;
  float var = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = ld(vr[c]) - mu;
    var += d * d;
  }
  const float rs = 1.f / sqrtf(warp_sum(var) / C + eps);
  for (int c = lane; c < C; c += 32)
    o[c] = ln_bias ? (ld(vr[c]) - mu) * rs * ld(w[c]) + ld(b[c]) : ld(vr[c]) * rs * ld(w[c]);
}

template <int Owner, typename TV, typename TW>
cudaError_t ln_fwd(const TV* v, const TW* w, const TW* b, float* out, int rows, int C, float eps, int ln_bias,
                   cudaStream_t stream) {
  ln_fwd_kernel<Owner, TV, TW><<<(rows + kLnRows - 1) / kLnRows, kThreads, 0, stream>>>(v, w, b, out, rows, C, eps,
                                                                                         ln_bias);
  return cudaGetLastError();
}

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

// An epilogue's column pair: d[0] = v0 and, if two, d[1] = v1, as one 8-byte
// store where d is so aligned (an even row length).
__device__ __forceinline__ void store_pair(float* d, float v0, float v1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(d) & 7) == 0) {
    *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
  } else {
    d[0] = v0;
    if (two) d[1] = v1;
  }
}

// A product's output: out (T, N) row-major.
struct StoreEpi {
  float* out;
  int N;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    store_pair(out + (size_t)r * N + n, v0, v1, n + 1 < N);
  }
};

// A weight gradient's (or a product's) depth chunk z: part[z] (M, N) gets its share.
struct PartEpi {
  float* part;
  int M, N;
  __device__ __forceinline__ void operator()(int z, int m, int n, float v0, float v1) const {
    store_pair(part + ((size_t)z * M + m) * N + n, v0, v1, n + 1 < N);
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
// A product of fewer than min_rows rows is not cut.
inline int product_chunks(int T, int K, int N, int* len, int min_rows = 0) {
  const int tiles = ((T + tc::kBM - 1) / tc::kBM) * ((N + tc::kBN - 1) / tc::kBN);
  *len = K;
  return 2 * tiles <= tc::kTargetBlocks && T >= min_rows ? tc::depth_chunks(T, N, K, len) : 1;
}

// The forwards (K1, K6) cut no product of fewer rows: at B = 1 on the deep
// stages a product is a few microseconds of device work, about what the cut's
// second launch costs the host, and the eval there is bound by the host.
constexpr int kForwardMinCutRows = 1024;

// A product cut along its depth, whose epilogue needs the whole sum: the
// chunks' partials part (chunks, T, N) added in chunk order, then epi(0, r,
// n, v0, v1) on each column pair (n, n + 1) of D (T, N), as tc_gemm_kernel
// calls it; one thread a pair.
template <int Owner, class Epi>
__global__ void __launch_bounds__(kThreads)
chunk_epi_kernel(const float* __restrict__ part, int chunks, int T, int N, Epi epi) {
  const int pairs = (N + 1) / 2;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)T * pairs) return;
  const int r = (int)(i / pairs), n = 2 * (int)(i % pairs);
  const bool two = n + 1 < N;
  float v0 = 0.f, v1 = 0.f;
  for (int z = 0; z < chunks; ++z) {
    const float* p = part + ((size_t)z * T + r) * N + n;
    v0 += p[0];
    if (two) v1 += p[1];
  }
  epi(0, r, n, v0, v1);
}

// The chunks' partials into the product's output: by colsum<Owner> for a plain
// store (StoreEpi), by chunk_epi_kernel<Owner> for any other epilogue.
template <int Owner, class Epi>
cudaError_t finish_chunks(const float* part, int nch, int T, int N, const Epi& epi, float*, cudaStream_t stream) {
  const long long pairs = (long long)T * ((N + 1) / 2);
  chunk_epi_kernel<Owner, Epi><<<(unsigned)((pairs + kThreads - 1) / kThreads), kThreads, 0, stream>>>(part, nch, T, N,
                                                                                                      epi);
  return cudaGetLastError();
}
template <int Owner>
cudaError_t finish_chunks(const float* part, int nch, int T, int N, const StoreEpi& epi, float* scratch,
                          cudaStream_t stream) {
  return colsum<Owner>(part, 1, nch, T * N, T * N, epi.out, scratch, stream);
}

// P: D (T, N) = a (T, K) . W, then epi on each column pair of D (tc_gemm_kernel's
// epilogue): a k-major (T = a.rows, K), W either layout with N = w.rows rows:
// (K, N) read the other way (a PyTorch (out, in) weight in the backward's
// products) or (N, K) read k-major (an (out, in) weight: the forward's
// a . W^T).  Cut along the depth where product_chunks says (never below
// min_rows rows), its chunks' partials (part) added in a fixed order by
// finish_chunks (scratch: colsum's buffers) before the epilogue.  The sizes
// this takes: product_floats.
template <int Owner, typename TA, typename TW, bool WK, class Epi>
cudaError_t product_epi(const tc::Operand<TA, true>& a, const tc::Operand<TW, WK>& w, int K, const Epi& epi,
                        float* part, float* scratch, cudaStream_t stream, int min_rows = 0) {
  const int T = a.rows, N = w.rows;
  int len;
  const int nch = product_chunks(T, K, N, &len, min_rows);
  if (nch == 1) return tc::gemm<Owner>(a, w, K, 1, K, epi, nullptr, stream);
  const cudaError_t err = tc::gemm<Owner>(a, w, K, nch, len, PartEpi{part, T, N}, nullptr, stream);
  if (err != cudaSuccess) return err;
  return finish_chunks<Owner>(part, nch, T, N, epi, scratch, stream);
}

// P into out (T, N) as computed (StoreEpi), W (K, N) read the other way: the
// backward's products; a's rows lda apart and W's ldw (K and N when 0).
template <int Owner, typename TA, typename TW>
cudaError_t product(const TA* a, const TW* w, int T, int K, int N, float* out, float* part, float* scratch,
                    cudaStream_t stream, int lda = 0, int ldw = 0) {
  return product_epi<Owner>(tc::operand<true>(a, lda ? lda : K, T), tc::operand<false>(w, ldw ? ldw : N, N), K,
                            StoreEpi{out, N}, part, scratch, stream);
}

// Grow *part and *scratch to what product (product_epi) takes for a (T, K) . (K, N) product.
inline void product_floats(int T, int K, int N, size_t* part, size_t* scratch, int min_rows = 0) {
  int len;
  const int nch = product_chunks(T, K, N, &len, min_rows);
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
