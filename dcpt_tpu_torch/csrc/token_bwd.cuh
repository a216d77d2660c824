// The token-wise passes the backward kernels K7 (csrc/mdta_block_bwd.cu) and K9
// (csrc/swin_block_bwd.cu) share: the LayerNorm backward with per-block
// partials of its affine's gradients, and a weight gradient as per-chunk
// partials of a product over pixels, both to be added by colsum<Owner> in a fixed
// order.  Owner is the number of the kernel that launches them, so a profile
// tells their launches apart.  Each map is fp32 (the backward's own) or the I/O
// type (x, dz and the parameters of a bf16 call), read through ld(); the sums
// are fp32.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kRP = 32;            // LN: pixels of a block
constexpr int kWBlocks = 2 * 132;  // W: blocks to aim for (two per SM)

// LN: out = res + the LayerNorm backward of dln through LN(v), one pixel per
// warp, then per column.  WithBias: vh = (v - mu) rs and
// out = res + rs (dl - mean dl - vh mean(dl vh)); BiasFree (uncentred output,
// centred variance): vh = v rs and out = res + rs dl - rs^3 (v - mu) mean(dl v);
// dl = dln * w.  stats (pixels, 2) gets mu and rs; part (blocks, 2C) the
// column sums over the block's pixels of dln * vh and (WithBias) dln.  out is
// stored in its type TO.
template <int Owner, typename TV, typename TR, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const TV* __restrict__ v, const float* __restrict__ dln, const TR* __restrict__ res,
              const TW* __restrict__ w, TO* __restrict__ out, float* __restrict__ stats,
              float* __restrict__ part, int npix, int C, float eps, int ln_bias) {
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
      stats[2 * (size_t)(p0 + p)] = mu;
      stats[2 * (size_t)(p0 + p) + 1] = rs;
    }
  }
  __syncthreads();
  float* pr = part + (size_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float wc = ld(w[c]);
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
      sw = fmaf(d, vh, sw);
      sb += d;
    }
    pr[c] = sw;
    pr[C + c] = ln_bias ? sb : 0.f;  // BiasFree: the bias is no parameter, its cotangent zero
  }
}

// W: part[chunk][m][n] = sum over the chunk's pixels p of a[p][m] * B(p, n),
// a (npix, M) with row stride lda; B = bm (row stride ldb) or, with LN, the
// LayerNorm output of bm (npix, N) from stats (mu, rs a pixel), lw and lb.
// grid (cols(N), cols(M), chunks); ragged M and N are masked.
template <int Owner, bool LN, typename TA, typename TB, typename TL>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const TA* __restrict__ a, int lda, const TB* __restrict__ bm, int ldb,
             const float* __restrict__ stats, const TL* __restrict__ lw, const TL* __restrict__ lb,
             int ln_bias, float* __restrict__ part, int npix, int M, int N, int L) {
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = smem + kKC * kWS;
  const int n0 = blockIdx.x * kNB, m0 = blockIdx.y * kNB, chunk = blockIdx.z;
  const int pbeg = chunk * L, pend = min(npix, pbeg + L);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  auto load_b = [&](int p, int n) {
    const float v = ld(bm[(size_t)p * ldb + n]);
    if (!LN) return v;
    const float mu = stats[2 * (size_t)p], rs = stats[2 * (size_t)p + 1];
    return ln_bias ? (v - mu) * rs * ld(lw[n]) + ld(lb[n]) : v * rs * ld(lw[n]);
  };
  float acc[4][4], unused[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  for (int q0 = pbeg; q0 < pend; q0 += kKC) {
    __syncthreads();
    // lanes run along m and n: coalesced reads, consecutive stores
    for (int idx = threadIdx.x; idx < kKC * kNB; idx += kThreads) {
      const int kk = idx / kNB, e = idx % kNB, p = q0 + kk;
      const bool in = p < pend;
      sA[kk * kWS + e] = in && m0 + e < M ? ld(a[(size_t)p * lda + m0 + e]) : 0.f;
      sB[kk * kWS + e] = in && n0 + e < N ? load_b(p, n0 + e) : 0.f;
    }
    __syncthreads();
    mma_chunk<4, false>(sA, kWS, sB, sB, acc, unused);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * r, n = n0 + tx + 16 * i;
      if (m < M && n < N) part[((size_t)chunk * M + m) * N + n] = acc[r][i];
    }
}

// Pixel chunks of a weight-gradient product with an M x N output: enough
// blocks to fill the card, chunks a multiple of kKC pixels.  Returns the chunk
// count and sets *len.
int w_chunks(int M, int N, int npix, int* len) {
  const int tiles = ((M + kNB - 1) / kNB) * ((N + kNB - 1) / kNB);
  const int max_chunks = (npix + kKC - 1) / kKC;
  int n = (kWBlocks + tiles - 1) / tiles;
  n = n < 1 ? 1 : (n > max_chunks ? max_chunks : n);
  int l = (npix + n - 1) / n;
  l = (l + kKC - 1) / kKC * kKC;
  *len = l;
  return (npix + l - 1) / l;
}

}  // namespace
