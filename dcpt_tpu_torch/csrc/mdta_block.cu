// Whole Restormer / PromptIR TransformerBlock forward on Hopper (sm_90a): SIMT
// fp32 math, fp32 or bf16 I/O.
//
// Replaces the TPU kernel dcpt_tpu/ops/mdta_block.py::mdta_block_fused
// (_block_pallas: _p1_kernel, the host _attn_from_stats, _p2_kernel).  It
// computes what mdta_block_ref computes on a (B, H, W, C) channels-last map
// with heads heads of ch = C / heads channels and an FFN of F channels:
//
//   pass 1  qkv    t = LN1(x) . Wqkv^T                      (B, HW, 3C) fp32
//           dw     qkv = depthwise 3x3 of t, zero outside    (B, HW, 3C) fp32
//           gram   per (pixel chunk, head, 64 x 64 tile): the raw Gram
//                  q_h^T k_h of the head's ch x ch block, |q|^2 and |k|^2,
//                  as partials of kChunk pixels; colsum adds them in chunk
//                  order (no atomics, so the result is the same bit for bit)
//   between attn   attn = act(G * rsqrt(max(|q|^2, 1e-24)) * rsqrt(max(|k|^2, 1e-24)) * T)
//                  on each head's block, zero off it; act is ReLU or a
//                  softmax over the block (the off-block logits are -inf)
//   pass 2  av     o = v . attn^T, each column block only over its heads' rows
//           proj   y = x + o . Wproj^T                       (B, HW, C) fp32
//           ffnin  u = LN2(y) . Win^T                        (B, HW, 2F) fp32
//           gate   g = gelu(dw(u)[:F]) * dw(u)[F:], exact erf (B, HW, F) fp32
//           ffnout z = y + g . Wout^T                        (B, HW, C) I/O type
//
// Only the head blocks of the Gram are computed (C * ch instead of C^2 per
// pixel): the mask discards the rest.  Of the maps, v, the reduced Gram with
// the norms, and attn are what the backward reads (dcpt_tpu's
// _block_pallas(..., with_res=True)); the caller keeps them when it asks for them.
//
// Borders: the 1x1 products are bias-free, and the depthwise convs read the
// PROJECTED maps as zero outside the image (F.conv2d's zero padding of t and
// u), never the LN of a zero pixel.  Every product masks its ragged rows,
// columns and depth, so every H x W >= 1 x 1 and every C, F and head width is
// taken (C = 48 ... 704, F = 127 ... 1872 and ch = 40 ... 176 on the shipped nets).
//
// What bounds it on this card: 2 (3C^2 + C^2 + 3FC + 2C ch) + 18 (3C + 2F)
// flops per pixel, about 24 C^2 at F = 2.66 C: operations, at every stage of
// the shipped nets, run here on the SIMT fp32 pipes from shared memory.  Each
// product is a grid of 16 * RM-pixel x 64-column blocks with the weight
// streamed through shared memory in 32-deep chunks (gemm.cuh's inner loop),
// so its ceiling is shared-memory bandwidth, and the grid is sized so that
// hundreds of blocks fill the card at the deep, small stages too.  The
// intermediate maps (t, qkv, o, y, u, g) go through device memory, which
// costs about 3 KB per pixel at C = 48 (they stay mostly in the 50 MB L2 at
// 128 x 128); fusing them into halo tiles, and wgmma/TMA tiles, are the next steps.
//
// Weights come in PyTorch's layout: every 1x1 as (out, in) row-major, the
// depthwise 3x3 as (channels, 3, 3), temperature as (heads,).

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kChunk = 128;  // pixels of one Gram partial

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// LayerNorm statistics of the rows p < np of a (rows, C) map at `rows`, one
// warp per row, into sMu[p] and sRs[p] = 1 / sqrt(var + eps) (biased variance).
template <typename T>
__device__ __forceinline__ void ln_stats(const T* __restrict__ rows, int np, int P, int C, float eps, float* sMu,
                                         float* sRs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < P; p += kThreads / 32) {
    const bool in = p < np;
    const T* row = rows + (in ? (size_t)p * C : 0);
    float s = 0.f;
    if (in)
      for (int c = lane; c < C; c += 32) s += ld(row[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    if (in)
      for (int c = lane; c < C; c += 32) {
        const float d = ld(row[c]) - mu;
        v += d * d;
      }
    v = warp_sum(v);
    if (lane == 0) {
      sMu[p] = mu;
      sRs[p] = 1.f / sqrtf(v / C + eps);
    }
  }
}

// acc[r][i] = sum over k in [kbeg, kend) of A(p, k) * w[n][k] for the block's
// rows p = ty + 16 r and columns n = n0 + tx + 16 i, A(p, k) = load_a(p, k),
// w (N, ldw) row-major (PyTorch's (out, in)).  Columns n >= N and depths
// k >= kend read as zero, so ragged widths need no padding.  Uses
// gemm_smem_floats(RM) floats at smem.
template <int RM, typename TW, typename LoadA>
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
    const int kk = threadIdx.x & 31;
    const bool kin = k0 + kk < kend;
    for (int n = threadIdx.x >> 5; n < kNB; n += kThreads / 32)
      sW[kk * kWS + n] = kin && n0 + n < N ? ld(w[(size_t)(n0 + n) * ldw + k0 + kk]) : 0.f;
    __syncthreads();
    mma_chunk<RM, false>(sA, lda, sW, sW, acc, unused);
  }
}

// The products share one grid: (pixel tiles of 16 * RM, column blocks of kNB, B).
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

// LN(rows)[p][k] with the statistics in sMu / sRs: BiasFree keeps the
// uncentred value (x * rsigma * w), WithBias centres it and adds b.
template <typename T, typename TW>
__device__ __forceinline__ float ln_value(const T* rows, int C, int p, int k, const float* sMu, const float* sRs,
                                          const TW* w, const TW* bias, int ln_bias) {
  const float v = ld(rows[(size_t)p * C + k]);
  return ln_bias ? (v - sMu[p]) * sRs[p] * ld(w[k]) + ld(bias[k]) : v * sRs[p] * ld(w[k]);
}

// t = LN1(x) . Wqkv^T, (B, HW, 3C) fp32
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
mdta_qkv_kernel(const T* __restrict__ x, const T* __restrict__ n1w, const T* __restrict__ n1b,
                const T* __restrict__ wqkv, float* __restrict__ t, int HW, int C, float eps, int ln_bias) {
  GEMM_PROLOGUE
  const T* xb = x + ((size_t)b * HW + p0) * C;
  float* sMu = smem + kGemmFloats;  // after the product's buffers
  float* sRs = sMu + P;
  ln_stats(xb, np, P, C, eps, sMu, sRs);
  gemm_masked<RM>(smem, wqkv, C, 3 * C, n0, 0, C, [&](int p, int k) {
    return p < np ? ln_value(xb, C, p, k, sMu, sRs, n1w, n1b, ln_bias) : 0.f;
  }, acc);
  float* tb = t + ((size_t)b * HW + p0) * 3 * C;
  GEMM_EPILOGUE(3 * C, tb[(size_t)p * 3 * C + n] = a;)
}

// Depthwise 3x3 (cross-correlation, as F.conv2d) of channel c of a (B, H, W, ld)
// fp32 map at pixel (b, yy, xx), zero outside the image; w (channels, 3, 3).
template <typename T>
__device__ __forceinline__ float dw3x3(const float* __restrict__ in, const T* __restrict__ w, int b, int yy, int xx,
                                       int c, int H, int W, int ld_) {
  float s = 0.f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int y = yy + dy;
    if (y < 0 || y >= H) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xq = xx + dx;
      if (xq < 0 || xq >= W) continue;
      s = fmaf(in[(((size_t)b * H + y) * W + xq) * ld_ + c], ld(w[(size_t)c * 9 + (dy + 1) * 3 + dx + 1]), s);
    }
  }
  return s;
}

// qkv = depthwise 3x3 of t, all 3C channels; one thread per (pixel, channel)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_dw_kernel(const float* __restrict__ t, const T* __restrict__ wdw, float* __restrict__ out, int B, int H, int W,
               int D) {
  const size_t total = (size_t)B * H * W * D;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x; idx < total; idx += (size_t)gridDim.x * kThreads) {
    const int c = (int)(idx % D);
    const size_t pix = idx / D;
    const int xx = (int)(pix % W), yy = (int)((pix / W) % H), b = (int)(pix / ((size_t)H * W));
    out[idx] = dw3x3(t, wdw, b, yy, xx, c, H, W, D);
  }
}

// Gram partials.  Grid (chunks, heads * tiles^2, B), tiles = ceil(ch / 64): the
// block adds q_h[p][c] k_h[p][d] over its chunk's pixels for the tile's
// 64 x 64 (c, d) pairs, thread (tx, ty) owning c = c0 + ty + 16 r,
// d = d0 + tx + 16 i.  A partial row is [Gram (C, ch) | |q|^2 (C) | |k|^2 (C)],
// the Gram's row c holding c's head block; the tiles with d0 = 0 write the q
// norms of their c, those with c0 = 0 the k norms of their d.
__global__ void __launch_bounds__(kThreads)
mdta_gram_kernel(const float* __restrict__ qkv, float* __restrict__ part, int HW, int C, int ch) {
  extern __shared__ float smem[];
  float* sQ = smem;             // kKC pixels x kNB channels, row stride kWS
  float* sK = sQ + kKC * kWS;
  const int tiles = (ch + kNB - 1) / kNB;
  const int h = blockIdx.y / (tiles * tiles), tile = blockIdx.y % (tiles * tiles);
  const int c0 = (tile / tiles) * kNB, d0 = (tile % tiles) * kNB;
  const int b = blockIdx.z, p0 = blockIdx.x * kChunk, np = min(kChunk, HW - p0);
  const float* base = qkv + ((size_t)b * HW + p0) * 3 * C;
  const int qoff = h * ch + c0, koff = C + h * ch + d0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  float nq = 0.f, nk = 0.f;
  for (int pp0 = 0; pp0 < np; pp0 += kKC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kKC * kNB; idx += kThreads) {
      const int pp = idx / kNB, c = idx % kNB;  // lanes along channels: coalesced
      const bool in = pp0 + pp < np;
      const float* row = base + (size_t)(pp0 + pp) * 3 * C;
      sQ[pp * kWS + c] = in && c0 + c < ch ? row[qoff + c] : 0.f;
      sK[pp * kWS + c] = in && d0 + c < ch ? row[koff + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < kKC; ++pp) {
      float a[4], k[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sQ[pp * kWS + ty + 16 * r];
#pragma unroll
      for (int i = 0; i < 4; ++i) k[i] = sK[pp * kWS + tx + 16 * i];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(a[r], k[i], acc[r][i]);
    }
    if (threadIdx.x < kNB)
      for (int pp = 0; pp < kKC; ++pp) {
        const float q = sQ[pp * kWS + threadIdx.x], k = sK[pp * kWS + threadIdx.x];
        nq = fmaf(q, q, nq);
        nk = fmaf(k, k, nk);
      }
  }
  float* row = part + ((size_t)b * gridDim.x + blockIdx.x) * ((size_t)C * ch + 2 * C);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty + 16 * r, d = d0 + tx + 16 * i;
      if (c < ch && d < ch) row[(size_t)(h * ch + c) * ch + d] = acc[r][i];
    }
  if (threadIdx.x < kNB) {
    const int j = threadIdx.x;
    if (d0 == 0 && c0 + j < ch) row[(size_t)C * ch + h * ch + c0 + j] = nq;
    if (c0 == 0 && d0 + j < ch) row[(size_t)C * ch + C + h * ch + d0 + j] = nk;
  }
}

// attn (B, C, C) from the reduced statistics red (B, C * ch + 2C); one warp per
// row c, every column written (zero off c's head block).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_attn_kernel(const float* __restrict__ red, const T* __restrict__ temperature, float* __restrict__ attn, int C,
                 int ch, int use_softmax) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (kThreads / 32) + warp, b = blockIdx.y;
  if (c >= C) return;
  const float* rb = red + (size_t)b * ((size_t)C * ch + 2 * C);
  const float* g = rb + (size_t)c * ch;
  const float* kn = rb + (size_t)C * ch + C;
  const int h = c / ch, d0 = h * ch;
  const float rq = 1.f / sqrtf(fmaxf(rb[(size_t)C * ch + c], 1e-24f));
  const float temp = ld(temperature[h]);
  auto logit = [&](int j) { return g[j] * rq * (1.f / sqrtf(fmaxf(kn[d0 + j], 1e-24f))) * temp; };
  float mx = -INFINITY, sum = 0.f;
  if (use_softmax) {
    for (int j = lane; j < ch; j += 32) mx = fmaxf(mx, logit(j));
    mx = warp_max(mx);
    for (int j = lane; j < ch; j += 32) sum += expf(logit(j) - mx);
    sum = warp_sum(sum);
  }
  float* row = attn + ((size_t)b * C + c) * C;
  for (int k = lane; k < C; k += 32) {
    float a = 0.f;
    if (k >= d0 && k < d0 + ch) {
      const float l = logit(k - d0);
      a = use_softmax ? expf(l - mx) / sum : fmaxf(l, 0.f);
    }
    row[k] = a;
  }
}

// o = v . attn^T; the column block [n0, n0 + 64) reads only the rows of v's
// channels in its heads (attn is zero elsewhere)
template <int RM>
__global__ void __launch_bounds__(kThreads)
mdta_av_kernel(const float* __restrict__ qkv, const float* __restrict__ attn, float* __restrict__ o, int HW, int C,
               int ch) {
  GEMM_PROLOGUE
  const float* vb = qkv + ((size_t)b * HW + p0) * 3 * C + 2 * C;
  const int kbeg = (n0 / ch) * ch, kend = min(C, ((min(n0 + kNB, C) - 1) / ch + 1) * ch);
  gemm_masked<RM>(smem, attn + (size_t)b * C * C, C, C, n0, kbeg, kend, [&](int p, int k) {
    return p < np ? vb[(size_t)p * 3 * C + k] : 0.f;
  }, acc);
  float* ob = o + ((size_t)b * HW + p0) * C;
  GEMM_EPILOGUE(C, ob[(size_t)p * C + n] = a;)
}

// y = x + o . Wproj^T, fp32
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
mdta_proj_kernel(const float* __restrict__ o, const T* __restrict__ x, const T* __restrict__ wproj,
                 float* __restrict__ y, int HW, int C) {
  GEMM_PROLOGUE
  const size_t base = ((size_t)b * HW + p0) * C;
  gemm_masked<RM>(smem, wproj, C, C, n0, 0, C, [&](int p, int k) {
    return p < np ? o[base + (size_t)p * C + k] : 0.f;
  }, acc);
  GEMM_EPILOGUE(C, y[base + (size_t)p * C + n] = ld(x[base + (size_t)p * C + n]) + a;)
}

// u = LN2(y) . Win^T, (B, HW, 2F) fp32
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
mdta_ffn_in_kernel(const float* __restrict__ y, const T* __restrict__ n2w, const T* __restrict__ n2b,
                   const T* __restrict__ win, float* __restrict__ u, int HW, int C, int F, float eps, int ln_bias) {
  GEMM_PROLOGUE
  const float* yb = y + ((size_t)b * HW + p0) * C;
  float* sMu = smem + kGemmFloats;  // after the product's buffers
  float* sRs = sMu + P;
  ln_stats(yb, np, P, C, eps, sMu, sRs);
  gemm_masked<RM>(smem, win, C, 2 * F, n0, 0, C, [&](int p, int k) {
    return p < np ? ln_value(yb, C, p, k, sMu, sRs, n2w, n2b, ln_bias) : 0.f;
  }, acc);
  float* ub = u + ((size_t)b * HW + p0) * 2 * F;
  GEMM_EPILOGUE(2 * F, ub[(size_t)p * 2 * F + n] = a;)
}

// g = gelu(dw(u)[j]) * dw(u)[F + j], exact-erf GELU as F.gelu; one thread per (pixel, j)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_gate_kernel(const float* __restrict__ u, const T* __restrict__ wdw, float* __restrict__ g, int B, int H, int W,
                 int F) {
  const size_t total = (size_t)B * H * W * F;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x; idx < total; idx += (size_t)gridDim.x * kThreads) {
    const int j = (int)(idx % F);
    const size_t pix = idx / F;
    const int xx = (int)(pix % W), yy = (int)((pix / W) % H), b = (int)(pix / ((size_t)H * W));
    const float a = dw3x3(u, wdw, b, yy, xx, j, H, W, 2 * F);
    const float v = dw3x3(u, wdw, b, yy, xx, F + j, H, W, 2 * F);
    g[idx] = 0.5f * a * (1.f + erff(a * 0.70710678118654752f)) * v;
  }
}

// z = y + g . Wout^T, in the I/O type
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
mdta_ffn_out_kernel(const float* __restrict__ g, const float* __restrict__ y, const T* __restrict__ wout,
                    T* __restrict__ z, int HW, int C, int F) {
  GEMM_PROLOGUE
  const float* gb = g + ((size_t)b * HW + p0) * F;
  gemm_masked<RM>(smem, wout, F, C, n0, 0, F, [&](int p, int k) {
    return p < np ? gb[(size_t)p * F + k] : 0.f;
  }, acc);
  const size_t base = ((size_t)b * HW + p0) * C;
  GEMM_EPILOGUE(C, z[base + (size_t)p * C + n] = st<T>(y[base + (size_t)p * C + n] + a);)
}

struct Maps {
  float *t, *qkv, *part, *red, *attn, *o, *y, *u, *g;
};

inline int num_chunks(int HW) { return (HW + kChunk - 1) / kChunk; }
inline size_t stats_floats(int C, int ch) { return (size_t)C * ch + 2 * (size_t)C; }
inline int grid_1d(size_t total) { return (int)std::min<size_t>((total + kThreads - 1) / kThreads, 132 * 16); }

template <typename T, int RM>
cudaError_t launch_products(const T* x, const T* n1w, const T* n1b, const T* wqkv, const T* wdwq, const T* temp,
                            const T* wproj, const T* n2w, const T* n2b, const T* win, const T* wdwf, const T* wout,
                            T* z, const Maps& m, int B, int H, int W, int C, int F, int heads, int use_softmax,
                            int ln_bias, float eps, cudaStream_t stream) {
  constexpr int P = 16 * RM;
  const int HW = H * W, ch = C / heads, tiles = (ch + kNB - 1) / kNB;
  const int ptiles = (HW + P - 1) / P;
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  const int smem_ln = smem + 2 * P * (int)sizeof(float);
  auto cols = [](int n) { return (n + kNB - 1) / kNB; };
  cudaError_t err;
  // pass 1
  mdta_qkv_kernel<T, RM><<<dim3(ptiles, cols(3 * C), B), kThreads, smem_ln, stream>>>(x, n1w, n1b, wqkv, m.t, HW, C, eps, ln_bias);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mdta_dw_kernel<T><<<grid_1d((size_t)B * HW * 3 * C), kThreads, 0, stream>>>(m.t, wdwq, m.qkv, B, H, W, 3 * C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int chunks = num_chunks(HW);
  mdta_gram_kernel<<<dim3(chunks, heads * tiles * tiles, B), kThreads, 2 * kKC * kWS * (int)sizeof(float), stream>>>(m.qkv, m.part, HW, C, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int cn = (int)stats_floats(C, ch);
  if ((err = colsum<6>(m.part, B, chunks, cn, cn, m.red, m.part + (size_t)B * chunks * cn, stream)) != cudaSuccess)
    return err;
  // between the passes
  mdta_attn_kernel<T><<<dim3((C + kThreads / 32 - 1) / (kThreads / 32), B), kThreads, 0, stream>>>(m.red, temp, m.attn, C, ch, use_softmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // pass 2
  mdta_av_kernel<RM><<<dim3(ptiles, cols(C), B), kThreads, smem, stream>>>(m.qkv, m.attn, m.o, HW, C, ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mdta_proj_kernel<T, RM><<<dim3(ptiles, cols(C), B), kThreads, smem, stream>>>(m.o, x, wproj, m.y, HW, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mdta_ffn_in_kernel<T, RM><<<dim3(ptiles, cols(2 * F), B), kThreads, smem_ln, stream>>>(m.y, n2w, n2b, win, m.u, HW, C, F, eps, ln_bias);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mdta_gate_kernel<T><<<grid_1d((size_t)B * HW * F), kThreads, 0, stream>>>(m.u, wdwf, m.g, B, H, W, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mdta_ffn_out_kernel<T, RM><<<dim3(ptiles, cols(C), B), kThreads, smem, stream>>>(m.g, m.y, wout, z, HW, C, F);
  return cudaGetLastError();
}

template <typename T>
int mdta_block_fwd(const void* x_, const void* n1w_, const void* n1b_, const void* wqkv_, const void* wdwq_,
                   const void* temp_, const void* wproj_, const void* n2w_, const void* n2b_, const void* win_,
                   const void* wdwf_, const void* wout_, void* z_, const Maps& m, int B, int H, int W, int C, int F,
                   int heads, int use_softmax, int ln_bias, float eps, void* stream_) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  T* z = static_cast<T*>(z_);
  // 64-pixel tiles where the map has pixels enough to fill the card, 32 or 16 on the deep stages
  const long long pixels = (long long)B * H * W;
#define MDTA_LAUNCH(RM) \
  launch_products<T, RM>(p(x_), p(n1w_), p(n1b_), p(wqkv_), p(wdwq_), p(temp_), p(wproj_), p(n2w_), p(n2b_), \
                         p(win_), p(wdwf_), p(wout_), z, m, B, H, W, C, F, heads, use_softmax, ln_bias, eps, stream)
  if (pixels >= 8192) return MDTA_LAUNCH(4);
  if (pixels >= 2048) return MDTA_LAUNCH(2);
  return MDTA_LAUNCH(1);
#undef MDTA_LAUNCH
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer.  Inputs: x (B, H, W, C) and the weights in the I/O type (norm
// weights and biases (C,), Wqkv (3C, C), Wdwq (3C, 3, 3), temperature (heads,),
// Wproj (C, C), Win (2F, C), Wdwf (2F, 3, 3), Wout (C, F)); the output z
// (B, H, W, C) in the I/O type.  fp32 scratch the caller allocates: t and qkv
// (B, H, W, 3C), part (mdta_block_part_floats), red (B, C * ch + 2C) — the
// reduced Gram (B, C, ch), |q|^2 (B, C) and |k|^2 (B, C) —, attn (B, C, C),
// o and y (B, H, W, C), u (B, H, W, 2F), g (B, H, W, F).  v is qkv[..., 2C:].
// ln_bias 0 = BiasFree (the bias pointer is not read).  Returns cudaGetLastError().
#define MDTA_BLOCK_ARGS                                                                                             \
  const void *x, const void *n1w, const void *n1b, const void *wqkv, const void *wdwq, const void *temp,          \
      const void *wproj, const void *n2w, const void *n2b, const void *win, const void *wdwf, const void *wout,    \
      void *z, void *t, void *qkv, void *part, void *red, void *attn, void *o, void *y, void *u, void *g, int B,    \
      int H, int W, int C, int F, int heads, int use_softmax, int ln_bias, float eps, void *stream
#define MDTA_BLOCK_PASS                                                                                             \
  x, n1w, n1b, wqkv, wdwq, temp, wproj, n2w, n2b, win, wdwf, wout, z,                                              \
      Maps{static_cast<float*>(t), static_cast<float*>(qkv), static_cast<float*>(part), static_cast<float*>(red),   \
           static_cast<float*>(attn), static_cast<float*>(o), static_cast<float*>(y), static_cast<float*>(u),       \
           static_cast<float*>(g)},                                                                                 \
      B, H, W, C, F, heads, use_softmax, ln_bias, eps, stream

extern "C" int mdta_block_fwd_f32(MDTA_BLOCK_ARGS) { return mdta_block_fwd<float>(MDTA_BLOCK_PASS); }
extern "C" int mdta_block_fwd_bf16(MDTA_BLOCK_ARGS) { return mdta_block_fwd<__nv_bfloat16>(MDTA_BLOCK_PASS); }

// Floats of the Gram partials and colsum's scratch, so the caller can size part.
extern "C" long long mdta_block_part_floats(int B, int H, int W, int C, int heads) {
  const int chunks = num_chunks(H * W), cn = (int)stats_floats(C, C / heads);
  return (long long)B * chunks * cn + (long long)colsum_scratch(B, chunks, cn);
}
