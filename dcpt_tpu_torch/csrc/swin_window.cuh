// One SwinIR window in one block of 256 threads: the body shared by K8 (the
// whole Swin block, csrc/swin_block.cu) and K10 (the window attention,
// csrc/window_attention.cu).  SIMT fp32 math, fp32 or bf16 I/O.
//
// No roll and no partition: every op of the block except the attention is per
// token, and roll -> partition -> ... -> reverse -> roll back is a permutation
// followed by its inverse.  So the block of window (b, wy, wx) gathers its
// tokens from the (B, H, W, C) map by index, token (ty, tx) being pixel
// ((wy ws + ty + shift) mod H, (wx ws + tx + shift) mod W), and writes its
// result back to the same pixels.  That is dcpt_tpu's roll(-shift) ->
// window_partition -> kernel -> window_reverse -> roll(+shift) exactly,
// including the attention across the image seam of a shifted block (SwinIR
// as modified here has no shift mask and no bias table).
//
// A window's maps stay in shared memory from the load to the store, each
// TRANSPOSED (channel-major: element (token p, channel c) at c * kLDP + p), so
// that a thread reads the four tokens of its rows with one 16-byte load:
//   sXT  x, then y = x + attn, then y + the MLP's column sums      C rows
//   sNT  LN1(x), then LN2(y)                                        C rows
//   sOT  the heads' outputs, then one 64-wide chunk of the MLP's hidden map
//   sQT sKT  one head's q (scaled after its bias) and k             hd rows
//   sV   the head's v, token-major (v[m][d] at m * ldv + d)
//   sST  the head's scores, then its softmax, transposed (m * kLDP + p)
//   sW   a 32-deep chunk of 64 weight rows, streamed from global memory
// Each product is win_gemm: the block's 64 tokens times 64 output columns,
// thread (tx, ty) = (threadIdx.x % 16, threadIdx.x / 16) owning tokens
// 4 ty + r and columns 4 tx + i, r, i < 4: per depth step one 16-byte load
// of A and one of the weights feed 16 FMAs.  Heads run one after another;
// the MLP runs in chunks of 64 hidden channels whose fc2 products add into
// sXT in chunk order.  Every sum runs in a fixed order and there are no
// atomics, so two runs give the same bits.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTok = 64;    // tokens a block holds: ws * ws <= kTok
constexpr int kLDP = 68;    // row stride of a transposed map: 64 tokens + 4 (16-byte rows)
constexpr int kWinKC = 32;  // depth of a streamed weight chunk
constexpr int kWLD = 68;    // row stride of the weight chunk: 64 columns + 4

struct WinLayout {
  int hd, ldv, orows;
  __host__ __device__ WinLayout(int C, int heads)
      : hd(C / heads), ldv(((C / heads + 63) / 64) * 64 + 4), orows(C < 64 ? 64 : C) {}
  // floats of dynamic shared memory a block takes (ops/window_attention.py::smem_bytes / 4)
  __host__ __device__ int floats(int C) const {
    return kLDP * (2 * C + orows + 2 * hd + kTok) + kTok * ldv + kWinKC * kWLD + 7 * kTok;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  float4 v;
  v.x = a;
  v.y = b;
  v.z = c;
  v.w = d;
  *reinterpret_cast<float4*>(p) = v;
}

// acc[r][i] += a[r] * w[i]
__device__ __forceinline__ void fma_tile(const float4& a, const float4& w, float (&acc)[4][4]) {
  const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(av[r], wv[i], acc[r][i]);
}

// acc[r][i] = sum over k < K of A(4 ty + r, k) * wrow(4 tx + i)[k] (zero for
// columns >= ncols), A(p, k) = sAT[k * kLDP + p] in shared memory; wrow(n)
// points at the global weight row of output column n (PyTorch's (out, in)
// layout).  The weights stream through sW in 32-deep chunks; each thread
// loads its 8 values of the next chunk into registers while the block
// computes on the current one, so the L2's latency hides behind the FMAs.  A
// warp reads 8 consecutive k of 4 rows and stores them to 32 distinct banks.
// Begins with a barrier, so the caller may write what the previous product
// read once this returns.
template <typename WRow>
__device__ __forceinline__ void win_gemm(const float* sAT, int K, int ncols, WRow wrow, float* sW,
                                         float (&acc)[4][4]) {
  constexpr int kPer = kWinKC * 64 / kThreads;  // weights a thread stages per chunk
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  float next[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int kk = (idx & 7) | (((idx >> 5) & 3) << 3), n = ((idx >> 3) & 3) | ((idx >> 7) << 2);
      next[e] = k0 + kk < K && n < ncols ? ld(wrow(n)[k0 + kk]) : 0.f;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kWinKC) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      sW[((idx & 7) | (((idx >> 5) & 3) << 3)) * kWLD + (((idx >> 3) & 3) | ((idx >> 7) << 2))] = next[e];
    }
    __syncthreads();
    if (k0 + kWinKC < K) fetch(k0 + kWinKC);
    const int kn = min(kWinKC, K - k0);
    const float* a = sAT + k0 * kLDP + 4 * ty;
    const float* w = sW + 4 * tx;
    if (kn == kWinKC) {  // a whole chunk: unrolled, so the loads run ahead of the FMAs
#pragma unroll
      for (int j = 0; j < kWinKC; ++j) fma_tile(ld4(a + j * kLDP), ld4(w + j * kWLD), acc);
    } else {
#pragma unroll 4
      for (int j = 0; j < kn; ++j) fma_tile(ld4(a + j * kLDP), ld4(w + j * kWLD), acc);
    }
  }
}

// LayerNorm over the C channels of each token of srcT into dstT (both
// transposed): 4 threads a token sum every fourth channel, their partials are
// added in a fixed order (two passes, biased variance), then every thread.
template <typename T>
__device__ __forceinline__ void win_layer_norm(const float* srcT, float* dstT, int C, const T* w, const T* b,
                                               float eps, float* sRed, float* sMu, float* sRs) {
  const int p = threadIdx.x & 63, part = threadIdx.x >> 6;
  float s = 0.f;
  for (int c = part; c < C; c += 4) s += srcT[c * kLDP + p];
  sRed[part * kTok + p] = s;
  __syncthreads();
  const float mu = (sRed[p] + sRed[kTok + p] + sRed[2 * kTok + p] + sRed[3 * kTok + p]) / C;
  __syncthreads();
  float v = 0.f;
  for (int c = part; c < C; c += 4) {
    const float d = srcT[c * kLDP + p] - mu;
    v += d * d;
  }
  sRed[part * kTok + p] = v;
  __syncthreads();
  if (part == 0) {
    sMu[p] = mu;
    sRs[p] = 1.f / sqrtf((sRed[p] + sRed[kTok + p] + sRed[2 * kTok + p] + sRed[3 * kTok + p]) / C + eps);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < C * kTok; idx += kThreads) {
    const int c = idx >> 6, q = idx & 63;
    dstT[c * kLDP + q] = (srcT[c * kLDP + q] - sMu[q]) * sRs[q] * ld(w[c]) + ld(b[c]);
  }
  __syncthreads();
}

// The window of block (blockIdx.x = wy * (W / ws) + wx, blockIdx.y = b).
// LN1: LayerNorm before qkv.  BLOCK: the whole Swin block into out (K8);
// otherwise out gets the attention branch alone, proj's output (K10).
// Tokens p >= N = ws * ws (windows smaller than 8 x 8) are computed on
// whatever their columns hold and never read into a token p < N or stored.
template <typename T, bool LN1, bool BLOCK>
__device__ __forceinline__ void swin_window_body(
    float* smem, const T* __restrict__ x, const T* __restrict__ ln1w, const T* __restrict__ ln1b,
    const T* __restrict__ wqkv, const T* __restrict__ bqkv, const T* __restrict__ wproj, const T* __restrict__ bproj,
    const T* __restrict__ ln2w, const T* __restrict__ ln2b, const T* __restrict__ wfc1, const T* __restrict__ bfc1,
    const T* __restrict__ wfc2, const T* __restrict__ bfc2, T* __restrict__ out, int H, int W, int C, int heads,
    int ws, int shift, int hidden, float eps) {
  const WinLayout L(C, heads);
  const int hd = L.hd, ldv = L.ldv;
  const int N = ws * ws;
  float* sXT = smem;
  float* sNT = sXT + C * kLDP;
  float* sOT = sNT + C * kLDP;
  float* sQT = sOT + L.orows * kLDP;
  float* sKT = sQT + hd * kLDP;
  float* sST = sKT + hd * kLDP;
  float* sV = sST + kTok * kLDP;
  float* sW = sV + kTok * ldv;
  float* sRed = sW + kWinKC * kWLD;
  float* sMu = sRed + 4 * kTok;
  float* sRs = sMu + kTok;
  int* sPix = reinterpret_cast<int*>(sRs + kTok);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nwx = W / ws, wy = blockIdx.x / nwx, wx = blockIdx.x % nwx, b = blockIdx.y;
  float acc[4][4];

  // the window's pixels, then its tokens of x in fp32
  if (threadIdx.x < N) {
    const int t = threadIdx.x;
    const int yy = (wy * ws + t / ws + shift) % H, xx = (wx * ws + t % ws + shift) % W;
    sPix[t] = (b * H + yy) * W + xx;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int p = idx / C, c = idx % C;
    sXT[c * kLDP + p] = ld(x[(size_t)sPix[p] * C + c]);
  }
  __syncthreads();
  const float* sAT = sXT;
  if (LN1) {
    win_layer_norm(sXT, sNT, C, ln1w, ln1b, eps, sRed, sMu, sRs);
    sAT = sNT;
  }

  // attention, one head at a time; head h's output goes to sOT's rows [h hd, (h + 1) hd)
  const float scale = 1.f / sqrtf((float)hd);
  for (int h = 0; h < heads; ++h) {
    // q, k, v of the head: output column j < 3 hd is row (j / hd) C + h hd + j % hd of Wqkv
    for (int n0 = 0; n0 < 3 * hd; n0 += 64) {
      win_gemm(sAT, C, min(64, 3 * hd - n0),
               [&](int n) { const int j = n0 + n; return wqkv + (size_t)((j / hd) * C + h * hd + j % hd) * C; },
               sW, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = n0 + 4 * tx + i;
        if (j >= 3 * hd) continue;
        const int part = j / hd, d = j % hd;
        const float bias = ld(bqkv[part * C + h * hd + d]);
        if (part == 2) {
#pragma unroll
          for (int r = 0; r < 4; ++r) sV[(4 * ty + r) * ldv + d] = acc[r][i] + bias;
        } else {
          const float s = part == 0 ? scale : 1.f;
          st4((part == 0 ? sQT : sKT) + d * kLDP + 4 * ty, (acc[0][i] + bias) * s, (acc[1][i] + bias) * s,
              (acc[2][i] + bias) * s, (acc[3][i] + bias) * s);
        }
      }
    }
    __syncthreads();
    // scores q k^T, stored transposed: sST[m * kLDP + p]
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    for (int d = 0; d < hd; ++d) fma_tile(ld4(sQT + d * kLDP + 4 * ty), ld4(sKT + d * kLDP + 4 * tx), acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) st4(sST + (4 * tx + i) * kLDP + 4 * ty, acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
    __syncthreads();
    // softmax over each token's N keys, the maximum subtracted: 4 threads a
    // token take 16 keys each, their partials are combined in a fixed order
    {
      const int p = threadIdx.x & 63, part = threadIdx.x >> 6;
      const int m0 = part * 16, m1 = min(N, m0 + 16);
      float mx = -INFINITY;
      for (int m = m0; m < m1; ++m) mx = fmaxf(mx, sST[m * kLDP + p]);
      sRed[part * kTok + p] = mx;
      __syncthreads();
      mx = fmaxf(fmaxf(sRed[p], sRed[kTok + p]), fmaxf(sRed[2 * kTok + p], sRed[3 * kTok + p]));
      __syncthreads();
      float sum = 0.f;
      for (int m = m0; m < m1; ++m) {
        const float e = expf(sST[m * kLDP + p] - mx);
        sST[m * kLDP + p] = e;
        sum += e;
      }
      sRed[part * kTok + p] = sum;
      __syncthreads();
      const float inv = 1.f / (((sRed[p] + sRed[kTok + p]) + sRed[2 * kTok + p]) + sRed[3 * kTok + p]);
      for (int m = m0; m < m1; ++m) sST[m * kLDP + p] *= inv;
    }
    __syncthreads();
    // the head's output attn . v into sOT, 64 channels of the head at a time
    for (int d0 = 0; d0 < hd; d0 += 64) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
      for (int m = 0; m < N; ++m) fma_tile(ld4(sST + m * kLDP + 4 * ty), ld4(sV + m * ldv + d0 + 4 * tx), acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + 4 * tx + i;
        if (d < hd) st4(sOT + (h * hd + d) * kLDP + 4 * ty, acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
      }
    }
    // the next head's first product begins with a barrier
  }

  // proj: K10 writes it to its pixels; K8 adds it to x in sXT (y = x + attn)
  for (int n0 = 0; n0 < C; n0 += 64) {
    win_gemm(sOT, C, min(64, C - n0), [&](int n) { return wproj + (size_t)(n0 + n) * C; }, sW, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + 4 * tx + i;
      if (n >= C) continue;
      const float bias = ld(bproj[n]);
      if (BLOCK) {
        float* row = sXT + n * kLDP + 4 * ty;
        const float4 y = ld4(row);
        st4(row, y.x + (acc[0][i] + bias), y.y + (acc[1][i] + bias), y.z + (acc[2][i] + bias),
            y.w + (acc[3][i] + bias));
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = 4 * ty + r;
          if (p < N) out[(size_t)sPix[p] * C + n] = st<T>(acc[r][i] + bias);
        }
      }
    }
  }
  if (!BLOCK) return;
  __syncthreads();

  // MLP: LN2(y) into sNT; per 64-wide chunk of the hidden width, h = GELU(fc1)
  // into sOT, then sXT += (h . Wfc2[:, chunk]^T)^T, chunk by chunk
  win_layer_norm(sXT, sNT, C, ln2w, ln2b, eps, sRed, sMu, sRs);
  for (int j0 = 0; j0 < hidden; j0 += 64) {
    const int nh = min(64, hidden - j0);
    win_gemm(sNT, C, nh, [&](int n) { return wfc1 + (size_t)(j0 + n) * C; }, sW, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * tx + i;
      if (n >= nh) continue;
      const float bias = ld(bfc1[j0 + n]);
      float g[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = acc[r][i] + bias;
        g[r] = 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
      }
      st4(sOT + n * kLDP + 4 * ty, g[0], g[1], g[2], g[3]);
    }
    for (int n0 = 0; n0 < C; n0 += 64) {
      win_gemm(sOT, nh, min(64, C - n0), [&](int n) { return wfc2 + (size_t)(n0 + n) * hidden + j0; }, sW, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + 4 * tx + i;
        if (n >= C) continue;
        float* row = sXT + n * kLDP + 4 * ty;
        const float4 y = ld4(row);
        st4(row, y.x + acc[0][i], y.y + acc[1][i], y.z + acc[2][i], y.w + acc[3][i]);
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int p = idx / C, c = idx % C;
    out[(size_t)sPix[p] * C + c] = st<T>(sXT[c * kLDP + p] + ld(bfc2[c]));
  }
}

// Launch `kernel` over the B * (H / ws) * (W / ws) windows with the shared memory it needs.
template <typename K, typename... Args>
inline cudaError_t launch_windows(K kernel, int B, int H, int W, int C, int heads, int ws, cudaStream_t stream,
                                  Args... args) {
  const int smem = WinLayout(C, heads).floats(C) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((H / ws) * (W / ws), B), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
