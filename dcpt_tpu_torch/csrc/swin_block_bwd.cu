// Whole SwinIR Swin block backward on Hopper (sm_90a): K9.  fp32 I/O, fp32 math.
//
// Replaces the TPU kernel dcpt_tpu/ops/swin_block_bwd.py::swin_block_bwd
// (_block_bwd_kernel).  Given the upstream cotangent dz of z =
// swin_block_map_ref(x, ...) on a (B, H, W, C) map with windows of ws x ws
// shifted by `shift`, it computes all 13 cotangents: dx and the 12 parameter
// gradients.  Like the TPU kernel it reads x alone and recomputes the forward:
// the autograd Function keeps no map of the forward (K8), and a Swin block's
// maps (LN outputs, q/k/v, the heads' output, y, fc1) would take about 1.2 GB
// a block at batch 8, 65 GB over the 54 blocks a SwinIR DCPT step
// differentiates.  The recomputed forward lives in a workspace the caller
// allocates per call (about 12 C + 2 hidden floats a token, 1.5 GB at batch 8,
// 128 x 128, C 180) and frees when the call returns.
//
// K8's block holds one window's whole forward in 204 KB of shared memory;
// the backward would need about 700 KB a window.  So the work is split into
// passes on PyTorch's current stream, each a grid over all B H W tokens, every
// map token-major in pixel order (no roll, no partition: the two window
// passes gather a window's tokens by swin_window.cuh's index map, token
// (ty, tx) of window (wy, wx) being pixel ((wy ws + ty + s) mod H,
// (wx ws + tx + s) mod W), and write back to the same pixels):
//   R  recompute: xn = LN1(x); qkv = xn . Wqkv^T + b (q times hd^-0.5);
//      acc = per window and head softmax(q k^T) v; y = x + acc . Wproj^T + b;
//      yn = LN2(y); pre1 = yn . Wfc1^T + b and g = GELU(pre1)
//   B  dpre1 = (dz . Wfc2) GELU'(pre1) (in pre1's place); dyn = dpre1 . Wfc1;
//      dy = dz + LN2 backward; dacc = dy . Wproj; per window and head (A)
//      P = softmax(q k^T) again, dattn = dacc_h v_h^T, dv_h = P^T dacc_h,
//      dS = P (dattn - rowsum(dattn P)), dq_h = dS k_h hd^-0.5, dk_h = dS^T q_h
//      (q scaled, as the TPU kernel contracts it) into the head's own columns
//      of dqkv (no atomics); dxn = dqkv . Wqkv; dx = dy + LN1 backward
//   W  dWfc2 = dz^T g, dWfc1 = dpre1^T yn, dWproj = dy^T acc, dWqkv = dqkv^T xn
//      as per-chunk partials over tokens, the biases and LayerNorm affines as
//      column sums, all added by colsum<9> in a fixed order: the same bits
//      from run to run.
// The token-wide products are gemm.cuh's gemm_masked (64 tokens x 64 output
// columns a block, ragged widths masked: head 30, C 180, hidden 360).
//
// What bounds it on this card: per token the recomputed forward (4 C^2 + 2 C
// hidden + 2 N C multiply-adds, N tokens a window) and the backward (twice
// that), about 3 x K8's work, on the SIMT fp32 pipes from shared memory:
// operations.  wgmma/TMA tiles and a window-resident recompute are the next steps.
//
// Weights come and gradients go in PyTorch's layout: every Linear as (out, in).

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"
#include "token_bwd.cuh"

namespace {

constexpr int kWin = 64;      // tokens a window holds: ws * ws <= kWin
constexpr int kLP = 65;       // row stride of a window's probabilities and dS

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// out = LN(in) w + b over the C channels of each token, one token a warp (biased
// variance); the same sums in the same order as ln_bwd_kernel's statistics.
__global__ void __launch_bounds__(kThreads)
k9_ln_kernel(const float* __restrict__ in, const float* __restrict__ w, const float* __restrict__ b,
             float* __restrict__ out, int T, int C, float eps) {
  const int lane = threadIdx.x & 31, p = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (p >= T) return;
  const float* r = in + (size_t)p * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += r[c];
  const float mu = warp_sum(s) / C;
  float var = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = r[c] - mu;
    var += d * d;
  }
  const float rs = 1.f / sqrtf(warp_sum(var) / C + eps);
  float* o = out + (size_t)p * C;
  for (int c = lane; c < C; c += 32) o[c] = (r[c] - mu) * rs * w[c] + b[c];
}

// The epilogues of k9_prod_kernel.
enum Epi { kQKV, kProj, kFc1, kGeluBwd, kPlain };

// out (T, N) = a (T, K) . W^T with W (N, K) row-major (PyTorch's (out, in), the
// forward's products), or with WT a . W, W (K, N) (the same weight read
// transposed, the backward's), then E:
//   kQKV      + bias[n], times scale for n < C (q)
//   kProj     + bias[n] + res[p][n]                (y = x + proj)
//   kFc1      + bias[n] into out, its GELU into out2 (pre1 and g)
//   kGeluBwd  times GELU'(out[p][n]) in place       (out holds pre1, becomes dpre1)
//   kPlain    as it is
// grid (token tiles of 16 RM, column blocks of kNB).
template <int RM, bool WT, int E>
__global__ void __launch_bounds__(kThreads)
k9_prod_kernel(const float* __restrict__ a, const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ res, float* out, float* __restrict__ out2, int T, int K, int N, int C,
               float scale) {
  constexpr int P = 16 * RM;
  extern __shared__ float smem[];
  const int p0 = blockIdx.x * P, n0 = blockIdx.y * kNB, np = min(P, T - p0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* ab = a + (size_t)p0 * K;
  float acc[RM][4];
  gemm_masked<RM, WT>(smem, w, WT ? N : K, N, n0, 0, K, [&](int p, int k) {
    return p < np ? ab[(size_t)p * K + k] : 0.f;
  }, acc);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p >= np || n >= N) continue;
      const size_t q = (size_t)(p0 + p) * N + n;
      float v = acc[r][i];
      if (E == kQKV) v = (v + bias[n]) * (n < C ? scale : 1.f);
      if (E == kProj) v = res[q] + (v + bias[n]);
      if (E == kFc1) {
        v += bias[n];
        out2[q] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      }
      if (E == kGeluBwd) {
        const float x = out[q];
        v *= 0.5f * (1.f + erff(x * 0.70710678118654752f)) + x * 0.3989422804014327f * expf(-0.5f * x * x);
      }
      out[q] = v;
    }
}

// One window's attention for head blockIdx.z: block (blockIdx.x = wy (W / ws) +
// wx, blockIdx.y = b).  Shared memory (floats): q, k, v, the output cotangent
// of the head (row stride hd + 1), the probabilities P and dattn / dS (row
// stride kLP), the token pixels.  q is read as stored (scaled).
struct AttnSmem {
  int ld;
  float *q, *k, *v, *d, *p, *s;
  int* pix;
  __device__ AttnSmem(float* smem, int hd) : ld(hd + 1) {
    q = smem;
    k = q + kWin * ld;
    v = k + kWin * ld;
    d = v + kWin * ld;
    p = d + kWin * ld;
    s = p + kWin * kLP;
    pix = reinterpret_cast<int*>(s + kWin * kLP);
  }
};

inline int attn_smem_floats(int hd) { return 4 * kWin * (hd + 1) + 2 * kWin * kLP + kWin; }

// Gather the window's pixels and its q, k, v (and with BWD the cotangent of the
// heads' output, dacc) of head h into S; then P = softmax(q k^T) over its N keys,
// one row a warp (the maximum subtracted, sums in a fixed order).
template <bool BWD>
__device__ __forceinline__ void attn_probs(const AttnSmem& S, const float* __restrict__ qkv,
                                           const float* __restrict__ dacc, int H, int W, int C, int hd, int ws,
                                           int shift, int N) {
  const int nwx = W / ws, wy = blockIdx.x / nwx, wx = blockIdx.x % nwx, b = blockIdx.y, h = blockIdx.z;
  const int ld = S.ld;
  if (threadIdx.x < N) {
    const int t = threadIdx.x;
    const int yy = (wy * ws + t / ws + shift) % H, xx = (wx * ws + t % ws + shift) % W;
    S.pix[t] = (b * H + yy) * W + xx;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * hd; idx += kThreads) {
    const int t = idx / hd, e = idx % hd;
    const float* src = qkv + (size_t)S.pix[t] * 3 * C + h * hd + e;
    S.q[t * ld + e] = src[0];
    S.k[t * ld + e] = src[C];
    S.v[t * ld + e] = src[2 * C];
    if (BWD) S.d[t * ld + e] = dacc[(size_t)S.pix[t] * C + h * hd + e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, j = idx % N;
    float s = 0.f;
    for (int e = 0; e < hd; ++e) s = fmaf(S.q[i * ld + e], S.k[j * ld + e], s);
    S.p[i * kLP + j] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < N; i += kThreads / 32) {
    float* r = S.p + i * kLP;
    const float s0 = lane < N ? r[lane] : -INFINITY, s1 = lane + 32 < N ? r[lane + 32] : -INFINITY;
    const float mx = warp_max(fmaxf(s0, s1));
    const float e0 = lane < N ? expf(s0 - mx) : 0.f, e1 = lane + 32 < N ? expf(s1 - mx) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    if (lane < N) r[lane] = e0 * inv;
    if (lane + 32 < N) r[lane + 32] = e1 * inv;
  }
  __syncthreads();
}

// R: acc's columns of head h = P v for the window's tokens.
__global__ void __launch_bounds__(kThreads)
k9_attn_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ acc, int H, int W, int C, int hd, int ws,
                   int shift) {
  extern __shared__ float smem[];
  const AttnSmem S(smem, hd);
  const int N = ws * ws, ld = S.ld;
  attn_probs<false>(S, qkv, nullptr, H, W, C, hd, ws, shift, N);
  for (int idx = threadIdx.x; idx < N * hd; idx += kThreads) {
    const int i = idx / hd, e = idx % hd;
    float o = 0.f;
    for (int j = 0; j < N; ++j) o = fmaf(S.p[i * kLP + j], S.v[j * ld + e], o);
    acc[(size_t)S.pix[i] * C + blockIdx.z * hd + e] = o;
  }
}

// A: head h's columns of dqkv (q's, k's and v's) for the window's tokens.
__global__ void __launch_bounds__(kThreads)
k9_attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dacc, float* __restrict__ dqkv, int H,
                   int W, int C, int hd, int ws, int shift, float scale) {
  extern __shared__ float smem[];
  const AttnSmem S(smem, hd);
  const int N = ws * ws, ld = S.ld, h = blockIdx.z;
  attn_probs<true>(S, qkv, dacc, H, W, C, hd, ws, shift, N);
  // dattn = dacc_h v_h^T
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, j = idx % N;
    float s = 0.f;
    for (int e = 0; e < hd; ++e) s = fmaf(S.d[i * ld + e], S.v[j * ld + e], s);
    S.s[i * kLP + j] = s;
  }
  __syncthreads();
  // dS = P (dattn - rowsum(dattn P)), one row a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < N; i += kThreads / 32) {
    float* pr = S.p + i * kLP;
    float* sr = S.s + i * kLP;
    float dot = 0.f;
    for (int j = lane; j < N; j += 32) dot = fmaf(sr[j], pr[j], dot);
    dot = warp_sum(dot);
    for (int j = lane; j < N; j += 32) sr[j] = pr[j] * (sr[j] - dot);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * hd; idx += kThreads) {
    const int i = idx / hd, e = idx % hd;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j < N; ++j) {
      dq = fmaf(S.s[i * kLP + j], S.k[j * ld + e], dq);  // dS k
      dk = fmaf(S.s[j * kLP + i], S.q[j * ld + e], dk);  // dS^T q
      dv = fmaf(S.p[j * kLP + i], S.d[j * ld + e], dv);  // P^T dacc
    }
    float* dst = dqkv + (size_t)S.pix[i] * 3 * C + h * hd + e;
    dst[0] = dq * scale;
    dst[C] = dk;
    dst[2 * C] = dv;
  }
}

// The workspace: the recomputed forward, the cotangent maps, every partial sum and colsum's scratch.
struct Plan {
  int B, H, W, C, heads, hd, hidden, T, rm, nrb;
  size_t xn, qkv, acc, y, yn, pre, g, dm, dy, dqkv, stats, prow, pw, sum, total;
};

Plan make_plan(int B, int H, int W, int C, int heads, int hidden) {
  Plan pl;
  pl.B = B; pl.H = H; pl.W = W; pl.C = C; pl.heads = heads; pl.hidden = hidden;
  pl.hd = C / heads;
  pl.T = B * H * W;
  pl.rm = pl.T >= 8192 ? 4 : (pl.T >= 2048 ? 2 : 1);  // token tiles that fill the card
  pl.nrb = (pl.T + kRP - 1) / kRP;
  const size_t n = pl.T;
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += (floats + 63) / 64 * 64;  // 256-byte aligned
    return at;
  };
  pl.xn = take(n * C);
  pl.qkv = take(n * 3 * C);
  pl.acc = take(n * C);
  pl.y = take(n * C);
  pl.yn = take(n * C);
  pl.pre = take(n * hidden);  // pre1, then dpre1
  pl.g = take(n * hidden);
  pl.dm = take(n * C);        // dyn, then dacc, then dxn
  pl.dy = take(n * C);
  pl.dqkv = take(n * 3 * C);
  pl.stats = take(2 * n);
  pl.prow = take((size_t)pl.nrb * 2 * C);
  size_t pw = 0, sum = 0;
  const int shapes[4][2] = {{C, hidden}, {hidden, C}, {C, C}, {3 * C, C}};
  for (const auto& s : shapes) {
    int len;
    const int nch = w_chunks(s[0], s[1], pl.T, &len);
    pw = std::max(pw, (size_t)nch * s[0] * s[1]);
    sum = std::max(sum, colsum_scratch(1, nch, s[0] * s[1]));
  }
  pl.pw = take(pw);
  for (int width : {C, hidden, 3 * C}) sum = std::max(sum, colsum_scratch(1, pl.T, width));
  sum = std::max(sum, colsum_scratch(1, pl.nrb, C));
  pl.sum = take(sum);
  pl.total = off;
  return pl;
}

struct Weights {
  const float *ln1w, *ln1b, *wqkv, *bqkv, *wproj, *bproj, *ln2w, *ln2b, *wfc1, *bfc1, *wfc2, *bfc2;
};

struct Grads {
  float *dx, *dln1w, *dln1b, *dwqkv, *dbqkv, *dwproj, *dbproj, *dln2w, *dln2b, *dwfc1, *dbfc1, *dwfc2, *dbfc2;
};

#define CHECK(call) \
  if ((err = (call)) != cudaSuccess) return err;

template <int RM, bool WT, int E>
cudaError_t launch_prod(const Plan& pl, const float* a, const float* w, const float* bias, const float* res,
                        float* out, float* out2, int K, int N, float scale, cudaStream_t stream) {
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  k9_prod_kernel<RM, WT, E><<<dim3((pl.T + 16 * RM - 1) / (16 * RM), (N + kNB - 1) / kNB), kThreads, smem,
                              stream>>>(a, w, bias, res, out, out2, pl.T, K, N, pl.C, scale);
  return cudaGetLastError();
}

template <bool WT, int E>
cudaError_t prod(const Plan& pl, const float* a, const float* w, const float* bias, const float* res, float* out,
                 float* out2, int K, int N, cudaStream_t s, float scale = 1.f) {
  return pl.rm == 4   ? launch_prod<4, WT, E>(pl, a, w, bias, res, out, out2, K, N, scale, s)
         : pl.rm == 2 ? launch_prod<2, WT, E>(pl, a, w, bias, res, out, out2, K, N, scale, s)
                      : launch_prod<1, WT, E>(pl, a, w, bias, res, out, out2, K, N, scale, s);
}

cudaError_t layer_norm(const Plan& pl, const float* in, const float* w, const float* b, float* out, float eps,
                       cudaStream_t stream) {
  constexpr int per = kThreads / 32;
  k9_ln_kernel<<<(pl.T + per - 1) / per, kThreads, 0, stream>>>(in, w, b, out, pl.T, pl.C, eps);
  return cudaGetLastError();
}

// A window pass (BWD: the attention backward) over every window and head.
template <bool BWD>
cudaError_t attention(const Plan& pl, const float* qkv, const float* dacc, float* out, int ws, int shift,
                      cudaStream_t stream) {
  const int smem = attn_smem_floats(pl.hd) * (int)sizeof(float);
  const dim3 grid((pl.H / ws) * (pl.W / ws), pl.B, pl.heads);
  cudaError_t err;
  if (BWD) {
    CHECK(cudaFuncSetAttribute(k9_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    k9_attn_bwd_kernel<<<grid, kThreads, smem, stream>>>(qkv, dacc, out, pl.H, pl.W, pl.C, pl.hd, ws, shift,
                                                         1.f / sqrtf((float)pl.hd));
  } else {
    CHECK(cudaFuncSetAttribute(k9_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    k9_attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(qkv, out, pl.H, pl.W, pl.C, pl.hd, ws, shift);
  }
  return cudaGetLastError();
}

// LN backward: out, and the weight and bias gradients
cudaError_t ln_bwd(const Plan& pl, float* ws, const float* v, const float* dln, const float* res, const float* w,
                   float* out, float* dw, float* db, float eps, cudaStream_t stream) {
  const int C = pl.C;
  ln_bwd_kernel<9><<<pl.nrb, kThreads, 4 * kRP * sizeof(float), stream>>>(v, dln, res, w, out, ws + pl.stats,
                                                                          ws + pl.prow, pl.T, C, eps, 1);
  cudaError_t err;
  CHECK(cudaGetLastError());
  CHECK(colsum<9>(ws + pl.prow, 1, pl.nrb, C, 2 * C, dw, ws + pl.sum, stream));
  return colsum<9>(ws + pl.prow + C, 1, pl.nrb, C, 2 * C, db, ws + pl.sum, stream);
}

// W: out (M, N) = sum over tokens of a (T, M) x bm (T, N); bias (M,) = the column sums of a
cudaError_t wgrad(const Plan& pl, float* ws, const float* a, int M, const float* bm, int N, float* out, float* bias,
                  cudaStream_t stream) {
  int len;
  const int nch = w_chunks(M, N, pl.T, &len);
  wgrad_kernel<9, false><<<dim3((N + kNB - 1) / kNB, (M + kNB - 1) / kNB, nch), kThreads,
                          2 * kKC * kWS * sizeof(float), stream>>>(a, M, bm, N, nullptr, nullptr, nullptr, 0,
                                                                   ws + pl.pw, pl.T, M, N, len);
  cudaError_t err;
  CHECK(cudaGetLastError());
  CHECK(colsum<9>(ws + pl.pw, 1, nch, M * N, M * N, out, ws + pl.sum, stream));
  return colsum<9>(a, 1, pl.T, M, M, bias, ws + pl.sum, stream);
}

int swin_block_bwd(const float* x, const float* dz, const Weights& wt, const Grads& gr, float* ws, int B, int H,
                   int W, int C, int heads, int wsz, int shift, int hidden, float eps, cudaStream_t stream) {
  const Plan pl = make_plan(B, H, W, C, heads, hidden);
  float *xn = ws + pl.xn, *qkv = ws + pl.qkv, *acc = ws + pl.acc, *y = ws + pl.y, *yn = ws + pl.yn;
  float *pre = ws + pl.pre, *g = ws + pl.g, *dm = ws + pl.dm, *dy = ws + pl.dy, *dqkv = ws + pl.dqkv;
  cudaError_t err;
  // R: recompute the forward
  CHECK(layer_norm(pl, x, wt.ln1w, wt.ln1b, xn, eps, stream));
  CHECK((prod<false, kQKV>(pl, xn, wt.wqkv, wt.bqkv, nullptr, qkv, nullptr, C, 3 * C, stream,
                           1.f / sqrtf((float)pl.hd))));
  CHECK(attention<false>(pl, qkv, nullptr, acc, wsz, shift, stream));
  CHECK((prod<false, kProj>(pl, acc, wt.wproj, wt.bproj, x, y, nullptr, C, C, stream)));
  CHECK(layer_norm(pl, y, wt.ln2w, wt.ln2b, yn, eps, stream));
  CHECK((prod<false, kFc1>(pl, yn, wt.wfc1, wt.bfc1, nullptr, pre, g, C, hidden, stream)));
  // B and W: the MLP and LN2
  CHECK((prod<true, kGeluBwd>(pl, dz, wt.wfc2, nullptr, nullptr, pre, nullptr, C, hidden, stream)));
  CHECK(wgrad(pl, ws, dz, C, g, hidden, gr.dwfc2, gr.dbfc2, stream));
  CHECK((prod<true, kPlain>(pl, pre, wt.wfc1, nullptr, nullptr, dm, nullptr, hidden, C, stream)));
  CHECK(wgrad(pl, ws, pre, hidden, yn, C, gr.dwfc1, gr.dbfc1, stream));
  CHECK(ln_bwd(pl, ws, y, dm, dz, wt.ln2w, dy, gr.dln2w, gr.dln2b, eps, stream));
  // proj, the attention, qkv and LN1
  CHECK((prod<true, kPlain>(pl, dy, wt.wproj, nullptr, nullptr, dm, nullptr, C, C, stream)));
  CHECK(wgrad(pl, ws, dy, C, acc, C, gr.dwproj, gr.dbproj, stream));
  CHECK(attention<true>(pl, qkv, dm, dqkv, wsz, shift, stream));
  CHECK((prod<true, kPlain>(pl, dqkv, wt.wqkv, nullptr, nullptr, dm, nullptr, 3 * C, C, stream)));
  CHECK(wgrad(pl, ws, dqkv, 3 * C, xn, C, gr.dwqkv, gr.dbqkv, stream));
  CHECK(ln_bwd(pl, ws, x, dm, dy, wt.ln1w, gr.dx, gr.dln1w, gr.dln1b, eps, stream));
  return cudaSuccess;
}

#undef CHECK

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device pointer
// to fp32.  Inputs: x and dz (B, H, W, C); the norm weights and biases (C,);
// Wqkv (3C, C), bqkv (3C,), Wproj (C, C), bproj (C,), Wfc1 (hidden, C), bfc1
// (hidden,), Wfc2 (C, hidden), bfc2 (C,).  Outputs: dx (B, H, W, C) and the 12
// parameter gradients in the same layouts.  ws holds
// swin_block_bwd_workspace_floats(...) floats.  H and W are multiples of wsz,
// wsz * wsz <= 64, 0 <= shift < wsz.  Returns the first CUDA error, or 0.
extern "C" int swin_block_bwd_f32(
    const void* x, const void* dz, const void* ln1w, const void* ln1b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ln2w, const void* ln2b, const void* wfc1, const void* bfc1,
    const void* wfc2, const void* bfc2, void* dx, void* dln1w, void* dln1b, void* dwqkv, void* dbqkv, void* dwproj,
    void* dbproj, void* dln2w, void* dln2b, void* dwfc1, void* dbfc1, void* dwfc2, void* dbfc2, void* ws, int B,
    int H, int W, int C, int heads, int wsz, int shift, int hidden, float eps, void* stream) {
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto m = [](void* v) { return static_cast<float*>(v); };
  const Weights wt{f(ln1w), f(ln1b), f(wqkv), f(bqkv), f(wproj), f(bproj),
                   f(ln2w), f(ln2b), f(wfc1), f(bfc1), f(wfc2), f(bfc2)};
  const Grads gr{m(dx), m(dln1w), m(dln1b), m(dwqkv), m(dbqkv), m(dwproj), m(dbproj),
                 m(dln2w), m(dln2b), m(dwfc1), m(dbfc1), m(dwfc2), m(dbfc2)};
  return swin_block_bwd(f(x), f(dz), wt, gr, m(ws), B, H, W, C, heads, wsz, shift, hidden, eps,
                        static_cast<cudaStream_t>(stream));
}

extern "C" long long swin_block_bwd_workspace_floats(int B, int H, int W, int C, int heads, int hidden) {
  return (long long)make_plan(B, H, W, C, heads, hidden).total;
}
