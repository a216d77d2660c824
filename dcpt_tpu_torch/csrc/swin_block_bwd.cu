// Whole SwinIR Swin block backward on Hopper (sm_90a): K9.  fp32 or bf16 I/O, fp32 math.
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
//   B  dpre1 = (dz . Wfc2) GELU'(pre1) (in g's place, once dWfc2 has read g);
//      dyn = dpre1 . Wfc1;
//      dy = dz + LN2 backward; dacc = dy . Wproj; per window and head (A)
//      P = softmax(q k^T) again, dattn = dacc_h v_h^T, dv_h = P^T dacc_h,
//      dS = P (dattn - rowsum(dattn P)), dq_h = dS k_h hd^-0.5, dk_h = dS^T q_h
//      (q scaled, as the TPU kernel contracts it) into the head's own columns
//      of dqkv (no atomics); dxn = dqkv . Wqkv; dx = dy + LN1 backward
//   W  dWfc2 = dz^T g, dWfc1 = dpre1^T yn, dWproj = dy^T acc, dWqkv = dqkv^T xn
//      as per-chunk partials over tokens, the biases and LayerNorm affines as
//      column sums, all added by colsum<9> in a fixed order: the same bits
//      from run to run.
// Every product runs on the tensor cores, mma.sync m16n8k8 TF32 with fp32
// sums (csrc/ptx.cuh), each fp32 operand split into a high and a low TF32
// part and three products summed (3xTF32, fp32 accuracy; two where one
// operand is bf16).  The token-wide products (qkv, proj and fc1 of the
// recompute; fc2^T, fc1^T, proj^T and qkv^T of the backward) and the four
// weight gradients, with their bias sums read from the same staged chunks,
// are tc_gemm.cuh's 96 x 96 tiles (a weight gradient cut into token chunks).
// The two window passes run one block of four warps a window and head, the
// scores, the softmax and P in registers.
//
// What bounds it on this card: operations, 12 C^2 + 5 C hidden + 6 N C
// multiply-adds a token, 91 % of them in the token-wide products: 1.24 ms a
// call at batch 8, 128 x 128, with three TF32 products a multiply-add at the
// TF32 peak (chip_smoke.py::k9_work; 3.06 ms at the SIMT fp32 peak).
// mma.sync reaches a fraction of that peak; wgmma with TMA-fed tiles is the
// next step.  The LayerNorm passes and the column sums move the rest: about
// 4 GB of workspace traffic a call at batch 8.
//
// Weights come and gradients go in PyTorch's layout: every Linear as (out, in).
//
// bf16 (mixed-precision training): x, dz and the 12 parameters are read in
// bf16 through ld(); the recomputed forward, the whole backward and every
// partial sum stay fp32 in the same workspace.  dx is stored in bf16 by the
// LN1 backward, and the 12 parameter gradients are summed into fp32 staging in
// the workspace and cast once, in one launch, to bf16 (CastList), as the TPU
// kernel casts each cotangent to its primal's dtype.

#include <algorithm>

#include "common.cuh"
#include "mma_frag.cuh"
#include "tc_gemm.cuh"
#include "token_bwd.cuh"

namespace {

// out = LN(in) w + b over the C channels of each token, one token a warp (biased
// variance); the same sums in the same order as ln_bwd_kernel's statistics.
template <typename TI, typename TW>
__global__ void __launch_bounds__(kThreads)
k9_ln_kernel(const TI* __restrict__ in, const TW* __restrict__ w, const TW* __restrict__ b,
             float* __restrict__ out, int T, int C, float eps) {
  const int lane = threadIdx.x & 31, p = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (p >= T) return;
  const TI* r = in + (size_t)p * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += ld(r[c]);
  const float mu = warp_sum(s) / C;
  float var = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = ld(r[c]) - mu;
    var += d * d;
  }
  const float rs = 1.f / sqrtf(warp_sum(var) / C + eps);
  float* o = out + (size_t)p * C;
  for (int c = lane; c < C; c += 32) o[c] = (ld(r[c]) - mu) * rs * ld(w[c]) + ld(b[c]);
}

// The epilogues of the token-wide products (tc::gemm), on pairs of columns.
enum Epi { kQKV, kProj, kFc1, kGeluBwd, kPlain };

// out (T, N) gets the product's (p, n), then E:
//   kQKV      + bias[n], times scale for n < C (q)
//   kProj     + bias[n] + res[p][n]                (y = x + proj)
//   kFc1      + bias[n] into out, its GELU into out2 (pre1 and g)
//   kGeluBwd  times GELU'(src[p][n])                (src holds pre1, out gets dpre1)
//   kPlain    as it is
// bias and res (x) in the I/O type TIO.  res and src are read through the
// read-only path (__ldg): no store of the product touches them, so a thread's
// loads need not wait for its stores.
template <int E, typename TIO>
struct ProdEpi {
  float* out;
  float* out2;
  const TIO* bias;
  const TIO* res;
  const float* src;
  int N, C;
  float scale;
  __device__ __forceinline__ void one(int p, int n, float v) const {
    const size_t q = (size_t)p * N + n;
    if (E == kQKV) v = (v + ld(bias[n])) * (n < C ? scale : 1.f);
    if (E == kProj) v = ld(__ldg(res + q)) + (v + ld(bias[n]));
    if (E == kFc1) {
      v += ld(bias[n]);
      out2[q] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    }
    if (E == kGeluBwd) {
      const float x = __ldg(src + q);
      v *= 0.5f * (1.f + erff(x * 0.70710678118654752f)) + x * 0.3989422804014327f * expf(-0.5f * x * x);
    }
    out[q] = v;
  }
  __device__ __forceinline__ void operator()(int, int p, int n, float v0, float v1) const {
    one(p, n, v0);
    if (n + 1 < N) one(p, n + 1, v1);
  }
};

// The two window passes, one block of 4 warps a window and head: grid (wy (W /
// ws) + wx, b, head).  The block gathers the window's tokens of q, k and v
// (and in the backward dacc) of its head into shared memory, token-major with
// rows kTLD = 8 HDT + 4 floats apart (4 (mod 32)), zero past the tokens and
// the head's width; warp w takes query rows 16 w + [0, 16).  Every product is
// mma.sync m16n8k8 TF32 with each fp32 operand split into a high and a low
// TF32 part (3xTF32).  The scores, the softmax and P stay in the warp's
// registers: a score fragment of key tile j is the A fragment of the next
// product's depth step j, its depth slots t and t + 4 taken as the keys 2t
// and 2t + 1 (the other operand's rows read to match).  The backward stores P
// and dS (row stride kPLD = 68, 4 (mod 32)) for dk = dS^T q and dv = P^T
// dacc, which run over the key rows.  q is read as stored (scaled).
constexpr int kWin = 64;           // tokens a window holds: ws * ws <= kWin
constexpr int kAttnThreads = 128;  // 4 warps of 16 query (or key) rows
constexpr int kPLD = kWin + 4;     // row stride of P and dS

struct FragA {
  float h[4], l[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split(a0, h[0], l[0]);
    split(a1, h[1], l[1]);
    split(a2, h[2], l[2]);
    split(a3, h[3], l[3]);
  }
};
struct FragB {
  float h[2], l[2];
  __device__ __forceinline__ FragB(float b0, float b1) {
    split(b0, h[0], l[0]);
    split(b1, h[1], l[1]);
  }
};

// d += a . b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.l, b.h);
  mma_tf32(d, a.h, b.l);
  mma_tf32(d, a.h, b.h);
}

template <int HDT>  // 8-wide tiles of the head's padded width: 4 (hd <= 32) or 8 (hd <= 64)
struct AttnSmem {
  static constexpr int kTLD = 8 * HDT + 4;
  float *q, *k, *v, *d, *p, *s;
  int* pix;
  __device__ AttnSmem(float* smem, bool bwd) {
    q = smem;
    k = q + kWin * kTLD;
    v = k + kWin * kTLD;
    d = v + kWin * kTLD;
    p = bwd ? d + kWin * kTLD : nullptr;
    s = bwd ? p + kWin * kPLD : nullptr;
    pix = reinterpret_cast<int*>(bwd ? s + kWin * kPLD : d);
  }
  // floats of dynamic shared memory (ops/swin_block_bwd.py::attn_smem_bytes / 4)
  static int floats(bool bwd) { return (bwd ? 4 : 3) * kWin * kTLD + (bwd ? 2 * kWin * kPLD : 0) + kWin; }
};

inline int head_tiles(int hd) { return (hd + 7) / 8 <= 4 ? 4 : 8; }

// The window's pixels, then its tokens of q, k, v (and dacc) of head blockIdx.z into S.
template <int HDT>
__device__ __forceinline__ void attn_gather(const AttnSmem<HDT>& S, const float* __restrict__ qkv,
                                            const float* __restrict__ dacc, int H, int W, int C, int hd, int ws,
                                            int shift, int N) {
  constexpr int kTLD = AttnSmem<HDT>::kTLD;
  const int nwx = W / ws, wy = blockIdx.x / nwx, wx = blockIdx.x % nwx, b = blockIdx.y, h = blockIdx.z;
  if (threadIdx.x < kWin) {
    const int t = threadIdx.x;
    const int yy = (wy * ws + t / ws + shift) % H, xx = (wx * ws + t % ws + shift) % W;
    S.pix[t] = t < N ? (b * H + yy) * W + xx : 0;
  }
  __syncthreads();
  // kGroup rows of loads in flight before their stores
  constexpr int kIters = kWin * 8 * HDT / kAttnThreads, kGroup = 4;
  for (int i0 = 0; i0 < kIters; i0 += kGroup) {
    float v[kGroup][4];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kAttnThreads, t = idx / (8 * HDT), e = idx % (8 * HDT);
      const bool live = t < N && e < hd;
      const float* src = qkv + (size_t)S.pix[t] * 3 * C + h * hd + e;
      v[i][0] = live ? src[0] : 0.f;
      v[i][1] = live ? src[C] : 0.f;
      v[i][2] = live ? src[2 * C] : 0.f;
      v[i][3] = live && dacc ? dacc[(size_t)S.pix[t] * C + h * hd + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int idx = threadIdx.x + (i0 + i) * kAttnThreads, t = idx / (8 * HDT), e = idx % (8 * HDT);
      S.q[t * kTLD + e] = v[i][0];
      S.k[t * kTLD + e] = v[i][1];
      S.v[t * kTLD + e] = v[i][2];
      if (dacc) S.d[t * kTLD + e] = v[i][3];
    }
  }
  __syncthreads();
}

// o[j] = (a . b^T) of the warp's rows 16 w + [0, 16) of a against every token j of b
// (64 x 64), over the head's padded width: o[j][e] at rows 16 w + g (e < 2) and
// + 8, columns 8 j + 2t + e % 2.  a and b token-major.
template <int HDT>
__device__ __forceinline__ void rows_by_tokens(const float* a, const float* b, int hdp, float (&o)[8][4]) {
  constexpr int kTLD = AttnSmem<HDT>::kTLD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, r0 = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int d0 = 0; d0 < hdp; d0 += 8) {
    const float* pa = a + (r0 + g) * kTLD + d0 + t;
    const FragA fa(pa[0], pa[8 * kTLD], pa[4], pa[8 * kTLD + 4]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* pb = b + (8 * j + g) * kTLD + d0 + t;
      mma3(o[j], fa, FragB(pb[0], pb[4]));
    }
  }
}

// o[nt] += m . x for the warp's rows, m (16 rows x 64 tokens) in registers as
// rows_by_tokens leaves it, x token-major: columns 8 nt + 2t (+1) of the head;
// key tiles at or past N skipped (m is zero there).
template <int HDT>
__device__ __forceinline__ void regs_by_map(const float (&m)[8][4], const float* x, int N, float (&o)[HDT][4]) {
  constexpr int kTLD = AttnSmem<HDT>::kTLD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * j >= N) continue;
    const FragA fa(m[j][0], m[j][2], m[j][1], m[j][3]);
    const float* pb = x + (8 * j + 2 * t) * kTLD + g;
#pragma unroll
    for (int nt = 0; nt < HDT; ++nt) mma3(o[nt], fa, FragB(pb[8 * nt], pb[8 * nt + kTLD]));
  }
}

// o[nt] += m^T . x for the warp's key rows 16 w + [0, 16): m (64 queries x 64
// keys, row stride kPLD) read transposed, x token-major over the queries;
// query steps at or past N skipped (m's or x's rows are zero there).
template <int HDT>
__device__ __forceinline__ void mapT_by_map(const float* m, const float* x, int N, float (&o)[HDT][4]) {
  constexpr int kTLD = AttnSmem<HDT>::kTLD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, j0 = 16 * (threadIdx.x >> 5);
  for (int i0 = 0; i0 < N; i0 += 8) {
    const float* pa = m + (i0 + 2 * t) * kPLD + j0 + g;
    const FragA fa(pa[0], pa[8], pa[kPLD], pa[kPLD + 8]);
    const float* pb = x + (i0 + 2 * t) * kTLD + g;
#pragma unroll
    for (int nt = 0; nt < HDT; ++nt) mma3(o[nt], fa, FragB(pb[8 * nt], pb[8 * nt + kTLD]));
  }
}

// p = softmax over the keys below N of the scores in p (rows_by_tokens' layout,
// mma_frag.cuh's softmax_frags), normalised.
__device__ __forceinline__ void softmax_rows(float (&p)[8][4], int N) {
  float inv0, inv1;
  softmax_frags(p, N, inv0, inv1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[j][0] *= inv0;
    p[j][1] *= inv0;
    p[j][2] *= inv1;
    p[j][3] *= inv1;
  }
}

// Store o (rows r (+ 8) of the warp, columns 8 nt + 2t (+1)) at dst[pix[r] * ld + col] times
// scale, for rows below N and columns below hd.
template <int HDT>
__device__ __forceinline__ void store_rows(const float (&o)[HDT][4], const int* pix, int r, float* dst, size_t ld,
                                           int hd, int N, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < HDT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e / 2), col = 8 * nt + 2 * t + e % 2;
      if (row < N && col < hd) dst[(size_t)pix[row] * ld + col] = o[nt][e] * scale;
    }
}

// R: acc's columns of head h = P v for the window's tokens.
template <int HDT>
__global__ void __launch_bounds__(kAttnThreads)
k9_attn_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ acc, int H, int W, int C, int hd, int ws,
                   int shift) {
  extern __shared__ float smem[];
  const AttnSmem<HDT> S(smem, false);
  const int N = ws * ws, hdp = (hd + 7) / 8 * 8, g = (threadIdx.x & 31) >> 2, r0 = 16 * (threadIdx.x >> 5);
  attn_gather(S, qkv, nullptr, H, W, C, hd, ws, shift, N);
  float p[8][4], o[HDT][4] = {};
  rows_by_tokens<HDT>(S.q, S.k, hdp, p);
  softmax_rows(p, N);
  regs_by_map<HDT>(p, S.v, N, o);
  store_rows<HDT>(o, S.pix, r0 + g, acc + blockIdx.z * hd, C, hd, N, 1.f);
}

// A: head h's columns of dqkv (q's, k's and v's) for the window's tokens:
// dattn = dacc v^T, dS = P (dattn - rowsum(dattn P)), dq = dS k scale,
// dk = dS^T q, dv = P^T dacc.
template <int HDT>
__global__ void __launch_bounds__(kAttnThreads)
k9_attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dacc, float* __restrict__ dqkv, int H,
                   int W, int C, int hd, int ws, int shift, float scale) {
  extern __shared__ float smem[];
  const AttnSmem<HDT> S(smem, true);
  const int N = ws * ws, hdp = (hd + 7) / 8 * 8, h = blockIdx.z;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3, r0 = 16 * (threadIdx.x >> 5);
  attn_gather(S, qkv, dacc, H, W, C, hd, ws, shift, N);
  float p[8][4], ds[8][4];
  rows_by_tokens<HDT>(S.q, S.k, hdp, p);
  softmax_rows(p, N);
  rows_by_tokens<HDT>(S.d, S.v, hdp, ds);  // dattn
  float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dot0 = fmaf(ds[j][0], p[j][0], fmaf(ds[j][1], p[j][1], dot0));
    dot1 = fmaf(ds[j][2], p[j][2], fmaf(ds[j][3], p[j][3], dot1));
  }
  dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
  dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
  dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
  dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ds[j][0] = p[j][0] * (ds[j][0] - dot0);
    ds[j][1] = p[j][1] * (ds[j][1] - dot0);
    ds[j][2] = p[j][2] * (ds[j][2] - dot1);
    ds[j][3] = p[j][3] * (ds[j][3] - dot1);
    float* pr = S.p + (r0 + g) * kPLD + 8 * j + 2 * t;
    float* sr = S.s + (r0 + g) * kPLD + 8 * j + 2 * t;
    pr[0] = p[j][0], pr[1] = p[j][1], pr[8 * kPLD] = p[j][2], pr[8 * kPLD + 1] = p[j][3];
    sr[0] = ds[j][0], sr[1] = ds[j][1], sr[8 * kPLD] = ds[j][2], sr[8 * kPLD + 1] = ds[j][3];
  }
  float* out = dqkv + h * hd;
  float o[HDT][4] = {};
  regs_by_map<HDT>(ds, S.k, N, o);  // dq
  store_rows<HDT>(o, S.pix, r0 + g, out, 3 * (size_t)C, hd, N, scale);
  __syncthreads();  // P and dS are in
  float o2[HDT][4] = {};
  mapT_by_map<HDT>(S.s, S.q, N, o2);  // dk
  store_rows<HDT>(o2, S.pix, r0 + g, out + C, 3 * (size_t)C, hd, N, 1.f);
  float o3[HDT][4] = {};
  mapT_by_map<HDT>(S.p, S.d, N, o3);  // dv
  store_rows<HDT>(o3, S.pix, r0 + g, out + 2 * C, 3 * (size_t)C, hd, N, 1.f);
}

// The 12 parameter gradients' lengths in floats, in the entry's order (dln1_w,
// dln1_b, dWqkv, dbqkv, dWproj, dbproj, dln2_w, dln2_b, dWfc1, dbfc1, dWfc2, dbfc2).
constexpr int kParams = 12;

void param_lengths(int C, int hidden, long long* len) {
  const long long c = C, h = hidden;
  const long long l[kParams] = {c, c, 3 * c * c, 3 * c, c * c, c, c, c, h * c, h, c * h, c};
  for (int k = 0; k < kParams; ++k) len[k] = l[k];
}

// The workspace: the recomputed forward, the cotangent maps, every partial sum,
// colsum's scratch, and in a bf16 call the fp32 staging of the parameter gradients.
struct Plan {
  int B, H, W, C, heads, hd, hidden, T, nrb;
  size_t xn, qkv, acc, y, yn, pre, g, dm, dy, dqkv, prow, pw, pb, sum, stage, total;
};

Plan make_plan(int B, int H, int W, int C, int heads, int hidden, bool bf16) {
  Plan pl;
  pl.B = B; pl.H = H; pl.W = W; pl.C = C; pl.heads = heads; pl.hidden = hidden;
  pl.hd = C / heads;
  pl.T = B * H * W;
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
  pl.pre = take(n * hidden);  // pre1
  pl.g = take(n * hidden);    // g, then dpre1
  pl.dm = take(n * C);        // dyn, then dacc, then dxn
  pl.dy = take(n * C);
  pl.dqkv = take(n * 3 * C);
  pl.prow = take((size_t)pl.nrb * 2 * C);
  size_t pw = 0, pb = 0, sum = 0;
  const int shapes[4][2] = {{C, hidden}, {hidden, C}, {C, C}, {3 * C, C}};
  for (const auto& s : shapes) wgrad_floats(s[0], s[1], pl.T, &pw, &pb, &sum);
  pl.pw = take(pw);
  pl.pb = take(pb);
  sum = std::max(sum, colsum_scratch(1, pl.nrb, C));
  pl.sum = take(sum);
  long long len[kParams], staged = 0;
  param_lengths(C, hidden, len);
  for (long long l : len) staged += l;
  pl.stage = take(bf16 ? (size_t)staged : 0);
  pl.total = off;
  return pl;
}

template <typename T>
struct Weights {
  const T *ln1w, *ln1b, *wqkv, *bqkv, *wproj, *bproj, *ln2w, *ln2b, *wfc1, *bfc1, *wfc2, *bfc2;
};

// dx in the I/O type, the parameter gradients in fp32 (the caller's, or the staging of a bf16 call)
template <typename T>
struct Grads {
  T* dx;
  float *dln1w, *dln1b, *dwqkv, *dbqkv, *dwproj, *dbproj, *dln2w, *dln2b, *dwfc1, *dbfc1, *dwfc2, *dbfc2;
};

#define CHECK(call) \
  if ((err = (call)) != cudaSuccess) return err;

// out (T, N) = a (T, K) . W^T with W (N, K) as stored (PyTorch's (out, in), the
// forward's products), or with WT a . W, W (K, N) (the same weight read the
// other way, the backward's), then the epilogue E
template <bool WT, int E, typename TA, typename TIO>
cudaError_t prod(const Plan& pl, const TA* a, const TIO* w, const TIO* bias, const TIO* res, float* out,
                 float* out2, int K, int N, cudaStream_t s, float scale = 1.f, const float* src = nullptr) {
  const ProdEpi<E, TIO> epi{out, out2, bias, res, src, N, pl.C, scale};
  return tc::gemm<9>(tc::operand<true>(a, K, pl.T), tc::operand<!WT>(w, WT ? N : K, N), K, 1, K, epi, nullptr, s);
}

template <typename TI, typename TW>
cudaError_t layer_norm(const Plan& pl, const TI* in, const TW* w, const TW* b, float* out, float eps,
                       cudaStream_t stream) {
  constexpr int per = kThreads / 32;
  k9_ln_kernel<TI, TW><<<(pl.T + per - 1) / per, kThreads, 0, stream>>>(in, w, b, out, pl.T, pl.C, eps);
  return cudaGetLastError();
}

// A window pass (BWD: the attention backward) over every window and head.
template <bool BWD, int HDT>
cudaError_t attention_pass(const Plan& pl, const float* qkv, const float* dacc, float* out, int ws, int shift,
                           cudaStream_t stream) {
  const int smem = AttnSmem<HDT>::floats(BWD) * (int)sizeof(float);
  const dim3 grid((pl.H / ws) * (pl.W / ws), pl.B, pl.heads);
  cudaError_t err;
  if (BWD) {
    CHECK(cudaFuncSetAttribute(k9_attn_bwd_kernel<HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    k9_attn_bwd_kernel<HDT><<<grid, kAttnThreads, smem, stream>>>(qkv, dacc, out, pl.H, pl.W, pl.C, pl.hd, ws, shift,
                                                                 1.f / sqrtf((float)pl.hd));
  } else {
    CHECK(cudaFuncSetAttribute(k9_attn_fwd_kernel<HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    k9_attn_fwd_kernel<HDT><<<grid, kAttnThreads, smem, stream>>>(qkv, out, pl.H, pl.W, pl.C, pl.hd, ws, shift);
  }
  return cudaGetLastError();
}

template <bool BWD>
cudaError_t attention(const Plan& pl, const float* qkv, const float* dacc, float* out, int ws, int shift,
                      cudaStream_t stream) {
  return head_tiles(pl.hd) == 4 ? attention_pass<BWD, 4>(pl, qkv, dacc, out, ws, shift, stream)
                                : attention_pass<BWD, 8>(pl, qkv, dacc, out, ws, shift, stream);
}

// LN backward: out = res + the backward through LN(v), and the weight and bias gradients
template <typename TV, typename TR, typename TW, typename TO>
cudaError_t ln_bwd(const Plan& pl, float* ws, const TV* v, const float* dln, const TR* res, const TW* w, TO* out,
                   float* dw, float* db, float eps, cudaStream_t stream) {
  const int C = pl.C;
  ln_bwd_kernel<9, TV, TR, TW, TO><<<pl.nrb, kThreads, 4 * kRP * sizeof(float), stream>>>(
      v, dln, res, w, nullptr, out, nullptr, ws + pl.prow, pl.T, C, eps, 1);
  cudaError_t err;
  CHECK(cudaGetLastError());
  CHECK(colsum<9>(ws + pl.prow, 1, pl.nrb, C, 2 * C, dw, ws + pl.sum, stream));
  return colsum<9>(ws + pl.prow + C, 1, pl.nrb, C, 2 * C, db, ws + pl.sum, stream);
}

template <typename T>
int swin_block_bwd(const T* x, const T* dz, const Weights<T>& wt, const Grads<T>& gr, float* ws, const Plan& pl,
                   int wsz, int shift, float eps, cudaStream_t stream) {
  const int C = pl.C, hidden = pl.hidden;
  float *xn = ws + pl.xn, *qkv = ws + pl.qkv, *acc = ws + pl.acc, *y = ws + pl.y, *yn = ws + pl.yn;
  float *pre = ws + pl.pre, *g = ws + pl.g, *dm = ws + pl.dm, *dy = ws + pl.dy, *dqkv = ws + pl.dqkv;
  float *pw = ws + pl.pw, *pb = ws + pl.pb, *sum = ws + pl.sum;
  const T* none = nullptr;
  cudaError_t err;
  // R: recompute the forward
  CHECK(layer_norm(pl, x, wt.ln1w, wt.ln1b, xn, eps, stream));
  CHECK((prod<false, kQKV>(pl, static_cast<const float*>(xn), wt.wqkv, wt.bqkv, none, qkv, nullptr, C, 3 * C, stream,
                           1.f / sqrtf((float)pl.hd))));
  CHECK(attention<false>(pl, qkv, nullptr, acc, wsz, shift, stream));
  CHECK((prod<false, kProj>(pl, static_cast<const float*>(acc), wt.wproj, wt.bproj, x, y, nullptr, C, C, stream)));
  CHECK(layer_norm(pl, static_cast<const float*>(y), wt.ln2w, wt.ln2b, yn, eps, stream));
  CHECK((prod<false, kFc1>(pl, static_cast<const float*>(yn), wt.wfc1, wt.bfc1, none, pre, g, C, hidden, stream)));
  // B and W: the MLP and LN2
  CHECK(wgrad<9>(dz, C, g, hidden, pl.T, pw, pb, sum, gr.dwfc2, gr.dbfc2, stream));  // before dpre1 takes g's place
  CHECK((prod<true, kGeluBwd>(pl, dz, wt.wfc2, none, none, g, nullptr, C, hidden, stream, 1.f, pre)));
  CHECK((prod<true, kPlain>(pl, static_cast<const float*>(g), wt.wfc1, none, none, dm, nullptr, hidden, C, stream)));
  CHECK(wgrad<9>(static_cast<const float*>(g), hidden, yn, C, pl.T, pw, pb, sum, gr.dwfc1, gr.dbfc1, stream));
  CHECK(ln_bwd(pl, ws, static_cast<const float*>(y), dm, dz, wt.ln2w, dy, gr.dln2w, gr.dln2b, eps, stream));
  // proj, the attention, qkv and LN1
  CHECK((prod<true, kPlain>(pl, static_cast<const float*>(dy), wt.wproj, none, none, dm, nullptr, C, C, stream)));
  CHECK(wgrad<9>(static_cast<const float*>(dy), C, acc, C, pl.T, pw, pb, sum, gr.dwproj, gr.dbproj, stream));
  CHECK(attention<true>(pl, qkv, dm, dqkv, wsz, shift, stream));
  CHECK((prod<true, kPlain>(pl, static_cast<const float*>(dqkv), wt.wqkv, none, none, dm, nullptr, 3 * C, C,
                            stream)));
  CHECK(wgrad<9>(static_cast<const float*>(dqkv), 3 * C, xn, C, pl.T, pw, pb, sum, gr.dwqkv, gr.dbqkv, stream));
  CHECK(ln_bwd(pl, ws, x, dm, static_cast<const float*>(dy), wt.ln1w, gr.dx, gr.dln1w, gr.dln1b, eps, stream));
  return cudaSuccess;
}

#undef CHECK

#define SWIN_BWD_ARGS                                                                                               \
  const void *x, const void *dz, const void *ln1w, const void *ln1b, const void *wqkv, const void *bqkv,           \
      const void *wproj, const void *bproj, const void *ln2w, const void *ln2b, const void *wfc1, const void *bfc1, \
      const void *wfc2, const void *bfc2, void *dx, void *dln1w, void *dln1b, void *dwqkv, void *dbqkv,             \
      void *dwproj, void *dbproj, void *dln2w, void *dln2b, void *dwfc1, void *dbfc1, void *dwfc2, void *dbfc2,    \
      void *ws, int B, int H, int W, int C, int heads, int wsz, int shift, int hidden, float eps, void *stream
#define SWIN_BWD_PASS                                                                                               \
  x, dz, ln1w, ln1b, wqkv, bqkv, wproj, bproj, ln2w, ln2b, wfc1, bfc1, wfc2, bfc2, dx, dln1w, dln1b, dwqkv, dbqkv, \
      dwproj, dbproj, dln2w, dln2b, dwfc1, dbfc1, dwfc2, dbfc2, ws, B, H, W, C, heads, wsz, shift, hidden, eps,    \
      stream

template <typename T>
int swin_block_bwd_entry(SWIN_BWD_ARGS) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  constexpr bool f32 = sizeof(T) == sizeof(float);
  const Plan pl = make_plan(B, H, W, C, heads, hidden, !f32);
  float* wsf = static_cast<float*>(ws);
  void* outs[kParams] = {dln1w, dln1b, dwqkv, dbqkv, dwproj, dbproj, dln2w, dln2b, dwfc1, dbfc1, dwfc2, dbfc2};
  long long len[kParams];
  param_lengths(C, hidden, len);
  const StagedGrads<T, kParams> sg(outs, len, wsf + pl.stage);
  float* const* gs = sg.g32;
  const Weights<T> wt{p(ln1w), p(ln1b), p(wqkv), p(bqkv), p(wproj), p(bproj),
                      p(ln2w), p(ln2b), p(wfc1), p(bfc1), p(wfc2), p(bfc2)};
  const Grads<T> gr{static_cast<T*>(dx), gs[0], gs[1], gs[2], gs[3], gs[4], gs[5], gs[6], gs[7], gs[8], gs[9], gs[10],
                    gs[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = swin_block_bwd<T>(p(x), p(dz), wt, gr, wsf, pl, wsz, shift, eps, s);
  if (err != cudaSuccess) return err;
  return sg.cast(s);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device pointer,
// in the I/O type (f32: float, bf16: bfloat16).  Inputs: x and dz (B, H, W, C);
// the norm weights and biases (C,); Wqkv (3C, C), bqkv (3C,), Wproj (C, C),
// bproj (C,), Wfc1 (hidden, C), bfc1 (hidden,), Wfc2 (C, hidden), bfc2 (C,).
// Outputs: dx (B, H, W, C) and the 12 parameter gradients in the same layouts.
// ws holds swin_block_bwd_workspace_floats(..., bf16) floats.  H and W are
// multiples of wsz, wsz * wsz <= 64, 0 <= shift < wsz.  Returns the first CUDA
// error, or 0.
extern "C" int swin_block_bwd_f32(SWIN_BWD_ARGS) { return swin_block_bwd_entry<float>(SWIN_BWD_PASS); }
extern "C" int swin_block_bwd_bf16(SWIN_BWD_ARGS) { return swin_block_bwd_entry<__nv_bfloat16>(SWIN_BWD_PASS); }

extern "C" long long swin_block_bwd_workspace_floats(int B, int H, int W, int C, int heads, int hidden, int bf16) {
  return (long long)make_plan(B, H, W, C, heads, hidden, bf16 != 0).total;
}
