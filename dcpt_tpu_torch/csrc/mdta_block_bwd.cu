// Whole Restormer / PromptIR TransformerBlock backward on Hopper (sm_90a):
// fp32 or bf16 I/O, fp32 math.
//
// Replaces the TPU kernel dcpt_tpu/ops/mdta_block_bwd.py::mdta_block_bwd
// (_b1_kernel, the host C-space step, _b2_kernel).  Given the upstream
// cotangent dz of z = mdta_block_ref(x, ...) it computes all 12 cotangents:
// dx and the 11 parameter gradients, for any H x W >= 1 x 1, any C, F and head
// width ch = C / heads (every product masks its ragged rows, columns and depth).
//
// Residuals.  The TPU kernel recomputes LN1 -> qkv -> dwconv and
// out -> y -> LN2 -> project_in on halo windows (a 16 GB chip).  Here the
// forward kernel (mdta_block.cu) already writes t (3C), qkv (3C), o, y (C
// each), u (2F) and g (F) to device memory; under autograd the caller keeps
// them: 8C + 3F floats a pixel, about 21 GB over the 84 blocks of a batch-8
// Restormer DCPT step at 128 x 128 on an 80 GB card.  Recomputing them would
// repeat the forward's 4C^2 + 3FC multiply-adds a pixel on the SIMT pipes.  So
// nothing is recomputed but the per-pixel LayerNorm statistics and the
// depthwise output of u at the gate (9 taps a channel).
//
// Passes, on PyTorch's current stream (the products are grids of pixel tiles
// x 64 output columns x batch, gemm.cuh's gemm_masked):
//   G   dg = dz . Wout, and in its epilogue the gate backward with
//       a = dw(u)[j], b = dw(u)[F + j]:  dd = [dg b gelu'(a), dg gelu(a)]
//   DW  (2F channels) du = the transposed 3x3 stencil of dd; per-chunk
//       partials of dWdwf = sum dd * u (shifted)
//   P   dln2 = du . Win
//   LN  dy = dz + LN2 backward; partials of dn2w, dn2b
//   P   dout = dy . Wproj
//   A   per-128-pixel partials of dattn's head blocks, sum dout^T v (C ch a pixel)
//   S   per (head, batch) block: the activation backward (softmax, or ReLU
//       under the head mask), dtemperature, and the L2-norm backward to the
//       dense (C, C) dgram (zero off the head blocks), dqn2 and dkn2
//   Q   [dq, dk, dv] = [k . dgram^T + 2 q dqn2, q . dgram + 2 k dkn2,
//       dout . attn], each column block over its heads' rows only
//   DW  (3C channels) dt, partials of dWdwq = sum [dq, dk, dv] * t (shifted)
//   P   dln1 = dt . Wqkv
//   LN  dx = dy + LN1 backward; partials of dn1w, dn1b
//   W   dWout, dWin, dWproj, dWqkv: products over the pixel axis, 64 x 64
//       output tiles x chunks of pixels, one partial per chunk.
// The TPU kernel accumulates dattn and every weight gradient across its
// sequential grid; on the card blocks run in no order, so every sum over
// pixels is written as partials and added by colsum<7> in a fixed order (no
// atomics): the result is the same bit for bit from run to run.  Only dattn's
// head blocks are formed: both activations give ds = 0 off them.
//
// What bounds it on this card: 2 (6FC + 8C^2 + 4C ch) + 36 (3C + 2F) flops
// a pixel, about 32 C^2 at F = 2.66 C, on the SIMT fp32 pipes from shared
// memory (operations, at every stage of the shipped nets).  As in K6 the
// products' ceiling is shared-memory bandwidth and the intermediate maps go
// through device memory; wgmma/TMA tiles and halo fusion are the next steps.
//
// Weights come in PyTorch's layout (every 1x1 as (out, in), the depthwise 3x3
// as (D, 3, 3), temperature as (heads,)); the 1x1 gradients are written in
// that layout, the depthwise gradients as (3, 3, D), contiguous.
//
// bf16 (mixed-precision training): x, dz and the 11 parameters are read in
// bf16 through ld(); K6's maps (t, qkv, o, y, u, g) and statistics (the Gram's
// head blocks, the norms, attn) stay fp32 as K6 wrote them, the values that
// dcpt_tpu's kernel recomputes in fp32 from its bf16 x.  Every pass computes
// and sums in fp32; dx is stored in bf16 by the LN1 backward, and the 11
// parameter gradients are summed into fp32 staging in the workspace and cast
// once, in one launch, to bf16 (CastList).

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"
#include "token_bwd.cuh"

namespace {

constexpr int kChunk = 128;   // A: pixels of one dattn partial
constexpr int kTapPix = 64;   // DW: pixels of one tap partial

__device__ __forceinline__ int cols(int n) { return (n + kNB - 1) / kNB; }

// The gate backward at pixel pix (of image b), column j, given dg.
template <typename TW>
__device__ __forceinline__ void gate_bwd(float dg, const float* u, const TW* wdwf, float* dd, int b, int pix, int j,
                                         int H, int W, int F) {
  const int yy = pix / W, xx = pix % W;
  const float a = dw3x3(u, wdwf, b, yy, xx, j, H, W, 2 * F);
  const float bv = dw3x3(u, wdwf, b, yy, xx, F + j, H, W, 2 * F);
  const float cdf = 0.5f * (1.f + erff(a * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * a * a);
  float* row = dd + ((size_t)b * H * W + pix) * 2 * F;
  row[j] = dg * bv * (cdf + a * pdf);
  row[F + j] = dg * a * cdf;
}

// G: dg = dz . Wout (Wout (C, F) read transposed), then the gate backward into dd (B, HW, 2F)
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
k7_gate_kernel(const T* __restrict__ dz, const T* __restrict__ wout, const float* __restrict__ u,
               const T* __restrict__ wdwf, float* __restrict__ dd, int H, int W, int C, int F) {
  const int HW = H * W;
  GEMM_PROLOGUE
  (void)kGemmFloats;
  const T* dzb = dz + ((size_t)b * HW + p0) * C;
  gemm_masked<RM, true>(smem, wout, F, F, n0, 0, C, [&](int p, int k) {
    return p < np ? ld(dzb[(size_t)p * C + k]) : 0.f;
  }, acc);
  GEMM_EPILOGUE(F, gate_bwd(a, u, wdwf, dd, b, p0 + p, n, H, W, F);)
}

// P: out (B*HW, N) = lhs (B*HW, K) . w, w (K, N) row-major (a PyTorch (out, in) weight read transposed)
template <typename TW, int RM>
__global__ void __launch_bounds__(kThreads)
k7_prod_kernel(const float* __restrict__ lhs, const TW* __restrict__ w, float* __restrict__ out, int HW, int K,
               int N) {
  GEMM_PROLOGUE
  (void)kGemmFloats;
  const float* ab = lhs + ((size_t)b * HW + p0) * K;
  gemm_masked<RM, true>(smem, w, N, N, n0, 0, K, [&](int p, int k) {
    return p < np ? ab[(size_t)p * K + k] : 0.f;
  }, acc);
  float* ob = out + ((size_t)b * HW + p0) * N;
  GEMM_EPILOGUE(N, ob[(size_t)p * N + n] = a;)
}

// Q: the cotangent of qkv (B, HW, 3C).  grid.y = 3 segments x cols(C): q's
// [k . dgram^T + 2 q dqn2], k's [q . dgram + 2 k dkn2], v's [dout . attn];
// dgram and attn are zero off the head blocks, so a column block reads only
// its heads' rows.
template <int RM>
__global__ void __launch_bounds__(kThreads)
k7_dqkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout, const float* __restrict__ dgram,
               const float* __restrict__ attn, const float* __restrict__ dqn2, const float* __restrict__ dkn2,
               float* __restrict__ dqkv, int HW, int C, int ch) {
  constexpr int P = 16 * RM;
  extern __shared__ float smem[];
  const int seg = blockIdx.y / cols(C), n0 = (blockIdx.y % cols(C)) * kNB;
  const int b = blockIdx.z, p0 = blockIdx.x * P, np = min(P, HW - p0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kbeg = (n0 / ch) * ch, kend = min(C, ((min(n0 + kNB, C) - 1) / ch + 1) * ch);
  const float* base = qkv + ((size_t)b * HW + p0) * 3 * C;
  const float* G = dgram + (size_t)b * C * C;
  float acc[RM][4];
  if (seg == 0) {
    gemm_masked<RM, false>(smem, G, C, C, n0, kbeg, kend, [&](int p, int k) {
      return p < np ? base[(size_t)p * 3 * C + C + k] : 0.f;
    }, acc);
  } else if (seg == 1) {
    gemm_masked<RM, true>(smem, G, C, C, n0, kbeg, kend, [&](int p, int k) {
      return p < np ? base[(size_t)p * 3 * C + k] : 0.f;
    }, acc);
  } else {
    const float* db = dout + ((size_t)b * HW + p0) * C;
    gemm_masked<RM, true>(smem, attn + (size_t)b * C * C, C, C, n0, kbeg, kend, [&](int p, int k) {
      return p < np ? db[(size_t)p * C + k] : 0.f;
    }, acc);
  }
  const float* dn = seg == 0 ? dqn2 + (size_t)b * C : dkn2 + (size_t)b * C;
  float* ob = dqkv + ((size_t)b * HW + p0) * 3 * C + seg * C;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np && n < C) {
        const float own = seg < 2 ? 2.f * base[(size_t)p * 3 * C + seg * C + n] * dn[n] : 0.f;
        ob[(size_t)p * 3 * C + n] = acc[r][i] + own;
      }
    }
}

// DW: din = the transposed depthwise 3x3 of dout (zero outside the image), and
// part (B * chunks, 9, D) the chunk's sums of dout * in at each tap; one thread
// per channel over kTapPix pixels.  w (D, 3, 3).  grid (chunks, cols of kThreads, B).
template <typename TW>
__global__ void __launch_bounds__(kThreads)
k7_dw_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ in, const TW* __restrict__ w,
                 float* __restrict__ din, float* __restrict__ part, int H, int W, int D) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= D) return;
  const int b = blockIdx.z, HW = H * W, p0 = blockIdx.x * kTapPix, pend = min(HW, p0 + kTapPix);
  const float* ib = in + (size_t)b * HW * D + c;
  const float* ob = dout + (size_t)b * HW * D + c;
  float wt[9], tap[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    wt[k] = ld(w[(size_t)c * 9 + k]);
    tap[k] = 0.f;
  }
  for (int p = p0; p < pend; ++p) {
    const int yy = p / W, xx = p % W;
    const float g = ob[(size_t)p * D];
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int y1 = yy + dy - 1, x1 = xx + dx - 1;  // the input this tap read for output p
        if (y1 >= 0 && y1 < H && x1 >= 0 && x1 < W) tap[dy * 3 + dx] = fmaf(g, ib[((size_t)y1 * W + x1) * D], tap[dy * 3 + dx]);
        const int y2 = yy - dy + 1, x2 = xx - dx + 1;  // the output that read p through this tap
        if (y2 >= 0 && y2 < H && x2 >= 0 && x2 < W) s = fmaf(ob[((size_t)y2 * W + x2) * D], wt[dy * 3 + dx], s);
      }
    din[((size_t)b * HW + p) * D + c] = s;
  }
  float* pr = part + ((size_t)b * gridDim.x + blockIdx.x) * 9 * D + c;
#pragma unroll
  for (int k = 0; k < 9; ++k) pr[(size_t)k * D] = tap[k];
}

// A: per-kChunk-pixel partials of the head blocks of dattn = dout^T v.  grid
// (chunks, heads * tiles^2, B), tiles = ceil(ch / 64); thread (tx, ty) owns
// c = c0 + ty + 16 r, d = d0 + tx + 16 i.  A partial row is (C, ch), row c
// holding c's head block.
__global__ void __launch_bounds__(kThreads)
k7_dattn_kernel(const float* __restrict__ dout, const float* __restrict__ qkv, float* __restrict__ part, int HW,
                int C, int ch) {
  extern __shared__ float smem[];
  const int tiles = (ch + kNB - 1) / kNB;
  const int h = blockIdx.y / (tiles * tiles), tile = blockIdx.y % (tiles * tiles);
  const int c0 = (tile / tiles) * kNB, d0 = (tile % tiles) * kNB;
  const int b = blockIdx.z, p0 = blockIdx.x * kChunk, np = min(kChunk, HW - p0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4], unused_a, unused_b;
  head_tile_product<false>(smem, dout + ((size_t)b * HW + p0) * C + h * ch + c0, C,
                           qkv + ((size_t)b * HW + p0) * 3 * C + 2 * C + h * ch + d0, 3 * C, np, ch - c0, ch - d0, acc,
                           unused_a, unused_b);
  float* row = part + ((size_t)b * gridDim.x + blockIdx.x) * ((size_t)C * ch);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty + 16 * r, d = d0 + tx + 16 * i;
      if (c < ch && d < ch) row[(size_t)(h * ch + c) * ch + d] = acc[r][i];
    }
}

// S: the C-space step of head h, image b.  Given dattn's and the raw Gram's
// head blocks (B, C, ch), attn (B, C, C) and the squared norms (B, C):
//   iq = rsqrt(max(|q|^2, 1e-24)), ik likewise, n = G iq ik, s = n T;
//   ds = attn (dattn - rowsum(dattn attn))  (softmax) or dattn [s > 0]  (ReLU);
//   dgram = ds T iq ik (dense (B, C, C), zero off the head blocks);
//   dqn2 = -1/2 iq^3 rowsum(ds T G ik), dkn2 = -1/2 ik^3 colsum(ds T G iq)
//   (zero where the clamp is active); pdtemp[b][h] = sum of ds n.
// Rows one warp each, then columns one thread each, both in a fixed order.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
k7_cspace_kernel(const float* __restrict__ dattn, const float* __restrict__ attn, const float* __restrict__ gram,
                 const float* __restrict__ qn2, const float* __restrict__ kn2, const TW* __restrict__ temperature,
                 float* __restrict__ dgram, float* __restrict__ dqn2, float* __restrict__ dkn2,
                 float* __restrict__ pdtemp, int C, int ch, int use_softmax) {
  extern __shared__ float smem[];  // 3 x ch: each row's sum(dattn attn), its iq, its share of dtemp
  float *sDot = smem, *sIq = smem + ch, *sT = smem + 2 * ch;
  const int h = blockIdx.x, b = blockIdx.y, c0 = h * ch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float temp = ld(temperature[h]);
  const float* da = dattn + (size_t)b * C * ch;
  const float* gr = gram + (size_t)b * C * ch;
  const float* at = attn + (size_t)b * C * C;
  const float* qn = qn2 + (size_t)b * C;
  const float* kn = kn2 + (size_t)b * C;
  auto ds_of = [&](int c, int d, float dot, float iq, float ik) {  // c, d global; d in c's head
    const float g = da[(size_t)c * ch + d - c0];
    if (use_softmax) return at[(size_t)c * C + d] * (g - dot);
    return gr[(size_t)c * ch + d - c0] * iq * ik * temp > 0.f ? g : 0.f;
  };
  for (int i = warp; i < ch; i += kThreads / 32) {
    const int c = c0 + i;
    const float iq = 1.f / sqrtf(fmaxf(qn[c], 1e-24f));
    float dot = 0.f;
    if (use_softmax) {
      for (int j = lane; j < ch; j += 32) dot = fmaf(da[(size_t)c * ch + j], at[(size_t)c * C + c0 + j], dot);
      dot = warp_sum(dot);
    }
    float sq = 0.f, st = 0.f;
    float* out = dgram + ((size_t)b * C + c) * C;
    for (int k = lane; k < C; k += 32) {
      float v = 0.f;
      if (k >= c0 && k < c0 + ch) {
        const float ik = 1.f / sqrtf(fmaxf(kn[k], 1e-24f));
        const float g = gr[(size_t)c * ch + k - c0];
        const float ds = ds_of(c, k, dot, iq, ik);
        st = fmaf(ds, g * iq * ik, st);
        sq = fmaf(ds * temp * g, ik, sq);
        v = ds * temp * iq * ik;
      }
      out[k] = v;
    }
    sq = warp_sum(sq);
    st = warp_sum(st);
    if (lane == 0) {
      sDot[i] = dot;
      sIq[i] = iq;
      sT[i] = st;
      dqn2[(size_t)b * C + c] = qn[c] > 1e-24f ? -0.5f * iq * iq * iq * sq : 0.f;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ch; j += kThreads) {
    const int d = c0 + j;
    const float ik = 1.f / sqrtf(fmaxf(kn[d], 1e-24f));
    float sk = 0.f;
    for (int i = 0; i < ch; ++i) {
      const int c = c0 + i;
      const float ds = ds_of(c, d, sDot[i], sIq[i], ik);
      sk = fmaf(ds * temp * gr[(size_t)c * ch + j], sIq[i], sk);
    }
    dkn2[(size_t)b * C + d] = kn[d] > 1e-24f ? -0.5f * ik * ik * ik * sk : 0.f;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < ch; ++i) s += sT[i];
    pdtemp[(size_t)b * gridDim.x + h] = s;
  }
}

// The 11 parameter gradients' lengths in floats, in the entry's order (dn1w,
// dn1b, dWqkv, dWdwq, dtemperature, dWproj, dn2w, dn2b, dWin, dWdwf, dWout).
constexpr int kParams = 11;

void param_lengths(int C, int F, int heads, long long* len) {
  const long long c = C, f = F;
  const long long l[kParams] = {c, c, 3 * c * c, 27 * c, heads, c * c, c, c, 2 * f * c, 18 * f, c * f};
  for (int k = 0; k < kParams; ++k) len[k] = l[k];
}

// The workspace: the cotangent maps, the LN statistics, every partial sum,
// colsum's scratch, and in a bf16 call the fp32 staging of the parameter gradients.
struct Plan {
  int B, H, W, C, F, heads, ch, HW, npix, rm, nchunk, ntap, nrb;
  size_t mx, my, dln, dy, dout, st2, st1, pdattn, dattn, dgram, dqn2, dkn2, pdtemp, prow, ptap, pw, sum, stage, total;
};

Plan make_plan(int B, int H, int W, int C, int F, int heads, bool bf16) {
  Plan pl;
  pl.B = B; pl.H = H; pl.W = W; pl.C = C; pl.F = F; pl.heads = heads;
  pl.ch = C / heads;
  pl.HW = H * W;
  pl.npix = B * H * W;
  pl.rm = pl.npix >= 8192 ? 4 : (pl.npix >= 2048 ? 2 : 1);  // as K6: pixel tiles that fill the card
  pl.nchunk = (pl.HW + kChunk - 1) / kChunk;
  pl.ntap = (pl.HW + kTapPix - 1) / kTapPix;
  pl.nrb = (pl.npix + kRP - 1) / kRP;
  const size_t n = pl.npix;
  const size_t wide = std::max(2 * (size_t)F, 3 * (size_t)C);
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += (floats + 63) / 64 * 64;  // 256-byte aligned
    return at;
  };
  pl.mx = take(n * wide);  // dd (2F), then the cotangent of qkv (3C)
  pl.my = take(n * wide);  // du (2F), then dt (3C)
  pl.dln = take(n * C);
  pl.dy = take(n * C);
  pl.dout = take(n * C);
  pl.st2 = take(2 * n);
  pl.st1 = take(2 * n);
  const size_t cch = (size_t)C * pl.ch;
  pl.pdattn = take((size_t)B * pl.nchunk * cch);
  pl.dattn = take((size_t)B * cch);
  pl.dgram = take((size_t)B * C * C);
  pl.dqn2 = take((size_t)B * C);
  pl.dkn2 = take((size_t)B * C);
  pl.pdtemp = take((size_t)B * heads);
  pl.prow = take((size_t)pl.nrb * 2 * C);
  pl.ptap = take((size_t)B * pl.ntap * 9 * wide);
  size_t pw = 0, sum = 0;
  const int shapes[4][2] = {{C, F}, {2 * F, C}, {C, C}, {3 * C, C}};
  for (const auto& s : shapes) {
    int len;
    const int nch = w_chunks(s[0], s[1], pl.npix, &len);
    pw = std::max(pw, (size_t)nch * s[0] * s[1]);
    sum = std::max(sum, colsum_scratch(1, nch, s[0] * s[1]));
  }
  pl.pw = take(pw);
  sum = std::max(sum, colsum_scratch(B, pl.nchunk, (int)cch));
  sum = std::max(sum, colsum_scratch(1, B, heads));
  sum = std::max(sum, colsum_scratch(1, pl.nrb, C));
  sum = std::max(sum, colsum_scratch(1, B * pl.ntap, 9 * (int)wide));
  pl.sum = take(sum);
  long long len[kParams], staged = 0;
  param_lengths(C, F, heads, len);
  for (long long l : len) staged += l;
  pl.stage = take(bf16 ? (size_t)staged : 0);
  pl.total = off;
  return pl;
}

// dx in the I/O type, the parameter gradients in fp32 (the caller's, or the staging of a bf16 call)
template <typename T>
struct Grads {
  T* dx;
  float *dn1w, *dn1b, *dwqkv, *dwdwq, *dtemp, *dwproj, *dn2w, *dn2b, *dwin, *dwdwf, *dwout;
};

template <typename T>
struct Inputs {
  const T *x, *dz, *n1w, *n1b, *wqkv, *wdwq, *temp, *wproj, *n2w, *n2b, *win, *wdwf, *wout;
  const float *t, *qkv, *o, *y, *u, *g, *gram, *qn2, *kn2, *attn;
};

#define CHECK(call) \
  if ((err = (call)) != cudaSuccess) return err;
#define CHECK_LAUNCH() \
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

// The pixel-space products at RM.
template <typename T, int RM>
cudaError_t launch_gate(const Plan& pl, float* ws, const Inputs<T>& in, cudaStream_t stream) {
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  k7_gate_kernel<T, RM><<<dim3((pl.HW + 16 * RM - 1) / (16 * RM), (pl.F + kNB - 1) / kNB, pl.B), kThreads, smem,
                          stream>>>(in.dz, in.wout, in.u, in.wdwf, ws + pl.mx, pl.H, pl.W, pl.C, pl.F);
  return cudaGetLastError();
}

template <typename TW, int RM>
cudaError_t launch_prod(const Plan& pl, const float* a, const TW* w, float* out, int K, int N, cudaStream_t stream) {
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  k7_prod_kernel<TW, RM><<<dim3((pl.HW + 16 * RM - 1) / (16 * RM), (N + kNB - 1) / kNB, pl.B), kThreads, smem,
                           stream>>>(a, w, out, pl.HW, K, N);
  return cudaGetLastError();
}

template <typename T, int RM>
cudaError_t launch_dqkv(const Plan& pl, float* ws, const Inputs<T>& in, cudaStream_t stream) {
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  k7_dqkv_kernel<RM><<<dim3((pl.HW + 16 * RM - 1) / (16 * RM), 3 * ((pl.C + kNB - 1) / kNB), pl.B), kThreads, smem,
                       stream>>>(in.qkv, ws + pl.dout, ws + pl.dgram, in.attn, ws + pl.dqn2, ws + pl.dkn2,
                                 ws + pl.mx, pl.HW, pl.C, pl.ch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gate(const Plan& pl, float* ws, const Inputs<T>& in, cudaStream_t s) {
  return pl.rm == 4 ? launch_gate<T, 4>(pl, ws, in, s) : pl.rm == 2 ? launch_gate<T, 2>(pl, ws, in, s)
                                                                    : launch_gate<T, 1>(pl, ws, in, s);
}

template <typename TW>
cudaError_t prod(const Plan& pl, const float* a, const TW* w, float* out, int K, int N, cudaStream_t s) {
  return pl.rm == 4 ? launch_prod<TW, 4>(pl, a, w, out, K, N, s)
                    : pl.rm == 2 ? launch_prod<TW, 2>(pl, a, w, out, K, N, s) : launch_prod<TW, 1>(pl, a, w, out, K, N, s);
}

template <typename T>
cudaError_t dqkv(const Plan& pl, float* ws, const Inputs<T>& in, cudaStream_t s) {
  return pl.rm == 4 ? launch_dqkv<T, 4>(pl, ws, in, s) : pl.rm == 2 ? launch_dqkv<T, 2>(pl, ws, in, s)
                                                                    : launch_dqkv<T, 1>(pl, ws, in, s);
}

// DW over D channels: din and the tap gradient (3, 3, D).
template <typename TW>
cudaError_t dw_bwd(const Plan& pl, float* ws, const float* dout, const float* inp, const TW* w, float* din,
                   float* dw, int D, cudaStream_t stream) {
  k7_dw_bwd_kernel<TW><<<dim3(pl.ntap, (D + kThreads - 1) / kThreads, pl.B), kThreads, 0, stream>>>(
      dout, inp, w, din, ws + pl.ptap, pl.H, pl.W, D);
  cudaError_t err;
  CHECK_LAUNCH();
  return colsum<7>(ws + pl.ptap, 1, pl.B * pl.ntap, 9 * D, 9 * D, dw, ws + pl.sum, stream);
}

// LN backward: out = res + the backward through LN(v), stats, and the weight and bias gradients
template <typename TV, typename TR, typename TW, typename TO>
cudaError_t ln_bwd(const Plan& pl, float* ws, const TV* v, const TR* res, const TW* w, TO* out, float* stats,
                   float* dw, float* db, float eps, int ln_bias, cudaStream_t stream) {
  const int C = pl.C;
  ln_bwd_kernel<7, TV, TR, TW, TO><<<pl.nrb, kThreads, 4 * kRP * sizeof(float), stream>>>(
      v, ws + pl.dln, res, w, out, stats, ws + pl.prow, pl.npix, C, eps, ln_bias);
  cudaError_t err;
  CHECK_LAUNCH();
  CHECK(colsum<7>(ws + pl.prow, 1, pl.nrb, C, 2 * C, dw, ws + pl.sum, stream));
  return colsum<7>(ws + pl.prow + C, 1, pl.nrb, C, 2 * C, db, ws + pl.sum, stream);
}

// W: out (M, N) = sum over pixels of a (npix, M) x B (npix, N)
template <bool LN, typename TA, typename TB, typename TL>
cudaError_t wgrad(const Plan& pl, float* ws, const TA* a, int M, const TB* bm, int N, const float* stats,
                  const TL* lw, const TL* lb, int ln_bias, float* out, cudaStream_t stream) {
  int len;
  const int nch = w_chunks(M, N, pl.npix, &len);
  wgrad_kernel<7, LN, TA, TB, TL><<<dim3((N + kNB - 1) / kNB, (M + kNB - 1) / kNB, nch), kThreads,
                                    2 * kKC * kWS * sizeof(float), stream>>>(a, M, bm, N, stats, lw, lb, ln_bias,
                                                                             ws + pl.pw, pl.npix, M, N, len);
  cudaError_t err;
  CHECK_LAUNCH();
  return colsum<7>(ws + pl.pw, 1, nch, M * N, M * N, out, ws + pl.sum, stream);
}

template <typename T>
int mdta_block_bwd(const Inputs<T>& in, const Grads<T>& gr, float* ws, const Plan& pl, int use_softmax, int ln_bias,
                   float eps, cudaStream_t stream) {
  const int B = pl.B, C = pl.C, F = pl.F, heads = pl.heads, ch = pl.ch;
  const T* none = nullptr;
  cudaError_t err;
  // B1: the GDFN backward
  CHECK(gate(pl, ws, in, stream));
  CHECK(wgrad<false>(pl, ws, in.dz, C, in.g, F, nullptr, none, none, 0, gr.dwout, stream));
  CHECK(dw_bwd(pl, ws, ws + pl.mx, in.u, in.wdwf, ws + pl.my, gr.dwdwf, 2 * F, stream));
  CHECK(prod(pl, ws + pl.my, in.win, ws + pl.dln, 2 * F, C, stream));
  CHECK(ln_bwd(pl, ws, in.y, in.dz, in.n2w, ws + pl.dy, ws + pl.st2, gr.dn2w, gr.dn2b, eps, ln_bias, stream));
  CHECK(wgrad<true>(pl, ws, ws + pl.my, 2 * F, in.y, C, ws + pl.st2, in.n2w, in.n2b, ln_bias, gr.dwin, stream));
  // B1: the attention application's backward
  CHECK(prod(pl, ws + pl.dy, in.wproj, ws + pl.dout, C, C, stream));
  CHECK(wgrad<false>(pl, ws, ws + pl.dy, C, in.o, C, nullptr, none, none, 0, gr.dwproj, stream));
  const int tiles = (ch + kNB - 1) / kNB;
  k7_dattn_kernel<<<dim3(pl.nchunk, heads * tiles * tiles, B), kThreads, 2 * kKC * kWS * sizeof(float), stream>>>(
      ws + pl.dout, in.qkv, ws + pl.pdattn, pl.HW, C, ch);
  CHECK_LAUNCH();
  CHECK(colsum<7>(ws + pl.pdattn, B, pl.nchunk, C * ch, C * ch, ws + pl.dattn, ws + pl.sum, stream));
  // the C-space step
  k7_cspace_kernel<T><<<dim3(heads, B), kThreads, 3 * ch * sizeof(float), stream>>>(
      ws + pl.dattn, in.attn, in.gram, in.qn2, in.kn2, in.temp, ws + pl.dgram, ws + pl.dqn2, ws + pl.dkn2,
      ws + pl.pdtemp, C, ch, use_softmax);
  CHECK_LAUNCH();
  CHECK(colsum<7>(ws + pl.pdtemp, 1, B, heads, heads, gr.dtemp, ws + pl.sum, stream));
  // B2: the qkv prefix's backward
  CHECK(dqkv(pl, ws, in, stream));
  CHECK(dw_bwd(pl, ws, ws + pl.mx, in.t, in.wdwq, ws + pl.my, gr.dwdwq, 3 * C, stream));
  CHECK(prod(pl, ws + pl.my, in.wqkv, ws + pl.dln, 3 * C, C, stream));
  CHECK(ln_bwd(pl, ws, in.x, static_cast<const float*>(ws + pl.dy), in.n1w, gr.dx, ws + pl.st1, gr.dn1w, gr.dn1b,
               eps, ln_bias, stream));
  CHECK(wgrad<true>(pl, ws, ws + pl.my, 3 * C, in.x, C, ws + pl.st1, in.n1w, in.n1b, ln_bias, gr.dwqkv, stream));
  return cudaSuccess;
}

#undef CHECK
#undef CHECK_LAUNCH

#define MDTA_BWD_ARGS                                                                                               \
  const void *x, const void *dz, const void *n1w, const void *n1b, const void *wqkv, const void *wdwq,             \
      const void *temp, const void *wproj, const void *n2w, const void *n2b, const void *win, const void *wdwf,    \
      const void *wout, const void *gram, const void *qn2, const void *kn2, const void *attn, const void *t,       \
      const void *qkv, const void *o, const void *y, const void *u, const void *g, void *dx, void *dn1w,           \
      void *dn1b, void *dwqkv, void *dwdwq, void *dtemp, void *dwproj, void *dn2w, void *dn2b, void *dwin,         \
      void *dwdwf, void *dwout, void *ws, int B, int H, int W, int C, int F, int heads, int use_softmax,           \
      int ln_bias, float eps, void *stream
#define MDTA_BWD_PASS                                                                                               \
  x, dz, n1w, n1b, wqkv, wdwq, temp, wproj, n2w, n2b, win, wdwf, wout, gram, qn2, kn2, attn, t, qkv, o, y, u, g,  \
      dx, dn1w, dn1b, dwqkv, dwdwq, dtemp, dwproj, dn2w, dn2b, dwin, dwdwf, dwout, ws, B, H, W, C, F, heads,       \
      use_softmax, ln_bias, eps, stream

template <typename T>
int mdta_block_bwd_entry(MDTA_BWD_ARGS) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  constexpr bool f32 = sizeof(T) == sizeof(float);
  const Plan pl = make_plan(B, H, W, C, F, heads, !f32);
  float* wsf = static_cast<float*>(ws);
  void* outs[kParams] = {dn1w, dn1b, dwqkv, dwdwq, dtemp, dwproj, dn2w, dn2b, dwin, dwdwf, dwout};
  long long len[kParams];
  param_lengths(C, F, heads, len);
  const StagedGrads<T, kParams> sg(outs, len, wsf + pl.stage);
  float* const* gs = sg.g32;
  const Inputs<T> in{p(x), p(dz), p(n1w), p(n1b), p(wqkv), p(wdwq), p(temp), p(wproj), p(n2w), p(n2b), p(win),
                     p(wdwf), p(wout), f(t), f(qkv), f(o), f(y), f(u), f(g), f(gram), f(qn2), f(kn2), f(attn)};
  const Grads<T> gr{static_cast<T*>(dx), gs[0], gs[1], gs[2], gs[3], gs[4], gs[5], gs[6], gs[7], gs[8], gs[9], gs[10]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = mdta_block_bwd<T>(in, gr, wsf, pl, use_softmax, ln_bias, eps, s);
  if (err != cudaSuccess) return err;
  return sg.cast(s);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device pointer.
// Inputs: x and dz (B, H, W, C) and the 11 parameters in PyTorch's layout (see
// mdta_block.cu), in the I/O type (f32: float, bf16: bfloat16); K6's fp32
// residuals: the head blocks of the raw Gram (B, C, ch), |q|^2 and |k|^2 (B, C),
// attn (B, C, C), and the maps t, qkv (B, H, W, 3C), o, y (B, H, W, C), u
// (B, H, W, 2F), g (B, H, W, F).  Outputs in the I/O type: dx (B, H, W, C) and
// the 11 parameter gradients (1x1s in PyTorch's layout, depthwise as (3, 3, D),
// dtemperature (heads,)).  ws holds mdta_block_bwd_workspace_floats(..., bf16)
// floats.  ln_bias 0 = BiasFree (n1b and n2b are not read).  Returns the first
// CUDA error, or 0.
extern "C" int mdta_block_bwd_f32(MDTA_BWD_ARGS) { return mdta_block_bwd_entry<float>(MDTA_BWD_PASS); }
extern "C" int mdta_block_bwd_bf16(MDTA_BWD_ARGS) { return mdta_block_bwd_entry<__nv_bfloat16>(MDTA_BWD_PASS); }

extern "C" long long mdta_block_bwd_workspace_floats(int B, int H, int W, int C, int F, int heads, int bf16) {
  return (long long)make_plan(B, H, W, C, F, heads, bf16 != 0).total;
}
