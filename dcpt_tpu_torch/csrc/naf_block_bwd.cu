// Whole-NAFBlock backward on Hopper (sm_90a): fp32 I/O, fp32 math.
//
// Replaces the TPU kernel dcpt_tpu/ops/naf_block_bwd.py::naf_block_bwd
// (_b1_kernel + host SCA step + _b2_kernel).  Given the upstream cotangent dz
// of z = naf_block_ref(x, ...) it computes all 19 cotangents: dx and the 18
// parameter gradients, dw = ffn = 2C, C in 64..8192 in steps of 64, any H x W.
//
// Residuals.  The TPU kernel recomputes the forward inside its backward (a
// 16 GB chip).  Here the forward kernel (naf_block.cu) writes, when a gradient
// is needed, the maps its passes compute anyway: g, the expanded map t (2C),
// u = (g*att) . W3^T + b3, y, h = LN2(y) . W4^T + b4 (2C) and
// o = gate(h) . W5^T + b5: 8C floats per pixel, about 3.6 GB for both passes
// of a batch-8 NAFNet-w64 DCPT step at 128 x 128 on an 80 GB card.  Reading
// them back costs 32C bytes per pixel; recomputing them would repeat the
// forward's 6 C^2 multiply-adds per pixel on the SIMT pipes.  So nothing of the
// forward is recomputed except the per-pixel LayerNorm statistics.
//
// Passes, on PyTorch's current stream (each a grid of pixel tiles x 64 output
// columns x batch, unless it says otherwise):
//   F1  dh = [dhg * h2, dhg * h1], dhg = (dz * gamma) . W5          (K = C)
//   F2  dln2 = dh . W4                                               (K = 2C)
//   R2  per pixel: the LN2 backward -> dy, du = dy * beta; per-block partial
//       column sums of dn2w, dn2b, dgamma (dz * o) and dbeta (dy * u)
//   A   da = du . W3; dg = da * att; per-tile partials of datt = sum da * g
//   S   datt (partials summed in tile order) -> dgk = datt . Wsca / (H W),
//       dWsca, dbsca: the SCA's global coupling, a (B, C) x (C, C) product
//   D   per 8 x 8 pixel tile x 64 gate pairs: t on the halo-2 window,
//       the depthwise output on halo 1 and ddw = [dg * dwm2, dg * dwm1]
//       (dg = local + dgk), then on the tile dt (the transposed stencil) and
//       partials of dWdw and dbdw.  Halo pixels outside the image hold t = 0
//       and ddw = 0, as the forward's zero padding of t implies; ragged tiles
//       are masked, so 1 x 1 maps work.
//   L1  dln1 = dt . W1                                               (K = 2C)
//   R1  per pixel: the LN1 backward -> dx = dy + ...; partials of dn1w, dn1b
//   W   dW5, dW4, dW3, dW1 and their biases, products over the pixel axis:
//       64 x 64 output tiles x chunks of pixels, one partial per chunk.
// The TPU kernel accumulates every weight gradient in VMEM across its
// sequential grid; on the card blocks run in no order, so every sum over
// pixels is written as partials and added by colsum in a fixed order (no
// atomics): the result is the same bit for bit from run to run.
//
// What bounds it on this card: 12 C^2 multiply-adds per pixel (6 C^2 into
// pixel space, 6 C^2 of weight gradients), i.e. arithmetic from C = 64 up, run
// on the SIMT fp32 pipes from shared memory with gemm.cuh's product, whose
// ceiling is shared-memory bandwidth.  The weight-gradient products split the
// pixel axis into chunks so that deep stages (few pixels, large C x 2C
// outputs) and shallow ones (many pixels, small outputs) both fill the card.
// wgmma/TMA tiles are the next step.
//
// Weights come in PyTorch's layout (every 1x1 as (out, in), the depthwise 3x3 as
// (2C, 3, 3)); the gradients of the 1x1 weights are written in that layout, the
// depthwise gradient as (3, 3, 2C) and its bias as (2C,), contiguous.

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kCC = 64;                  // D: gate channels per block (paired with C + j)
constexpr int kDT = 8;                   // D: output tile side
constexpr int kDH1 = kDT + 2;            // D: halo-1 window side (ddw)
constexpr int kDH2 = kDT + 4;            // D: halo-2 window side (t)
constexpr int kDP1 = kDH1 * kDH1;
constexpr int kDP2 = kDH2 * kDH2;
constexpr int kRP = 32;                  // R1 / R2: pixels of a block
constexpr int kWBlocks = 2 * 132;        // W: blocks to aim for (two per SM)

// The pixel-space products share one grid: (pixel tiles of 16 * RM, N / kNB column blocks, B).
#define PIX_PROLOGUE                                                \
  constexpr int P = 16 * RM;                                        \
  extern __shared__ float smem[];                                   \
  const int b = blockIdx.z, p0 = blockIdx.x * P, n0 = blockIdx.y * kNB; \
  const int np = min(P, HW - p0);                                   \
  const size_t pix0 = (size_t)b * HW + p0;                          \
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;           \
  float acc[RM][4], acc2[RM][4];

// F1: dhg = (dz * gamma) . w5 (w5 (C, C) read transposed), dh = [dhg * h2, dhg * h1]
template <int RM>
__global__ void __launch_bounds__(kThreads)
bwd_f1_kernel(const float* __restrict__ dz, const float* __restrict__ gamma, const float* __restrict__ w5,
              const float* __restrict__ h, float* __restrict__ dh, int HW, int C) {
  PIX_PROLOGUE
  gemm_block<RM, false, true>(smem, w5, C, C, n0, 0, [&](int p, int k) {
    return p < np ? dz[(pix0 + p) * C + k] * gamma[k] : 0.f;
  }, acc, acc2);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np) {
        const size_t q = (pix0 + p) * 2 * C;
        dh[q + n] = acc[r][i] * h[q + C + n];
        dh[q + C + n] = acc[r][i] * h[q + n];
      }
    }
}

// F2 and L1: out (B*HW, N) = a (B*HW, K) . w, w (K, N) read transposed
template <int RM>
__global__ void __launch_bounds__(kThreads)
bwd_prod_kernel(const float* __restrict__ a, const float* __restrict__ w, float* __restrict__ out, int HW, int K,
                int N) {
  PIX_PROLOGUE
  gemm_block<RM, false, true>(smem, w, K, N, n0, 0, [&](int p, int k) {
    return p < np ? a[(pix0 + p) * K + k] : 0.f;
  }, acc, acc2);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np) out[(pix0 + p) * N + n] = acc[r][i];
    }
}

// A: da = du . w3 (w3 (C, C) read transposed); dg = da * att; part (B, tiles, C)
// gets the tile's sum of da * g for datt.
template <int RM>
__global__ void __launch_bounds__(kThreads)
bwd_a_kernel(const float* __restrict__ du, const float* __restrict__ w3, const float* __restrict__ att,
             const float* __restrict__ g, float* __restrict__ dg, float* __restrict__ part, int HW, int C) {
  PIX_PROLOGUE
  gemm_block<RM, false, true>(smem, w3, C, C, n0, 0, [&](int p, int k) {
    return p < np ? du[(pix0 + p) * C + k] : 0.f;
  }, acc, acc2);
  const float* ab = att + (size_t)b * C;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np) {
        const size_t q = (pix0 + p) * C + n;
        dg[q] = acc[r][i] * ab[n];
        s[i] = fmaf(acc[r][i], g[q], s[i]);
      }
    }
  __syncthreads();  // the product is done with its buffers
#pragma unroll
  for (int i = 0; i < 4; ++i) smem[ty * kNB + tx + 16 * i] = s[i];
  __syncthreads();
  if (threadIdx.x < kNB) {
    float t = 0.f;
    for (int k = 0; k < kThreads / 16; ++k) t += smem[k * kNB + threadIdx.x];
    part[((size_t)b * gridDim.x + blockIdx.x) * C + n0 + threadIdx.x] = t;
  }
}

// R2 (SECOND) and R1: the LayerNorm backward of one pixel per warp, then per column.
//   v: the normalised map's input (y for R2, x for R1); dln: cotangent of the
//   affine output; res: the residual cotangent (dz for R2, dy for R1).
//   out = res + rs * (dln*w - mean(dln*w) - vh * mean(dln*w*vh)), vh = (v - mu) * rs.
//   R2 also writes du = out * beta.  stats (pixels, 2) gets mu and rs for the
//   weight-gradient pass.  part (blocks, 2C or 4C): column sums over the block's
//   pixels of dln * vh, dln (and for R2, dz * o and out * u).
template <bool SECOND>
__global__ void __launch_bounds__(kThreads)
bwd_ln_kernel(const float* __restrict__ v, const float* __restrict__ dln, const float* __restrict__ res,
              const float* __restrict__ w, const float* __restrict__ beta, const float* __restrict__ o,
              const float* __restrict__ u, float* __restrict__ out, float* __restrict__ du,
              float* __restrict__ stats, float* __restrict__ part, int npix, int C, float eps) {
  extern __shared__ float smem[];  // 4 x kRP: mean, 1/sigma and the two means of the backward
  float *sMu = smem, *sRs = smem + kRP, *sM1 = smem + 2 * kRP, *sM2 = smem + 3 * kRP;
  const int p0 = blockIdx.x * kRP, np = min(kRP, npix - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < np; p += kThreads / 32) {
    const float* vr = v + (size_t)(p0 + p) * C;
    const float* dr = dln + (size_t)(p0 + p) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += vr[c];
    const float mu = warp_sum(s) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = vr[c] - mu;
      var += d * d;
    }
    const float rs = 1.f / sqrtf(warp_sum(var) / C + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dw = dr[c] * w[c];
      m1 += dw;
      m2 += dw * (vr[c] - mu) * rs;
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
  constexpr int kParts = SECOND ? 4 : 2;
  float* pr = part + (size_t)blockIdx.x * kParts * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float wc = w[c], bc = SECOND ? beta[c] : 0.f;
    float sw = 0.f, sb = 0.f, sg = 0.f, sbeta = 0.f;
    for (int p = 0; p < np; ++p) {
      const size_t q = (size_t)(p0 + p) * C + c;
      const float vh = (v[q] - sMu[p]) * sRs[p];
      const float d = dln[q];
      const float ov = res[q] + sRs[p] * (d * wc - sM1[p] - vh * sM2[p]);
      out[q] = ov;
      sw = fmaf(d, vh, sw);
      sb += d;
      if (SECOND) {
        du[q] = ov * bc;
        sg = fmaf(res[q], o[q], sg);
        sbeta = fmaf(ov, u[q], sbeta);
      }
    }
    pr[c] = sw;
    pr[C + c] = sb;
    if (SECOND) {
      pr[2 * C + c] = sg;
      pr[3 * C + c] = sbeta;
    }
  }
}

// S: dgk[b][i] = sum_o datt[b][o] * wsca[o][i] / (H W); grid (C / kNB, B)
__global__ void __launch_bounds__(kThreads)
bwd_sca_kernel(const float* __restrict__ datt, const float* __restrict__ wsca, float* __restrict__ dgk, int C,
               float hw) {
  extern __shared__ float sP[];  // kThreads partial sums
  const int b = blockIdx.y, i = blockIdx.x * kNB + (threadIdx.x & (kNB - 1)), grp = threadIdx.x / kNB;
  float s = 0.f;
  for (int o = grp; o < C; o += kThreads / kNB) s = fmaf(datt[(size_t)b * C + o], wsca[(size_t)o * C + i], s);
  sP[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < kNB) {
    float t = 0.f;
    for (int k = 0; k < kThreads / kNB; ++k) t += sP[k * kNB + threadIdx.x];
    dgk[(size_t)b * C + i] = t / hw;
  }
}

// S: dwsca[o][i] = sum_b datt[b][o] * pooled[b][i], dbsca[o] = sum_b datt[b][o]
__global__ void __launch_bounds__(kThreads)
bwd_sca_w_kernel(const float* __restrict__ datt, const float* __restrict__ pooled, float* __restrict__ dwsca,
                 float* __restrict__ dbsca, int B, int C) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)C * C) return;
  const int o = (int)(idx / C), i = (int)(idx % C);
  float s = 0.f, sb = 0.f;
  for (int b = 0; b < B; ++b) {
    const float d = datt[(size_t)b * C + o];
    s = fmaf(d, pooled[(size_t)b * C + i], s);
    sb += d;
  }
  dwsca[idx] = s;
  if (i == 0) dbsca[o] = sb;
}

// D: depthwise backward.  grid (tiles of kDT x kDT, C / kCC, B); part
// (B * tiles, 10, 2C) gets the tile's dWdw (9 taps) and dbdw sums.
__global__ void __launch_bounds__(kThreads)
bwd_d_kernel(const float* __restrict__ t, const float* __restrict__ dg, const float* __restrict__ dgk,
             const float* __restrict__ wdw, const float* __restrict__ bdw, float* __restrict__ dt,
             float* __restrict__ part, int H, int W, int C, int ntx) {
  extern __shared__ float smem[];
  constexpr int ldt = kDP2 + 1, ldd = kDP1 + 1;
  float* sT = smem;                   // 2*kCC x ldt: t on the halo-2 window, channel-major
  float* sD = sT + 2 * kCC * ldt;     // 2*kCC x ldd: ddw on the halo-1 window
  const int tile = blockIdx.x, c0 = blockIdx.y * kCC, b = blockIdx.z;
  const int y0 = (tile / ntx) * kDT, x0 = (tile % ntx) * kDT;  // the tile's first output pixel
  const size_t hw = (size_t)H * W;
  const int C2 = 2 * C;

  // t on the halo-2 window, zero outside the image; lanes run along channels
  for (int idx = threadIdx.x; idx < kDP2 * 2 * kCC; idx += kThreads) {
    const int q = idx / (2 * kCC), ch = idx % (2 * kCC);
    const int yy = y0 - 2 + q / kDH2, xx = x0 - 2 + q % kDH2;
    const int chan = ch < kCC ? c0 + ch : C + c0 + ch - kCC;
    sT[ch * ldt + q] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                           ? t[((size_t)b * hw + (size_t)yy * W + xx) * C2 + chan] : 0.f;
  }
  __syncthreads();

  const int j = threadIdx.x & (kCC - 1), grp = threadIdx.x / kCC;
  float wa[9], wb[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    wa[k] = wdw[(size_t)(c0 + j) * 9 + k];
    wb[k] = wdw[(size_t)(C + c0 + j) * 9 + k];
  }
  const float ba = bdw[c0 + j], bb = bdw[C + c0 + j];
  const float gk = dgk[(size_t)b * C + c0 + j];
  const float* ta = sT + j * ldt;
  const float* tb = sT + (kCC + j) * ldt;
  float* da = sD + j * ldd;
  float* db = sD + (kCC + j) * ldd;

  // ddw = [dg * dwm2, dg * dwm1] on the halo-1 window; zero outside the image
  for (int q = grp; q < kDP1; q += kThreads / kCC) {
    const int ry = q / kDH1, rx = q % kDH1;
    const int yy = y0 - 1 + ry, xx = x0 - 1 + rx;
    float va = 0.f, vb = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      float ma = ba, mb = bb;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int s = (ry + dy) * kDH2 + rx + dx;
          ma = fmaf(ta[s], wa[dy * 3 + dx], ma);
          mb = fmaf(tb[s], wb[dy * 3 + dx], mb);
        }
      const float gv = dg[((size_t)b * hw + (size_t)yy * W + xx) * C + c0 + j] + gk;
      va = gv * mb;
      vb = gv * ma;
    }
    da[q] = va;
    db[q] = vb;
  }
  __syncthreads();

  // on the tile: dt[r][s] = sum_{dy,dx} ddw[r + 1 - dy][s + 1 - dx] * w[dy][dx];
  // dWdw[dy][dx] += ddw[r][s] * t[r + dy - 1][s + dx - 1]; dbdw += ddw[r][s]
  float pa[10], pb[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) pa[k] = pb[k] = 0.f;
  for (int o = grp; o < kDT * kDT; o += kThreads / kCC) {
    const int oy = o / kDT, ox = o % kDT;
    const int yy = y0 + oy, xx = x0 + ox;
    if (yy >= H || xx >= W) continue;
    const float ca = da[(oy + 1) * kDH1 + ox + 1], cb = db[(oy + 1) * kDH1 + ox + 1];
    float ga = 0.f, gb = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int s = (oy + 2 - dy) * kDH1 + ox + 2 - dx;
        ga = fmaf(da[s], wa[dy * 3 + dx], ga);
        gb = fmaf(db[s], wb[dy * 3 + dx], gb);
        const int s2 = (oy + 1 + dy) * kDH2 + ox + 1 + dx;
        pa[dy * 3 + dx] = fmaf(ca, ta[s2], pa[dy * 3 + dx]);
        pb[dy * 3 + dx] = fmaf(cb, tb[s2], pb[dy * 3 + dx]);
      }
    pa[9] += ca;
    pb[9] += cb;
    const size_t q = ((size_t)b * hw + (size_t)yy * W + xx) * C2;
    dt[q + c0 + j] = ga;
    dt[q + C + c0 + j] = gb;
  }
  __syncthreads();  // done with sT and sD: the group reduction reuses them

  float* sP = smem;  // (kThreads / kCC) groups x 2*kCC channels x 10
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    sP[(grp * 2 * kCC + j) * 10 + k] = pa[k];
    sP[(grp * 2 * kCC + kCC + j) * 10 + k] = pb[k];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * kCC * 10; idx += kThreads) {
    const int k = idx / (2 * kCC), ch = idx % (2 * kCC);
    float s = 0.f;
    for (int gi = 0; gi < kThreads / kCC; ++gi) s += sP[(gi * 2 * kCC + ch) * 10 + k];
    const int chan = ch < kCC ? c0 + ch : C + c0 + ch - kCC;
    part[(((size_t)b * gridDim.x + tile) * 10 + k) * C2 + chan] = s;
  }
}

// W: part[chunk][m][n] = sum over the chunk's pixels p of A(p, m) * B(p, n),
// part_bias[chunk][m] = sum of A(p, m).  grid (N / kNB, M / kNB, chunks).
//   MODE 5: A = dz * gamma (M = C),  B = h1 * h2 (N = C)         -> dW5, db5
//   MODE 4: A = dh (M = 2C),         B = LN2(y) * n2w + n2b      -> dW4, db4
//   MODE 3: A = du (M = C),          B = g * att                 -> dW3, db3
//   MODE 1: A = dt (M = 2C),         B = LN1(x) * n1w + n1b      -> dW1, db1
template <int MODE>
__global__ void __launch_bounds__(kThreads)
bwd_w_kernel(const float* __restrict__ a, const float* __restrict__ bm, const float* __restrict__ stats,
             const float* __restrict__ v0, const float* __restrict__ v1, float* __restrict__ part,
             float* __restrict__ part_bias, int npix, int HW, int C, int M, int N, int L) {
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = smem + kKC * kWS;
  const int n0 = blockIdx.x * kNB, m0 = blockIdx.y * kNB, chunk = blockIdx.z;
  const int pbeg = chunk * L, pend = min(npix, pbeg + L);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  auto load_a = [&](int p, int m) {
    if (MODE == 5) return a[(size_t)p * C + m] * v0[m];
    if (MODE == 3) return a[(size_t)p * C + m];
    return a[(size_t)p * 2 * C + m];
  };
  auto load_b = [&](int p, int n) {
    if (MODE == 5) return bm[(size_t)p * 2 * C + n] * bm[(size_t)p * 2 * C + C + n];
    if (MODE == 3) return bm[(size_t)p * C + n] * v0[(size_t)(p / HW) * C + n];
    return (bm[(size_t)p * C + n] - stats[2 * (size_t)p]) * stats[2 * (size_t)p + 1] * v0[n] + v1[n];
  };
  float acc[4][4], acc2[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  float bsum = 0.f;
  for (int q0 = pbeg; q0 < pend; q0 += kKC) {
    __syncthreads();
    // lanes run along m and n: coalesced reads, consecutive stores
    for (int idx = threadIdx.x; idx < kKC * kNB; idx += kThreads) {
      const int kk = idx / kNB, e = idx % kNB, p = q0 + kk;
      const bool in = p < pend;
      sA[kk * kWS + e] = in ? load_a(p, m0 + e) : 0.f;
      sB[kk * kWS + e] = in ? load_b(p, n0 + e) : 0.f;
    }
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x < kNB)
      for (int kk = 0; kk < kKC; ++kk) bsum += sA[kk * kWS + threadIdx.x];
    mma_chunk<4, false>(sA, kWS, sB, sB, acc, acc2);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      part[((size_t)chunk * M + m0 + ty + 16 * r) * N + n0 + tx + 16 * i] = acc[r][i];
  if (blockIdx.x == 0 && threadIdx.x < kNB) part_bias[(size_t)chunk * M + m0 + threadIdx.x] = bsum;
}

// Pixel chunks of a weight-gradient product with an M x N output: enough
// blocks to fill the card, chunks a multiple of kKC pixels.  Returns the chunk
// count and sets *len.
int w_chunks(int M, int N, int npix, int* len) {
  const int tiles = (M / kNB) * (N / kNB);
  const int max_chunks = (npix + kKC - 1) / kKC;
  int n = (kWBlocks + tiles - 1) / tiles;
  n = n < 1 ? 1 : (n > max_chunks ? max_chunks : n);
  int l = (npix + n - 1) / n;
  l = (l + kKC - 1) / kKC * kKC;
  *len = l;
  return (npix + l - 1) / l;
}

// The workspace: every intermediate map, the partial sums and colsum's scratch.
struct Plan {
  int B, H, W, C, HW, npix, rm, ntp, ntx, ntd, nrb;
  size_t dh, dln, dy, du, dg, dt, st2, st1, pdatt, datt, dgk, prow, pd, pw, pwb, sum, total;
};

Plan make_plan(int B, int H, int W, int C) {
  Plan pl;
  pl.B = B; pl.H = H; pl.W = W; pl.C = C;
  pl.HW = H * W;
  pl.npix = B * H * W;
  pl.rm = pl.npix >= 4096 ? 2 : 1;  // 32-pixel tiles where the map fills the card, else 16
  pl.ntp = (pl.HW + 16 * pl.rm - 1) / (16 * pl.rm);
  pl.ntx = (W + kDT - 1) / kDT;
  pl.ntd = pl.ntx * ((H + kDT - 1) / kDT);
  pl.nrb = (pl.npix + kRP - 1) / kRP;
  const size_t n = pl.npix;
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += (floats + 63) / 64 * 64;  // 256-byte aligned
    return at;
  };
  pl.dh = take(n * 2 * C);
  pl.dln = take(n * C);
  pl.dy = take(n * C);
  pl.du = take(n * C);
  pl.dg = take(n * C);
  pl.dt = take(n * 2 * C);
  pl.st2 = take(2 * n);
  pl.st1 = take(2 * n);
  pl.pdatt = take((size_t)B * pl.ntp * C);
  pl.datt = take((size_t)B * C);
  pl.dgk = take((size_t)B * C);
  pl.prow = take((size_t)pl.nrb * 4 * C);
  pl.pd = take((size_t)B * pl.ntd * 20 * C);
  size_t pw = 0, pwb = 0, sum = 0;
  for (int m = 1; m <= 2; ++m) {
    int len;
    const int nch = w_chunks(m * C, C, pl.npix, &len);
    pw = std::max(pw, (size_t)nch * m * C * C);
    pwb = std::max(pwb, (size_t)nch * m * C);
    sum = std::max(sum, colsum_scratch(1, nch, m * C * C));
  }
  pl.pw = take(pw);
  pl.pwb = take(pwb);
  sum = std::max(sum, colsum_scratch(B, pl.ntp, C));
  sum = std::max(sum, colsum_scratch(1, pl.nrb, C));
  sum = std::max(sum, colsum_scratch(1, B * pl.ntd, 18 * C));
  pl.sum = take(sum);
  pl.total = off;
  return pl;
}

template <int RM>
cudaError_t launch_pixel_passes_1(const Plan& pl, float* ws, const float* dz, const float* gamma, const float* w5,
                                  const float* h, const float* w4, cudaStream_t stream) {
  const int C = pl.C, smem = gemm_smem_floats(RM) * (int)sizeof(float);
  const dim3 grid(pl.ntp, C / kNB, pl.B);
  bwd_f1_kernel<RM><<<grid, kThreads, smem, stream>>>(dz, gamma, w5, h, ws + pl.dh, pl.HW, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_prod_kernel<RM><<<grid, kThreads, smem, stream>>>(ws + pl.dh, w4, ws + pl.dln, pl.HW, 2 * C, C);
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_a(const Plan& pl, float* ws, const float* w3, const float* att, const float* g,
                     cudaStream_t stream) {
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  bwd_a_kernel<RM><<<dim3(pl.ntp, pl.C / kNB, pl.B), kThreads, smem, stream>>>(
      ws + pl.du, w3, att, g, ws + pl.dg, ws + pl.pdatt, pl.HW, pl.C);
  return cudaGetLastError();
}

template <int RM>
cudaError_t launch_l1(const Plan& pl, float* ws, const float* w1, cudaStream_t stream) {
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  bwd_prod_kernel<RM><<<dim3(pl.ntp, pl.C / kNB, pl.B), kThreads, smem, stream>>>(
      ws + pl.dt, w1, ws + pl.dln, pl.HW, 2 * pl.C, pl.C);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_w(const Plan& pl, float* ws, const float* a, const float* bm, const float* stats,
                     const float* v0, const float* v1, float* dw, float* dbias, cudaStream_t stream) {
  const int C = pl.C, M = (MODE == 4 || MODE == 1) ? 2 * C : C, N = C;
  int len;
  const int nch = w_chunks(M, N, pl.npix, &len);
  const int smem = 2 * kKC * kWS * (int)sizeof(float);
  bwd_w_kernel<MODE><<<dim3(N / kNB, M / kNB, nch), kThreads, smem, stream>>>(
      a, bm, stats, v0, v1, ws + pl.pw, ws + pl.pwb, pl.npix, pl.HW, C, M, N, len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = colsum<2>(ws + pl.pw, 1, nch, M * N, M * N, dw, ws + pl.sum, stream)) != cudaSuccess) return err;
  return colsum<2>(ws + pl.pwb, 1, nch, M, M, dbias, ws + pl.sum, stream);
}

struct Grads {
  float *dx, *dn1w, *dn1b, *dw1, *db1, *dwdw, *dbdw, *dwsca, *dbsca, *dw3, *db3, *dbeta, *dn2w, *dn2b, *dw4, *db4,
      *dw5, *db5, *dgamma;
};

int naf_block_bwd(const float* x, const float* dz, const float* n1w, const float* n1b, const float* w1,
                  const float* wdw, const float* bdw, const float* wsca, const float* w3, const float* beta,
                  const float* n2w, const float* n2b, const float* w4, const float* w5, const float* gamma,
                  const float* g, const float* t, const float* u, const float* y, const float* h, const float* o,
                  const float* pooled, const float* att, const Grads& gr, float* ws, int B, int H, int W, int C,
                  float eps, cudaStream_t stream) {
  const Plan pl = make_plan(B, H, W, C);
  float* sum = ws + pl.sum;
  const int smem_ln = 4 * kRP * (int)sizeof(float);
  cudaError_t err;
#define CHECK(call)                             \
  if ((err = (call)) != cudaSuccess) return err;
#define CHECK_LAUNCH()                                       \
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // F1, F2: dh, dln2
  CHECK(pl.rm == 2 ? launch_pixel_passes_1<2>(pl, ws, dz, gamma, w5, h, w4, stream)
                   : launch_pixel_passes_1<1>(pl, ws, dz, gamma, w5, h, w4, stream));
  // R2: dy, du, and dn2w, dn2b, dgamma, dbeta
  bwd_ln_kernel<true><<<pl.nrb, kThreads, smem_ln, stream>>>(y, ws + pl.dln, dz, n2w, beta, o, u, ws + pl.dy, ws + pl.du,
                                                      ws + pl.st2, ws + pl.prow, pl.npix, C, eps);
  CHECK_LAUNCH();
  float* row_out[4] = {gr.dn2w, gr.dn2b, gr.dgamma, gr.dbeta};
  for (int k = 0; k < 4; ++k) CHECK(colsum<2>(ws + pl.prow + (size_t)k * C, 1, pl.nrb, C, 4 * C, row_out[k], sum, stream));
  // W: dW5, dW4
  CHECK(launch_w<5>(pl, ws, dz, h, nullptr, gamma, nullptr, gr.dw5, gr.db5, stream));
  CHECK(launch_w<4>(pl, ws, ws + pl.dh, y, ws + pl.st2, n2w, n2b, gr.dw4, gr.db4, stream));
  // A: dg (local part), datt
  CHECK(pl.rm == 2 ? launch_a<2>(pl, ws, w3, att, g, stream) : launch_a<1>(pl, ws, w3, att, g, stream));
  CHECK(colsum<2>(ws + pl.pdatt, B, pl.ntp, C, C, ws + pl.datt, sum, stream));
  CHECK(launch_w<3>(pl, ws, ws + pl.du, g, nullptr, att, nullptr, gr.dw3, gr.db3, stream));
  // S: dgk, dWsca, dbsca
  bwd_sca_kernel<<<dim3(C / kNB, B), kThreads, kThreads * sizeof(float), stream>>>(ws + pl.datt, wsca, ws + pl.dgk, C, (float)H * (float)W);
  CHECK_LAUNCH();
  bwd_sca_w_kernel<<<(unsigned)(((size_t)C * C + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      ws + pl.datt, pooled, gr.dwsca, gr.dbsca, B, C);
  CHECK_LAUNCH();
  // D: dt, dWdw, dbdw
  const int smem_d = 2 * kCC * (kDP2 + 1 + kDP1 + 1) * (int)sizeof(float);
  CHECK(cudaFuncSetAttribute(bwd_d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_d));
  bwd_d_kernel<<<dim3(pl.ntd, C / kCC, B), kThreads, smem_d, stream>>>(t, ws + pl.dg, ws + pl.dgk, wdw, bdw,
                                                                        ws + pl.dt, ws + pl.pd, H, W, C, pl.ntx);
  CHECK_LAUNCH();
  CHECK(colsum<2>(ws + pl.pd, 1, B * pl.ntd, 18 * C, 20 * C, gr.dwdw, sum, stream));
  CHECK(colsum<2>(ws + pl.pd + 18 * (size_t)C, 1, B * pl.ntd, 2 * C, 20 * C, gr.dbdw, sum, stream));
  // L1, R1: dln1, dx, and dn1w, dn1b
  CHECK(pl.rm == 2 ? launch_l1<2>(pl, ws, w1, stream) : launch_l1<1>(pl, ws, w1, stream));
  bwd_ln_kernel<false><<<pl.nrb, kThreads, smem_ln, stream>>>(x, ws + pl.dln, ws + pl.dy, n1w, nullptr, nullptr, nullptr,
                                                       gr.dx, nullptr, ws + pl.st1, ws + pl.prow, pl.npix, C, eps);
  CHECK_LAUNCH();
  CHECK(colsum<2>(ws + pl.prow, 1, pl.nrb, C, 2 * C, gr.dn1w, sum, stream));
  CHECK(colsum<2>(ws + pl.prow + C, 1, pl.nrb, C, 2 * C, gr.dn1b, sum, stream));
  // W: dW1
  CHECK(launch_w<1>(pl, ws, ws + pl.dt, x, ws + pl.st1, n1w, n1b, gr.dw1, gr.db1, stream));
#undef CHECK
#undef CHECK_LAUNCH
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Every pointer is a device pointer
// to fp32.  Inputs: x and dz (B, H, W, C); the 14 parameters the backward reads
// in PyTorch's layout; the forward's residuals g, t, u, y, h, o, pooled, att
// (see naf_block.cu).  Outputs: dx (B, H, W, C) and the 18 parameter
// gradients.  ws holds naf_block_bwd_workspace_floats(B, H, W, C) floats.
// Returns the first CUDA error, or 0.
extern "C" int naf_block_bwd_f32(
    const void* x, const void* dz, const void* n1w, const void* n1b, const void* w1, const void* wdw,
    const void* bdw, const void* wsca, const void* w3, const void* beta, const void* n2w, const void* n2b,
    const void* w4, const void* w5, const void* gamma, const void* g, const void* t, const void* u, const void* y,
    const void* h, const void* o, const void* pooled, const void* att, void* dx, void* dn1w, void* dn1b, void* dw1,
    void* db1, void* dwdw, void* dbdw, void* dwsca, void* dbsca, void* dw3, void* db3, void* dbeta, void* dn2w,
    void* dn2b, void* dw4, void* db4, void* dw5, void* db5, void* dgamma, void* ws, int B, int H, int W, int C,
    float eps, void* stream) {
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto m = [](void* v) { return static_cast<float*>(v); };
  const Grads gr{m(dx), m(dn1w), m(dn1b), m(dw1), m(db1), m(dwdw), m(dbdw), m(dwsca), m(dbsca), m(dw3),
                 m(db3), m(dbeta), m(dn2w), m(dn2b), m(dw4), m(db4), m(dw5), m(db5), m(dgamma)};
  return naf_block_bwd(f(x), f(dz), f(n1w), f(n1b), f(w1), f(wdw), f(bdw), f(wsca), f(w3), f(beta), f(n2w), f(n2b),
                       f(w4), f(w5), f(gamma), f(g), f(t), f(u), f(y), f(h), f(o), f(pooled), f(att), gr, m(ws), B,
                       H, W, C, eps, static_cast<cudaStream_t>(stream));
}

extern "C" long long naf_block_bwd_workspace_floats(int B, int H, int W, int C) {
  return (long long)make_plan(B, H, W, C).total;
}
