// The NAFBlock's two halves as SIMT fp32 kernels that two CUDA sources share:
//
//   naf_p1_kernel   LN1 -> 1x1 C->2C -> depthwise 3x3 -> SimpleGate on halo tiles
//                   (with no tile-sum buffer, all of K4, naf_prefix.cu)
//   naf_p2b_kernel  hidden = gate(LN2(y) . W4^T + b4)
//   naf_p2c_kernel  z = y + gamma * (hidden . W5^T + b5)
//                   (the two together are K5, naf_ffn.cu)
//
// Each is templated on the I/O type T of its weights and output, and the FFN
// passes also on the type TY of y (K5 hands them the caller's map in T).  The
// math is fp32 throughout.  Weights come in PyTorch's layout:
// every 1x1 as (out, in) row-major, the depthwise 3x3 as (2C, 3, 3).
#pragma once

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kTileH = 6, kTileW = 14;    // P1 output tile
constexpr int kHaloW = kTileW + 2;        // P1 halo tile: 8 x 16 = 128 pixels
constexpr int kNPX = (kTileH + 2) * kHaloW;
constexpr int kCC = 64;                   // P1 gate channels per block (paired with C + j)

// P1's dynamic shared memory in bytes
constexpr int p1_smem_bytes() { return (2 * kNPX + 2 * kCC * (kNPX + 1)) * (int)sizeof(float); }

// P1, per (batch, 6x14 output tile with a 1-pixel halo, 64 gate channels): the
// gated map g (B, H, W, C); with part, the tile's channel sums of g into
// part (B, n_tiles, C); with t_out, the expanded map t (B, H, W, 2C) in fp32.
// The dwconv border follows the reference: the EXPANDED map t is zero outside
// the image (F.conv2d(t, padding=1)), so halo pixels outside the image are
// zeroed after the 1x1 expand, never before it.  Ragged tiles are masked.
template <typename T>
__global__ void __launch_bounds__(kThreads)
naf_p1_kernel(const T* __restrict__ x, const T* __restrict__ n1w, const T* __restrict__ n1b,
              const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ wdw,
              const T* __restrict__ bdw, T* __restrict__ g, float* __restrict__ part,
              float* __restrict__ t_out, int H, int W, int C, int ntx, float eps) {
  extern __shared__ float smem[];
  constexpr int lda = kNPX + 1;
  float* sMu = smem;               // kNPX: LN1 mean of each halo pixel
  float* sRs = sMu + kNPX;         // kNPX: LN1 1/sigma
  float* sT = sRs + kNPX;          // 2*kCC x lda: expanded map, channel-major (aliases the product's buffers)

  const int tile = blockIdx.x, c0 = blockIdx.y * kCC, b = blockIdx.z;
  const int y0 = (tile / ntx) * kTileH - 1, x0 = (tile % ntx) * kTileW - 1;  // halo origin
  const size_t hw = (size_t)H * W;
  const T* xb = x + (size_t)b * hw * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto inside = [&](int q, int& yy, int& xx) {
    yy = y0 + q / kHaloW;
    xx = x0 + q % kHaloW;
    return yy >= 0 && yy < H && xx >= 0 && xx < W;
  };

  // LN1 statistics of the halo pixels, one warp per pixel (biased variance)
  for (int q = warp; q < kNPX; q += kThreads / 32) {
    int yy, xx;
    const bool in = inside(q, yy, xx);
    const T* row = xb + (in ? ((size_t)yy * W + xx) * C : 0);
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
      sMu[q] = mu;
      sRs[q] = 1.f / sqrtf(v / C + eps);
    }
  }

  // t[q][j] = LN1(x)[q] . w1[c0 + j]  and  t2[q][j] = LN1(x)[q] . w1[C + c0 + j]
  float acc[8][4], acc2[8][4];
  gemm_block<8, true, false>(sT, w1, C, C, c0, C, [&](int q, int k) {
    int yy, xx;
    if (!inside(q, yy, xx)) return 0.f;
    return (ld(xb[((size_t)yy * W + xx) * C + k]) - sMu[q]) * sRs[q] * ld(n1w[k]) + ld(n1b[k]);
  }, acc, acc2);
  __syncthreads();  // the product is done with its buffers before sT overwrites them

  // bias, then zero the expanded map outside the image (the dwconv's border);
  // for training, the tile's own in-image pixels of t go to t_out
  {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int q = ty + 16 * r;
      int yy, xx;
      const bool in = inside(q, yy, xx);
      const int qy = q / kHaloW, qx = q % kHaloW;
      const bool own = in && t_out && qy >= 1 && qy <= kTileH && qx >= 1 && qx <= kTileW;
      float* trow = own ? t_out + ((size_t)b * hw + (size_t)yy * W + xx) * 2 * C : nullptr;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = tx + 16 * i;
        const float ta = in ? acc[r][i] + ld(b1[c0 + j]) : 0.f;
        const float tb = in ? acc2[r][i] + ld(b1[C + c0 + j]) : 0.f;
        sT[j * lda + q] = ta;
        sT[(kCC + j) * lda + q] = tb;
        if (own) {
          trow[c0 + j] = ta;
          trow[C + c0 + j] = tb;
        }
      }
    }
  }
  __syncthreads();

  // depthwise 3x3 (cross-correlation, as F.conv2d) on both halves, gate, tile sums
  const int j = threadIdx.x & (kCC - 1), grp = threadIdx.x / kCC;
  float wa[9], wb[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    wa[t] = ld(wdw[(size_t)(c0 + j) * 9 + t]);
    wb[t] = ld(wdw[(size_t)(C + c0 + j) * 9 + t]);
  }
  const float ba = ld(bdw[c0 + j]), bb = ld(bdw[C + c0 + j]);
  const float* ta = sT + j * lda;
  const float* tb = sT + (kCC + j) * lda;
  float psum = 0.f;
  for (int o = grp; o < kTileH * kTileW; o += kThreads / kCC) {
    const int oy = o / kTileW, ox = o % kTileW;
    const int yy = y0 + 1 + oy, xx = x0 + 1 + ox;
    if (yy >= H || xx >= W) continue;
    float da = ba, db = bb;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int q = (oy + dy) * kHaloW + ox + dx;
        da = fmaf(ta[q], wa[dy * 3 + dx], da);
        db = fmaf(tb[q], wb[dy * 3 + dx], db);
      }
    const float gv = da * db;
    psum += gv;
    g[((size_t)b * hw + (size_t)yy * W + xx) * C + c0 + j] = st<T>(gv);
  }
  if (!part) return;  // uniform across the block: no thread waits at the barrier below
  float* sP = smem;  // kThreads floats over the (dead) LN1 statistics
  sP[threadIdx.x] = psum;
  __syncthreads();
  if (threadIdx.x < kCC) {
    float s = 0.f;
    for (int k = 0; k < kThreads / kCC; ++k) s += sP[k * kCC + threadIdx.x];
    part[((size_t)b * gridDim.x + tile) * C + c0 + threadIdx.x] = s;
  }
}

// P1 over the whole map on ``stream``; part and t_out may be null.
template <typename T>
cudaError_t launch_p1(const T* x, const T* n1w, const T* n1b, const T* w1, const T* b1, const T* wdw, const T* bdw,
                      T* g, float* part, float* t_out, int B, int H, int W, int C, float eps, cudaStream_t stream) {
  const int ntx = (W + kTileW - 1) / kTileW, nty = (H + kTileH - 1) / kTileH;
  cudaError_t err = cudaFuncSetAttribute(naf_p1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, p1_smem_bytes());
  if (err != cudaSuccess) return err;
  naf_p1_kernel<T><<<dim3(ntx * nty, C / kCC, B), kThreads, p1_smem_bytes(), stream>>>(
      x, n1w, n1b, w1, b1, wdw, bdw, g, part, t_out, H, W, C, ntx, eps);
  return cudaGetLastError();
}

// The P2 kernels share one grid: (pixel tiles of 16 * RM, C / kNB column blocks, B).
#define P2_PROLOGUE                                                 \
  constexpr int P = 16 * RM;                                        \
  extern __shared__ float smem[];                                   \
  const int b = blockIdx.z, p0 = blockIdx.x * P, n0 = blockIdx.y * kNB; \
  const int np = min(P, HW - p0);                                   \
  const size_t base = ((size_t)b * HW + p0) * C;                    \
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;           \
  float acc[RM][4], acc2[RM][4];

// hidden = (LN2(y) . w4[:C]^T + b4[:C]) * (LN2(y) . w4[C:]^T + b4[C:]), fp32;
// with h_out, h = LN2(y) . W4^T + b4 (B, H, W, 2C) in fp32 as well
template <typename TY, typename T, int RM>
__global__ void __launch_bounds__(kThreads)
naf_p2b_kernel(const TY* __restrict__ y, const T* __restrict__ n2w, const T* __restrict__ n2b,
               const T* __restrict__ w4, const T* __restrict__ b4, float* __restrict__ hidden,
               float* __restrict__ h_out, int HW, int C, float eps) {
  P2_PROLOGUE
  float* sMu = smem;  // P: LN2 mean of each pixel
  float* sRs = smem + P;
  // LN2 statistics, one warp per pixel (biased variance)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < P; p += kThreads / 32) {
    const bool in = p < np;
    const TY* row = y + base + (in ? (size_t)p * C : 0);
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
  gemm_block<RM, true, false>(smem + 2 * P, w4, C, C, n0, C, [&](int p, int k) {
    return p < np ? (ld(y[base + (size_t)p * C + k]) - sMu[p]) * sRs[p] * ld(n2w[k]) + ld(n2b[k]) : 0.f;
  }, acc, acc2);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np) {
        const float h1 = acc[r][i] + ld(b4[n]), h2 = acc2[r][i] + ld(b4[C + n]);
        hidden[base + (size_t)p * C + n] = h1 * h2;
        if (h_out) {
          float* hrow = h_out + ((size_t)b * HW + p0 + p) * 2 * C;
          hrow[n] = h1;
          hrow[C + n] = h2;
        }
      }
    }
}

// z = y + gamma * (hidden . w5^T + b5); with o_out, o = hidden . W5^T + b5 in fp32
template <typename TY, typename T, int RM>
__global__ void __launch_bounds__(kThreads)
naf_p2c_kernel(const float* __restrict__ hidden, const TY* __restrict__ y, const T* __restrict__ w5,
               const T* __restrict__ b5, const T* __restrict__ gamma, T* __restrict__ z,
               float* __restrict__ o_out, int HW, int C) {
  P2_PROLOGUE
  gemm_block<RM, false, false>(smem, w5, C, C, n0, 0, [&](int p, int k) {
    return p < np ? hidden[base + (size_t)p * C + k] : 0.f;
  }, acc, acc2);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np) {
        const size_t o = base + (size_t)p * C + n;
        const float ov = acc[r][i] + ld(b5[n]);
        z[o] = st<T>(ld(y[o]) + ld(gamma[n]) * ov);
        if (o_out) o_out[o] = ov;
      }
    }
}

// 32-pixel tiles where the map has pixels enough to fill the card, 16-pixel ones on the deep stages
inline int p2_rows(long long pixels) { return pixels >= 4096 ? 2 : 1; }

// The FFN half (P2b then P2c) over (B, HW, C) on ``stream``; hidden (B, HW, C)
// fp32 scratch; h_out and o_out may be null.
template <typename TY, typename T, int RM>
cudaError_t launch_ffn(const TY* y, const T* n2w, const T* n2b, const T* w4, const T* b4, const T* w5, const T* b5,
                       const T* gamma, float* hidden, T* z, float* h_out, float* o_out, int B, int HW, int C,
                       float eps, cudaStream_t stream) {
  constexpr int P = 16 * RM;
  const dim3 grid((HW + P - 1) / P, C / kNB, B);
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  naf_p2b_kernel<TY, T, RM><<<grid, kThreads, smem + 2 * P * (int)sizeof(float), stream>>>(
      y, n2w, n2b, w4, b4, hidden, h_out, HW, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  naf_p2c_kernel<TY, T, RM><<<grid, kThreads, smem, stream>>>(hidden, y, w5, b5, gamma, z, o_out, HW, C);
  return cudaGetLastError();
}

}  // namespace
