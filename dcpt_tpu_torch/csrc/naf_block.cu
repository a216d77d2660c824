// Whole-NAFBlock forward on Hopper (sm_90a): SIMT fp32 math, fp32 or bf16 I/O.
//
// Replaces the TPU kernel dcpt_tpu/ops/naf_block.py::naf_block_fused
// (_block_pallas_v1: _p1_kernel + host SCA + _p2_kernel).  It computes what
// naf_block_ref computes on a (B, H, W, C) channels-last map, dw = ffn = 2C:
//
//   P1   per (batch, 6x14 output tile with a 1-pixel halo, 64 gate channels):
//        LN1 -> 1x1 C->2C (only the 2x64 columns of this block's gate pairs)
//        -> depthwise 3x3 -> SimpleGate.  Writes g (B, H, W, C) and the
//        per-tile channel sums of g to a (B, n_tiles, C) fp32 scratch.
//   SCA  per (batch, 64 output channels): the tile sums reduced in tile
//        order (no atomics, so the result is deterministic), divided by H*W,
//        then att = pooled . Wsca^T + bsca.
//   P2a  per (batch, pixel tile, 64 output channels): y = x + beta*((g*att) . W3^T + b3)
//   P2b  likewise: hidden = gate(LN2(y) . W4^T + b4), the pair (n, C + n) in one block
//   P2c  likewise: z = y + gamma*(hidden . W5^T + b5)
//   y and hidden live in fp32 scratch (B, H, W, C).
//
// For training (naf_block_bwd.cu) the same passes also write what the backward
// reads: the SCA mean pooled (B, C), the expanded map t (B, H, W, 2C) from P1,
// u = (g*att) . W3^T + b3 from P2a, h = LN2(y) . W4^T + b4 (B, H, W, 2C) from
// P2b and o = hidden . W5^T + b5 from P2c, all fp32; g and y are kept as well.
// Each of these pointers is null in eval, and then nothing extra is written.
//
// The dwconv border follows the reference: the EXPANDED map t is zero outside
// the image (F.conv2d(t, padding=1)), so halo pixels outside the image are
// zeroed after the 1x1 expand, never before it.  Ragged tiles are masked, so
// every H x W is taken, down to 1 x 1.
//
// What bounds it on this card: the block is 6*C^2 multiply-adds (12*C^2 flops)
// per pixel (1x1 products of C x 2C, C x C, C x 2C and C x C), i.e. arithmetic on every
// stage from C = 64 up, run here on the SIMT fp32 pipes from shared memory.
// Each product streams its weight through shared memory in 32-deep K-chunks
// (the middle block's C x 2C weight is 8 MB in fp32, far above the 227 KB a
// block holds), so its ceiling is shared-memory bandwidth: about one shared
// load per two multiply-adds.  The deep stages have few pixels (C = 512 works
// on a 16 x 16 map), so the design spreads every product of P2 over a grid of
// pixel tiles x 64-column blocks: parallelism first, at the price of writing
// y and the hidden map to device memory (they stay in the 50 MB L2 at these
// sizes).  P1 keeps its expanded 2 x 64-channel halo tile in shared memory,
// so in eval the 2C-wide map t never reaches device memory.  wgmma/TMA tiles are the
// next step.
//
// Weights come in PyTorch's layout: every 1x1 as (out, in) row-major, the
// depthwise 3x3 as (2C, 3, 3), so a module's parameters are passed as they are.

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kTileH = 6, kTileW = 14;    // P1 output tile
constexpr int kHaloW = kTileW + 2;        // P1 halo tile: 8 x 16 = 128 pixels
constexpr int kNPX = (kTileH + 2) * kHaloW;
constexpr int kCC = 64;                   // P1 gate channels per block (paired with C + j)

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
  float* sP = smem;  // kThreads floats over the (dead) LN1 statistics
  sP[threadIdx.x] = psum;
  __syncthreads();
  if (threadIdx.x < kCC) {
    float s = 0.f;
    for (int k = 0; k < kThreads / kCC; ++k) s += sP[k * kCC + threadIdx.x];
    part[((size_t)b * gridDim.x + tile) * C + c0 + threadIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
naf_sca_kernel(const float* __restrict__ part, int ntiles, const T* __restrict__ wsca,
               const T* __restrict__ bsca, float* __restrict__ att, float* __restrict__ pooled, int C, float hw) {
  extern __shared__ float smem[];  // C: pooled mean
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int t = 0; t < ntiles; ++t) s += part[((size_t)b * ntiles + t) * C + c];
    smem[c] = s / hw;
    if (pooled && blockIdx.x == 0) pooled[(size_t)b * C + c] = s / hw;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int oo = warp; oo < kNB; oo += kThreads / 32) {
    const int o = blockIdx.x * kNB + oo;
    float s = 0.f;
    for (int i = lane; i < C; i += 32) s += smem[i] * ld(wsca[(size_t)o * C + i]);
    s = warp_sum(s);
    if (lane == 0) att[(size_t)b * C + o] = s + ld(bsca[o]);
  }
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

// y = x + beta * ((g * att) . w3^T + b3), y in fp32
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
naf_p2a_kernel(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ att,
               const T* __restrict__ w3, const T* __restrict__ b3, const T* __restrict__ beta,
               float* __restrict__ y, float* __restrict__ u_out, int HW, int C) {
  P2_PROLOGUE
  const float* ab = att + (size_t)b * C;
  gemm_block<RM, false, false>(smem, w3, C, C, n0, 0, [&](int p, int k) {
    return p < np ? ld(g[base + (size_t)p * C + k]) * ab[k] : 0.f;
  }, acc, acc2);
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np) {
        const size_t o = base + (size_t)p * C + n;
        const float u = acc[r][i] + ld(b3[n]);
        y[o] = ld(x[o]) + ld(beta[n]) * u;
        if (u_out) u_out[o] = u;
      }
    }
}

// hidden = (LN2(y) . w4[:C]^T + b4[:C]) * (LN2(y) . w4[C:]^T + b4[C:]), fp32
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
naf_p2b_kernel(const float* __restrict__ y, const T* __restrict__ n2w, const T* __restrict__ n2b,
               const T* __restrict__ w4, const T* __restrict__ b4, float* __restrict__ hidden,
               float* __restrict__ h_out, int HW, int C, float eps) {
  P2_PROLOGUE
  float* sMu = smem;  // P: LN2 mean of each pixel
  float* sRs = smem + P;
  // LN2 statistics, one warp per pixel (biased variance)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < P; p += kThreads / 32) {
    const bool in = p < np;
    const float* row = y + base + (in ? (size_t)p * C : 0);
    float s = 0.f;
    if (in)
      for (int c = lane; c < C; c += 32) s += row[c];
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    if (in)
      for (int c = lane; c < C; c += 32) {
        const float d = row[c] - mu;
        v += d * d;
      }
    v = warp_sum(v);
    if (lane == 0) {
      sMu[p] = mu;
      sRs[p] = 1.f / sqrtf(v / C + eps);
    }
  }
  gemm_block<RM, true, false>(smem + 2 * P, w4, C, C, n0, C, [&](int p, int k) {
    return p < np ? (y[base + (size_t)p * C + k] - sMu[p]) * sRs[p] * ld(n2w[k]) + ld(n2b[k]) : 0.f;
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

// z = y + gamma * (hidden . w5^T + b5)
template <typename T, int RM>
__global__ void __launch_bounds__(kThreads)
naf_p2c_kernel(const float* __restrict__ hidden, const float* __restrict__ y, const T* __restrict__ w5,
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
        z[o] = st<T>(y[o] + ld(gamma[n]) * ov);
        if (o_out) o_out[o] = ov;
      }
    }
}

// What the passes write for the backward; every pointer null in eval.
struct Saved {
  float *pooled, *t, *u, *h, *o;
};

template <typename T, int RM>
cudaError_t launch_p2(const T* g, const T* x, const float* att, const T* w3, const T* b3, const T* beta,
                      const T* n2w, const T* n2b, const T* w4, const T* b4, const T* w5, const T* b5,
                      const T* gamma, float* y, float* hidden, T* z, const Saved& sv, int B, int HW, int C,
                      float eps, cudaStream_t stream) {
  constexpr int P = 16 * RM;
  const dim3 grid((HW + P - 1) / P, C / kNB, B);
  const int smem = gemm_smem_floats(RM) * (int)sizeof(float);
  naf_p2a_kernel<T, RM><<<grid, kThreads, smem, stream>>>(g, x, att, w3, b3, beta, y, sv.u, HW, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  naf_p2b_kernel<T, RM><<<grid, kThreads, smem + 2 * P * (int)sizeof(float), stream>>>(y, n2w, n2b, w4, b4, hidden, sv.h, HW, C, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  naf_p2c_kernel<T, RM><<<grid, kThreads, smem, stream>>>(hidden, y, w5, b5, gamma, z, sv.o, HW, C);
  return cudaGetLastError();
}

template <typename T>
int naf_block_fwd(const void* x_, const void* n1w_, const void* n1b_, const void* w1_, const void* b1_,
                  const void* wdw_, const void* bdw_, const void* wsca_, const void* bsca_, const void* w3_,
                  const void* b3_, const void* beta_, const void* n2w_, const void* n2b_, const void* w4_,
                  const void* b4_, const void* w5_, const void* b5_, const void* gamma_, void* g_, void* part_,
                  void* att_, void* y_, void* hidden_, void* z_, const Saved& sv, int B, int H, int W, int C,
                  float eps, void* stream_) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  T* g = static_cast<T*>(g_);
  float* part = static_cast<float*>(part_);
  float* att = static_cast<float*>(att_);
  float* y = static_cast<float*>(y_);
  float* hidden = static_cast<float*>(hidden_);
  const int ntx = (W + kTileW - 1) / kTileW, nty = (H + kTileH - 1) / kTileH;
  const int smem1 = (2 * kNPX + 2 * kCC * (kNPX + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(naf_p1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  naf_p1_kernel<T><<<dim3(ntx * nty, C / kCC, B), kThreads, smem1, stream>>>(p(x_), p(n1w_), p(n1b_), p(w1_), p(b1_), p(wdw_), p(bdw_), g, part, sv.t, H, W, C, ntx, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  naf_sca_kernel<T><<<dim3(C / kNB, B), kThreads, C * (int)sizeof(float), stream>>>(part, ntx * nty, p(wsca_), p(bsca_), att, sv.pooled, C, (float)H * (float)W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 32-pixel tiles where the map has pixels enough to fill the card, 16-pixel ones on the deep stages
  if ((long long)B * H * W >= 4096)
    return launch_p2<T, 2>(g, p(x_), att, p(w3_), p(b3_), p(beta_), p(n2w_), p(n2b_), p(w4_), p(b4_), p(w5_), p(b5_), p(gamma_), y, hidden, static_cast<T*>(z_), sv, B, H * W, C, eps, stream);
  return launch_p2<T, 1>(g, p(x_), att, p(w3_), p(b3_), p(beta_), p(n2w_), p(n2b_), p(w4_), p(b4_), p(w5_), p(b5_), p(gamma_), y, hidden, static_cast<T*>(z_), sv, B, H * W, C, eps, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer; g (B, H, W, C) in the I/O type, part (B, n_tiles, C), att (B, C),
// y and hidden (B, H, W, C) in fp32 are scratch the caller allocates.  The
// residuals of a differentiated call, all fp32 and each null in eval, are
// pooled (B, C), t (B, H, W, 2C), u (B, H, W, C), h (B, H, W, 2C) and
// o (B, H, W, C).  Returns cudaGetLastError().
#define NAF_BLOCK_ARGS                                                                                          \
  const void *x, const void *n1w, const void *n1b, const void *w1, const void *b1, const void *wdw,           \
      const void *bdw, const void *wsca, const void *bsca, const void *w3, const void *b3, const void *beta,   \
      const void *n2w, const void *n2b, const void *w4, const void *b4, const void *w5, const void *b5,       \
      const void *gamma, void *g, void *part, void *att, void *y, void *hidden, void *z, void *pooled, void *t, \
      void *u, void *h, void *o, int B, int H, int W, int C, float eps, void *stream
#define NAF_BLOCK_PASS                                                                                          \
  x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta, n2w, n2b, w4, b4, w5, b5, gamma, g, part, att, y,    \
      hidden, z,                                                                                                \
      Saved{static_cast<float*>(pooled), static_cast<float*>(t), static_cast<float*>(u), static_cast<float*>(h), \
            static_cast<float*>(o)},                                                                            \
      B, H, W, C, eps, stream

extern "C" int naf_block_fwd_f32(NAF_BLOCK_ARGS) { return naf_block_fwd<float>(NAF_BLOCK_PASS); }
extern "C" int naf_block_fwd_bf16(NAF_BLOCK_ARGS) { return naf_block_fwd<__nv_bfloat16>(NAF_BLOCK_PASS); }

// P1's tile grid, so the caller can size the partial-sum scratch.
extern "C" int naf_block_num_tiles(int H, int W) {
  return ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
}
