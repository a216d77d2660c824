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
// P1, P2b and P2c live in naf_common.cuh, shared with K4 (naf_prefix.cu) and
// K5 (naf_ffn.cu); SCA and P2a are K1's own.

#include "naf_common.cuh"

namespace {

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
  naf_p2a_kernel<T, RM><<<grid, kThreads, gemm_smem_floats(RM) * (int)sizeof(float), stream>>>(
      g, x, att, w3, b3, beta, y, sv.u, HW, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ffn<float, T, RM>(y, n2w, n2b, w4, b4, w5, b5, gamma, hidden, z, sv.h, sv.o, B, HW, C, eps, stream);
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
  const int ntiles = ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  cudaError_t err = launch_p1<T>(p(x_), p(n1w_), p(n1b_), p(w1_), p(b1_), p(wdw_), p(bdw_), g, part, sv.t, B, H, W,
                                 C, eps, stream);
  if (err != cudaSuccess) return err;
  naf_sca_kernel<T><<<dim3(C / kNB, B), kThreads, C * (int)sizeof(float), stream>>>(part, ntiles, p(wsca_), p(bsca_), att, sv.pooled, C, (float)H * (float)W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p2_rows((long long)B * H * W) == 2)
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
