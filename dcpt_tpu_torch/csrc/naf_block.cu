// Whole-NAFBlock forward on Hopper (sm_90a): fp32 math, fp32 or bf16 I/O; the
// 1x1 products on the tensor cores.
//
// Replaces the TPU kernel dcpt_tpu/ops/naf_block.py::naf_block_fused
// (_block_pallas_v1: _p1_kernel + host SCA + _p2_kernel).  It computes what
// naf_block_ref computes on a (B, H, W, C) channels-last map, dw = ffn = 2C:
//
//   LN1   LN1(x) (B, HW, C) fp32 scratch
//   W1    t = LN1(x) . W1^T + b1 (B, HW, 2C) fp32
//   gate  per (image row segment, 32 gate channels): depthwise 3x3 of t with
//         its bias on channels j and C + j, SimpleGate: g (B, H, W, C) in the
//         I/O type, and each segment's channel sums of g (fp32)
//   SCA   per (batch, 64 output channels): the segment sums reduced in
//         segment order (no atomics, so the result is deterministic), divided
//         by H*W, then att = pooled . Wsca^T + bsca
//   scale ga = g * att (B, HW, C) fp32 scratch
//   W3    u = ga . W3^T + b3, y = x + beta * u (B, HW, C) fp32
//   LN2   LN2(y) fp32 scratch
//   W4    h = LN2(y) . W4^T + b4, hidden = h[:C] * h[C:] (B, HW, C) fp32
//   W5    o = hidden . W5^T + b5, z = y + gamma * o, in the I/O type
//
// For training (naf_block_bwd.cu) the same passes also write what the backward
// reads: the SCA mean pooled (B, C), the expanded map t (B, H, W, 2C) from W1,
// u from W3, h (B, H, W, 2C) from W4 and o from W5, all fp32; g and y are
// kept as well.  Each of these pointers is null in eval, and then t goes to
// scratch and nothing else extra is written.
//
// The dwconv border follows the reference: the EXPANDED map t is zero outside
// the image (F.conv2d(t, padding=1)), never the expand of a zero pixel.
// Ragged rows, columns and segments are masked, so every H x W is taken, down
// to 1 x 1.
//
// What bounds it on this card: 6 C^2 multiply-adds (12 C^2 flops) a pixel in
// the four 1x1 products (C x 2C, C x C, C x 2C, C x C), over 95 % of the
// flops from C = 64 up: operations.  They run on the tensor cores through
// tc_gemm.cuh (token_bwd.cuh's product_epi, a PyTorch (out, in) weight read
// k-major): 96 x 96 tiles of mma.sync m16n8k8 TF32 with fp32 sums, three MMAs
// a step for two fp32 operands (3xTF32, fp32 accuracy; 495 / 3 TFLOP/s against
// the SIMT pipes' 67), two for an fp32 map and a bf16 weight.  The product
// stages raw operands by cp.async, so an operand formed from a map is written
// once: each LayerNorm (ln_fwd_kernel) and g * att (one scale per image and
// channel).  W4's rows are staged with each gate pair side by side (2j <- j,
// 2j + 1 <- C + j: tc_gemm.cuh's paired operand), so that W4's epilogue holds
// h1 and h2 of a channel in one column pair and writes hidden = h1 h2 itself;
// biases, beta, gamma and the residuals are epilogues.  The expand is computed
// once a pixel (a 6 x 14 tile's 1-pixel halo would recompute 52 % of it), at
// the price of writing t (2C floats a pixel, which training keeps anyway) and
// reading it back in the gate pass, mostly from the 50 MB L2.  The deep stages
// have few pixels (29 of NAFNet-w64's 36 blocks are c = 512 on 16 x 16): where
// a product's tiles leave the card idle (2048 rows at B = 8) it is cut along
// its depth and its chunks added in a fixed order before the epilogue
// (chunk_epi_kernel); below 1024 rows (256 at B = 1) the cut's extra launches
// would cost the host more than they save the device, so it is not
// (kForwardMinCutRows).  wgmma/TMA tiles are the next step.
//
// Weights come in PyTorch's layout: every 1x1 as (out, in) row-major, the
// depthwise 3x3 as (2C, 3, 3), so a module's parameters are passed as they are.
// The gate pass and the W1, W4 and W5 epilogues are naf_common.cuh's, which
// K4 (naf_prefix.cu) and K5 (naf_ffn.cu) run as their halves of the block.

#include <algorithm>

#include "naf_common.cuh"

namespace {

constexpr int kScaC = 64;  // SCA: output channels of a block

template <typename T>
__global__ void __launch_bounds__(kThreads)
naf_sca_kernel(const float* __restrict__ part, int ntiles, const T* __restrict__ wsca,
               const T* __restrict__ bsca, float* __restrict__ att, float* __restrict__ pooled, int C, float hw) {
  extern __shared__ float smem[];  // C: pooled mean; then kThreads: the groups' sums
  const int b = blockIdx.y;
  // G groups of C threads (C < kThreads) each add a stretch of the segments in
  // order, then the groups' sums are added in order: the same bits every run
  const int G = C < kThreads ? kThreads / C : 1, per = (ntiles + G - 1) / G;
  float* sG = smem + C;
  for (int c = threadIdx.x % C, grp = threadIdx.x / C; grp < G && c < C; c += kThreads) {
    float s = 0.f;
    for (int t = grp * per; t < min(ntiles, (grp + 1) * per); ++t) s += part[((size_t)b * ntiles + t) * C + c];
    if (G == 1) {
      smem[c] = s / hw;
      if (pooled && blockIdx.x == 0) pooled[(size_t)b * C + c] = s / hw;
    } else {
      sG[grp * C + c] = s;
    }
  }
  __syncthreads();
  if (G > 1) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int grp = 0; grp < G; ++grp) s += sG[grp * C + c];
      smem[c] = s / hw;
      if (pooled && blockIdx.x == 0) pooled[(size_t)b * C + c] = s / hw;
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int oo = warp; oo < kScaC; oo += kThreads / 32) {
    const int o = blockIdx.x * kScaC + oo;
    float s = 0.f;
    for (int i = lane; i < C; i += 32) s += smem[i] * ld(wsca[(size_t)o * C + i]);
    s = warp_sum(s);
    if (lane == 0) att[(size_t)b * C + o] = s + ld(bsca[o]);
  }
}

// ga = g * att per element, att per image and channel: W3's operand
template <typename T>
__global__ void __launch_bounds__(kThreads)
naf_scale_kernel(const T* __restrict__ g, const float* __restrict__ att, float* __restrict__ ga, int HW, int C,
                 long long total) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long p = e / C;
  const int c = (int)(e % C);
  ga[e] = ld(g[e]) * att[(p / HW) * C + c];
}

// u = acc + b3, y = x + beta * u (and u_out): W3's epilogue (C even)
template <typename T>
struct SpatialEpi {
  const T *x, *b3, *beta;
  float *y, *u_out;
  int C;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    const size_t q = (size_t)r * C + n;
    const float u0 = v0 + ld(b3[n]), u1 = v1 + ld(b3[n + 1]);
    store_pair(y + q, ld(x[q]) + ld(beta[n]) * u0, ld(x[q + 1]) + ld(beta[n + 1]) * u1, true);
    if (u_out) store_pair(u_out + q, u0, u1, true);
  }
};

// What the passes write for the backward; every pointer null in eval.
struct Saved {
  float *pooled, *t, *u, *h, *o;
};

// The fp32 scratch (the caller's part): the gate's segment sums, a map of C
// floats a pixel (LN1(x), then g * att, then LN2(y)), t in eval, and the
// products' depth-chunk partials with colsum's buffers.
struct Scratch {
  size_t sums, ln, t, prod_part, prod_sum, total;
};

inline Scratch scratch_plan(int B, int H, int W, int C) {
  const int npix = B * H * W;
  Scratch sc;
  ScratchPlan plan;
  sc.sums = plan.take((size_t)B * H * num_segments(W) * C);
  sc.ln = plan.take((size_t)npix * C);
  sc.t = plan.take((size_t)npix * 2 * C);
  size_t part = 0, sum = 0;
  const int prods[2][2] = {{C, 2 * C}, {C, C}};  // (depth, N): W1 and W4, W3 and W5
  for (const auto& pr : prods) product_floats(npix, pr[0], pr[1], &part, &sum, kForwardMinCutRows);
  sc.prod_part = plan.take(part);
  sc.prod_sum = plan.take(sum);
  sc.total = plan.off;
  return sc;
}

template <typename T>
int naf_block_fwd(const T* x, const T* n1w, const T* n1b, const T* w1, const T* b1, const T* wdw, const T* bdw,
                  const T* wsca, const T* bsca, const T* w3, const T* b3, const T* beta, const T* n2w, const T* n2b,
                  const T* w4, const T* b4, const T* w5, const T* b5, const T* gamma, T* g, float* part, float* att,
                  float* y, float* hidden, T* z, const Saved& sv, int B, int H, int W, int C, float eps,
                  cudaStream_t stream) {
  const int HW = H * W, npix = B * HW, nseg = num_segments(W);
  const Scratch sc = scratch_plan(B, H, W, C);
  float* sums = part + sc.sums;
  float* ln = part + sc.ln;
  float* t = sv.t ? sv.t : part + sc.t;
  float* ppart = part + sc.prod_part;
  float* psum = part + sc.prod_sum;
  // a map (npix rows) or an (out, C) weight, read k-major
  auto kmaj = [npix, C](const auto* ptr, int n = -1, int pair = 0) {
    return tc::operand<true>(ptr, C, n < 0 ? npix : n, pair);
  };
  const int cut = kForwardMinCutRows;
  cudaError_t err;
#define CHECK(...) \
  if ((err = (__VA_ARGS__)) != cudaSuccess) return err;
  // the spatial half
  CHECK(ln_fwd<1>(x, n1w, n1b, ln, npix, C, eps, 1, stream));
  CHECK(product_epi<1>(kmaj(ln), kmaj(w1, 2 * C), C, ExpandEpi<T>{b1, t, 2 * C}, ppart, psum, stream, cut));
  CHECK(naf_gate<1>(t, wdw, bdw, g, sums, B, H, W, C, stream));
  naf_sca_kernel<T><<<dim3(C / kScaC, B), kThreads, (C + kThreads) * (int)sizeof(float), stream>>>(
      sums, H * nseg, wsca, bsca, att, sv.pooled, C, (float)HW);
  CHECK(cudaGetLastError());
  const long long total = (long long)npix * C;
  naf_scale_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(g, att, ln, HW, C, total);
  CHECK(cudaGetLastError());
  CHECK(product_epi<1>(kmaj(ln), kmaj(w3, C), C, SpatialEpi<T>{x, b3, beta, y, sv.u, C}, ppart, psum, stream, cut));
  // the FFN half
  CHECK(ln_fwd<1>(y, n2w, n2b, ln, npix, C, eps, 1, stream));
  // W4's rows read with each gate pair side by side (2j <- j, 2j + 1 <- C + j)
  CHECK(product_epi<1>(kmaj(ln), kmaj(w4, 2 * C, C), C, GateEpi<T>{b4, hidden, sv.h, C}, ppart, psum, stream, cut));
  return product_epi<1>(kmaj(hidden), kmaj(w5, C), C, OutEpi<T, float>{y, b5, gamma, z, sv.o, C}, ppart, psum, stream, cut);
#undef CHECK
}

template <typename T>
int naf_block_entry(const void* x, const void* n1w, const void* n1b, const void* w1, const void* b1, const void* wdw,
                    const void* bdw, const void* wsca, const void* bsca, const void* w3, const void* b3,
                    const void* beta, const void* n2w, const void* n2b, const void* w4, const void* b4,
                    const void* w5, const void* b5, const void* gamma, void* g, void* part, void* att, void* y,
                    void* hidden, void* z, const Saved& sv, int B, int H, int W, int C, float eps, void* stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  return naf_block_fwd<T>(p(x), p(n1w), p(n1b), p(w1), p(b1), p(wdw), p(bdw), p(wsca), p(bsca), p(w3), p(b3),
                          p(beta), p(n2w), p(n2b), p(w4), p(b4), p(w5), p(b5), p(gamma), static_cast<T*>(g),
                          static_cast<float*>(part), static_cast<float*>(att), static_cast<float*>(y),
                          static_cast<float*>(hidden), static_cast<T*>(z), sv, B, H, W, C, eps,
                          static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer; g (B, H, W, C) in the I/O type, part (naf_block_scratch_floats),
// att (B, C), y and hidden (B, H, W, C) in fp32 are scratch the caller
// allocates.  The residuals of a differentiated call, all fp32 and each null
// in eval, are pooled (B, C), t (B, H, W, 2C), u (B, H, W, C), h (B, H, W, 2C)
// and o (B, H, W, C).  Returns the first CUDA error, or 0.
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

extern "C" int naf_block_fwd_f32(NAF_BLOCK_ARGS) { return naf_block_entry<float>(NAF_BLOCK_PASS); }
extern "C" int naf_block_fwd_bf16(NAF_BLOCK_ARGS) { return naf_block_entry<__nv_bfloat16>(NAF_BLOCK_PASS); }

// Floats of the fp32 scratch part, so the caller can size it.
extern "C" long long naf_block_scratch_floats(int B, int H, int W, int C) {
  return (long long)scratch_plan(B, H, W, C).total;
}
