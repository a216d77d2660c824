// Whole Restormer / PromptIR TransformerBlock forward on Hopper (sm_90a): fp32
// math, fp32 or bf16 I/O; the 1x1 products on the tensor cores.
//
// Replaces the TPU kernel dcpt_tpu/ops/mdta_block.py::mdta_block_fused
// (_block_pallas: _p1_kernel, the host _attn_from_stats, _p2_kernel).  It
// computes what mdta_block_ref computes on a (B, H, W, C) channels-last map
// with heads heads of ch = C / heads channels and an FFN of F channels:
//
//   pass 1  ln1    LN1(x)                                    (B, HW, C) fp32 scratch
//           qkv    t = LN1(x) . Wqkv^T                      (B, HW, 3C) fp32
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
//           ln2    LN2(y)                                    (B, HW, C) fp32 scratch
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
// flops per pixel, about 24 C^2 at F = 2.66 C, over 90 % of them in the four
// 1x1 products: operations, at every stage of the shipped nets.  Those run on
// the tensor cores through tc_gemm.cuh (token_bwd.cuh's product_epi, a
// PyTorch (out, in) weight read k-major): 96 x 96 tiles of mma.sync m16n8k8
// TF32 with fp32 sums, three MMAs a step for two fp32 operands (3xTF32, fp32
// accuracy; 495 / 3 TFLOP/s against the SIMT pipes' 67), two for an fp32 map
// and a bf16 weight.  The product stages its operands raw by cp.async, so
// each LayerNorm is written once (ln_fwd_kernel, one row a warp) and read as
// the product's A; the residual add and the cast to the I/O type are
// epilogues.  Where a product's tiles leave the card idle (C = 384 on 16 x 16
// at B = 8 is 2048 rows, 88 tiles of ffn_out for 132 SMs) it is cut along its
// depth and its chunks added in a fixed order before the epilogue
// (chunk_epi_kernel); below 1024 rows (B = 1 on the deep stages) the cut's
// extra launches would cost the host more than they save the device, so it is
// not (kForwardMinCutRows).  At F = 127, 255, 510 the rows of g and Wout are
// no multiple of 4 floats, so ffn_out stages them by 4-byte copies.  The Gram
// and av (2 C ch of the 12 C^2 multiply-adds a pixel) stay SIMT (gemm.cuh);
// the depthwise and gate passes walk image-row segments with their 3 x 3
// windows in registers (dw3x3_walk); the intermediate maps (t, qkv, o, y, u,
// g and the LayerNorms' outputs) go through device memory, mostly the 50 MB
// L2 at 128 x 128.  wgmma/TMA tiles and halo fusion are the next steps.
//
// Weights come in PyTorch's layout: every 1x1 as (out, in) row-major, the
// depthwise 3x3 as (channels, 3, 3), temperature as (heads,).

#include <algorithm>

#include "common.cuh"
#include "gemm.cuh"
#include "tc_gemm.cuh"
#include "token_bwd.cuh"

namespace {

constexpr int kChunk = 128;  // pixels of one Gram partial

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

constexpr int kRowC = 32;  // dw, gate: channels of a block (a warp's lanes)
constexpr int kSeg = 32;   // dw, gate: pixels of an image row a thread walks

__host__ __device__ inline int num_segments(int W) { return (W + kSeg - 1) / kSeg; }

// The dw and gate passes' grid over D channels: blocks of kRowC channels x
// kThreads / kRowC (image row, segment) pairs, and B.
inline dim3 walk_grid(int B, int H, int W, int D) {
  constexpr int pairs = kThreads / kRowC;
  return dim3((H * num_segments(W) + pairs - 1) / pairs, (D + kRowC - 1) / kRowC, B);
}

// qkv = depthwise 3x3 of t, all D = 3C channels: one thread a channel walks
// kSeg pixels of an image row (dw3x3_walk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_dw_kernel(const float* __restrict__ t, const T* __restrict__ wdw, float* __restrict__ out, int H, int W, int D) {
  const int c = blockIdx.y * kRowC + threadIdx.x % kRowC, nseg = num_segments(W);
  const int rs = blockIdx.x * (kThreads / kRowC) + threadIdx.x / kRowC;
  if (c >= D || rs >= H * nseg) return;
  const int y = rs / nseg, x0 = (rs % nseg) * kSeg;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int ch[1] = {c};
  const float zero[1] = {0.f};
  dw3x3_walk<1>(t, wdw, ch, zero, img, y, x0, min(W, x0 + kSeg), H, W, D, [&](int x, const float (&s)[1]) {
    out[(img + (size_t)y * W + x) * D + c] = s[0];
  });
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
  const int tiles = (ch + kNB - 1) / kNB;
  const int h = blockIdx.y / (tiles * tiles), tile = blockIdx.y % (tiles * tiles);
  const int c0 = (tile / tiles) * kNB, d0 = (tile % tiles) * kNB;
  const int b = blockIdx.z, p0 = blockIdx.x * kChunk, np = min(kChunk, HW - p0);
  const float* base = qkv + ((size_t)b * HW + p0) * 3 * C;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4], nq, nk;
  head_tile_product<true>(smem, base + h * ch + c0, 3 * C, base + C + h * ch + d0, 3 * C, np, ch - c0, ch - d0, acc,
                          nq, nk);
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

// g = gelu(dw(u)[j]) * dw(u)[F + j], exact-erf GELU as F.gelu: one thread a
// channel j walks kSeg pixels of an image row (dw3x3_walk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_gate_kernel(const float* __restrict__ u, const T* __restrict__ wdw, float* __restrict__ g, int H, int W, int F) {
  const int j = blockIdx.y * kRowC + threadIdx.x % kRowC, nseg = num_segments(W);
  const int rs = blockIdx.x * (kThreads / kRowC) + threadIdx.x / kRowC;
  if (j >= F || rs >= H * nseg) return;
  const int y = rs / nseg, x0 = (rs % nseg) * kSeg;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int ch[2] = {j, F + j};
  const float zero[2] = {0.f, 0.f};
  dw3x3_walk<2>(u, wdw, ch, zero, img, y, x0, min(W, x0 + kSeg), H, W, 2 * F, [&](int x, const float (&s)[2]) {
    g[(img + (size_t)y * W + x) * F + j] = 0.5f * s[0] * (1.f + erff(s[0] * 0.70710678118654752f)) * s[1];
  });
}

struct Maps {
  float *t, *qkv, *part, *red, *attn, *o, *y, *u, *g;
};

// y = x + o . Wproj^T (fp32), x in the I/O type: proj's epilogue
template <typename T>
struct ResidualEpi {
  const T* x;
  float* y;
  int N;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    const size_t q = (size_t)r * N + n;
    const bool two = n + 1 < N;
    store_pair(y + q, ld(x[q]) + v0, two ? ld(x[q + 1]) + v1 : 0.f, two);
  }
};

// z = y + g . Wout^T, stored in the I/O type: ffn_out's epilogue
template <typename T>
struct OutEpi {
  const float* y;
  T* z;
  int N;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    const size_t q = (size_t)r * N + n;
    z[q] = st<T>(y[q] + v0);
    if (n + 1 < N) z[q + 1] = st<T>(y[q + 1] + v1);
  }
};

inline int num_chunks(int HW) { return (HW + kChunk - 1) / kChunk; }
inline size_t stats_floats(int C, int ch) { return (size_t)C * ch + 2 * (size_t)C; }
inline size_t round64(size_t floats) { return (floats + 63) / 64 * 64; }  // 256-byte aligned offsets

// The fp32 scratch (the caller's part): a LayerNorm's output (pixels, C), then
// one region that the Gram partials (with colsum's buffers) and the 1x1
// products' depth-chunk partials (with theirs) take in turn.
struct Scratch {
  size_t ln, region, prod_part, prod_sum, gram_sum, total;
};

inline Scratch scratch_plan(int B, int H, int W, int C, int F, int heads) {
  const int npix = B * H * W, chunks = num_chunks(H * W), cn = (int)stats_floats(C, C / heads);
  Scratch sc;
  sc.ln = 0;
  sc.region = round64((size_t)npix * C);
  sc.gram_sum = round64((size_t)B * chunks * cn);
  size_t part = 0, sum = 0;
  const int prods[4][2] = {{C, 3 * C}, {C, C}, {C, 2 * F}, {F, C}};  // (depth, N): qkv, proj, ffn_in, ffn_out
  for (const auto& pr : prods) product_floats(npix, pr[0], pr[1], &part, &sum, kForwardMinCutRows);
  sc.prod_part = 0;
  sc.prod_sum = round64(part);
  const size_t gram = sc.gram_sum + colsum_scratch(B, chunks, cn), prod = sc.prod_sum + sum;
  sc.total = sc.region + std::max(gram, prod);
  return sc;
}

template <typename T>
cudaError_t launch_block(const T* x, const T* n1w, const T* n1b, const T* wqkv, const T* wdwq, const T* temp,
                         const T* wproj, const T* n2w, const T* n2b, const T* win, const T* wdwf, const T* wout, T* z,
                         const Maps& m, int B, int H, int W, int C, int F, int heads, int use_softmax, int ln_bias,
                         float eps, cudaStream_t stream) {
  const int HW = H * W, npix = B * HW, ch = C / heads, tiles = (ch + kNB - 1) / kNB;
  const Scratch sc = scratch_plan(B, H, W, C, F, heads);
  float* ln = m.part + sc.ln;
  float* ppart = m.part + sc.region + sc.prod_part;
  float* psum = m.part + sc.region + sc.prod_sum;
  float* gpart = m.part + sc.region;
  // a map (npix rows) or an (out, in) weight, read k-major
  auto kmaj = [npix](const auto* ptr, int ld, int n = -1) { return tc::operand<true>(ptr, ld, n < 0 ? npix : n); };
  const int cut = kForwardMinCutRows;
  cudaError_t err;
#define CHECK(...) \
  if ((err = (__VA_ARGS__)) != cudaSuccess) return err;
  // pass 1
  CHECK(ln_fwd<6>(x, n1w, n1b, ln, npix, C, eps, ln_bias, stream));
  CHECK(product_epi<6>(kmaj(ln, C), kmaj(wqkv, C, 3 * C), C, StoreEpi{m.t, 3 * C}, ppart, psum, stream, cut));
  mdta_dw_kernel<T><<<walk_grid(B, H, W, 3 * C), kThreads, 0, stream>>>(m.t, wdwq, m.qkv, H, W, 3 * C);
  CHECK(cudaGetLastError());
  const int chunks = num_chunks(HW);
  mdta_gram_kernel<<<dim3(chunks, heads * tiles * tiles, B), kThreads, 2 * kKC * kWS * (int)sizeof(float), stream>>>(
      m.qkv, gpart, HW, C, ch);
  CHECK(cudaGetLastError());
  const int cn = (int)stats_floats(C, ch);
  CHECK(colsum<6>(gpart, B, chunks, cn, cn, m.red, m.part + sc.region + sc.gram_sum, stream));
  // between the passes
  mdta_attn_kernel<T><<<dim3((C + kThreads / 32 - 1) / (kThreads / 32), B), kThreads, 0, stream>>>(
      m.red, temp, m.attn, C, ch, use_softmax);
  CHECK(cudaGetLastError());
  // pass 2: 64-pixel tiles of av where the map has pixels enough to fill the card, 32 or 16 on the deep stages
  const int rm = npix >= 8192 ? 4 : (npix >= 2048 ? 2 : 1);
  const dim3 av_grid((HW + 16 * rm - 1) / (16 * rm), (C + kNB - 1) / kNB, B);
  const int av_smem = gemm_smem_floats(rm) * (int)sizeof(float);
  if (rm == 4)
    mdta_av_kernel<4><<<av_grid, kThreads, av_smem, stream>>>(m.qkv, m.attn, m.o, HW, C, ch);
  else if (rm == 2)
    mdta_av_kernel<2><<<av_grid, kThreads, av_smem, stream>>>(m.qkv, m.attn, m.o, HW, C, ch);
  else
    mdta_av_kernel<1><<<av_grid, kThreads, av_smem, stream>>>(m.qkv, m.attn, m.o, HW, C, ch);
  CHECK(cudaGetLastError());
  CHECK(product_epi<6>(kmaj(m.o, C), kmaj(wproj, C, C), C, ResidualEpi<T>{x, m.y, C}, ppart, psum, stream, cut));
  CHECK(ln_fwd<6>(m.y, n2w, n2b, ln, npix, C, eps, ln_bias, stream));
  CHECK(product_epi<6>(kmaj(ln, C), kmaj(win, C, 2 * F), C, StoreEpi{m.u, 2 * F}, ppart, psum, stream, cut));
  mdta_gate_kernel<T><<<walk_grid(B, H, W, F), kThreads, 0, stream>>>(m.u, wdwf, m.g, H, W, F);
  CHECK(cudaGetLastError());
  return product_epi<6>(kmaj(m.g, F), kmaj(wout, F, C), F, OutEpi<T>{m.y, z, C}, ppart, psum, stream, cut);
#undef CHECK
}

template <typename T>
int mdta_block_fwd(const void* x_, const void* n1w_, const void* n1b_, const void* wqkv_, const void* wdwq_,
                   const void* temp_, const void* wproj_, const void* n2w_, const void* n2b_, const void* win_,
                   const void* wdwf_, const void* wout_, void* z_, const Maps& m, int B, int H, int W, int C, int F,
                   int heads, int use_softmax, int ln_bias, float eps, void* stream_) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  return launch_block<T>(p(x_), p(n1w_), p(n1b_), p(wqkv_), p(wdwq_), p(temp_), p(wproj_), p(n2w_), p(n2b_),
                         p(win_), p(wdwf_), p(wout_), static_cast<T*>(z_), m, B, H, W, C, F, heads, use_softmax,
                         ln_bias, eps, static_cast<cudaStream_t>(stream_));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer.  Inputs: x (B, H, W, C) and the weights in the I/O type (norm
// weights and biases (C,), Wqkv (3C, C), Wdwq (3C, 3, 3), temperature (heads,),
// Wproj (C, C), Win (2F, C), Wdwf (2F, 3, 3), Wout (C, F)); the output z
// (B, H, W, C) in the I/O type.  fp32 scratch the caller allocates: t and qkv
// (B, H, W, 3C), part (mdta_block_scratch_floats), red (B, C * ch + 2C) — the
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

// Floats of the fp32 scratch part, so the caller can size it.
extern "C" long long mdta_block_scratch_floats(int B, int H, int W, int C, int F, int heads) {
  return (long long)scratch_plan(B, H, W, C, F, heads).total;
}
