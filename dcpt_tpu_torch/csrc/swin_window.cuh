// One SwinIR window in one block of 256 threads: the body shared by K8 (the
// whole Swin block, csrc/swin_block.cu) and K10 (the window attention,
// csrc/window_attention.cu).  Every product runs on the tensor cores
// (mma.sync m16n8k8 TF32, csrc/ptx.cuh) with fp32 sums; fp32 or bf16 I/O.
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
// The instruction is mma.sync m16n8k8, not wgmma: its 16 x 8 x 8 fragments
// take the ragged widths zero-padded to 8 from plain row-major shared memory,
// and one warp's MMA is emulated on the CPU (tools/cuda_emu).  wgmma's 64-row
// tile would fit a window's 64 tokens, but it reads B (and A, unless from
// registers) in its core-matrix or swizzled K-major layouts, and 3xTF32 then
// needs both halves of each weight chunk staged in shared memory, which the
// 227 KB beside the window's maps do not hold at C = 180.
//
// fp32 accuracy from TF32 products ("3xTF32"): an fp32 operand a is split into
// a TF32 high part a_hi = tf32(a) and the rest a_lo = tf32(a - a_hi), and
// a . b = a_lo . b_hi + a_hi . b_lo + a_hi . b_hi to about 2^-21 of |a| |b|
// (the dropped a_lo . b_lo is smaller still).  A bf16 weight is exact in TF32,
// so with bf16 I/O the weight products take two MMAs: a_lo . b + a_hi . b.
// The per-head products q k^T and attn . v have fp32 operands in both and
// take three.
//
// A window's maps stay in shared memory from the load to the store, token
// major (element (token p, channel c) at p * ld + c), the reduction axis
// contiguous.  MMA fragments are read in 8-byte pairs: within each 8-deep step
// a thread's two depth slots t and t + 4 are taken as the adjacent columns 2t
// and 2t + 1, the same for both operands, so the sum is the same.  Every row
// stride is 8 (mod 16) floats, so that a half-warp's pairs (4 rows x 4 pairs)
// hit 32 distinct banks:
//   sA  x (without LN1) or LN1(x); then y = x + attn, and y + the MLP's chunks
//   sO  x (before LN1); then the heads' outputs; then LN2(y)
//   sR  q, k (token major) and v^T (channel major) of a pass of two heads;
//       then a chunk of up to 192 columns of the MLP's hidden map
//   ring  four 192 x 16 weight chunks, in the I/O type, filled by cp.async
//       three chunks ahead of the MMAs
// At C = 180 (SwinIR) the block takes 227,584 bytes: one block an SM.  Two
// would need half of that: bf16 maps, or a window split over a cluster of two.
//
// Each weight product is win_mma: the window's 64 tokens times up to 192
// output columns, eight warps as 2 (tokens) x 4 (columns), each holding 32 x
// 48 of fp32 sums in registers.  The weights, which all windows share, stream
// from the L2 through the ring in 16-deep chunks of 16-byte (fp32) or 8-byte
// (bf16) cp.async copies, zero-filled beyond the weight's rows and depth, so
// ragged widths (head 30, C 180, hidden 360) need no masks in the MMA loop.
// The attention of a pass runs two heads at once, four warps a head and 16
// query rows a warp: the scores, the softmax and the probabilities stay in
// the warp's registers (a score fragment is the next product's A fragment
// under the pairing above), the row maximum and sum combine over the four
// lanes of a row by shuffles.  Every sum runs in a fixed order and there are
// no atomics, so two runs give the same bits.
#pragma once

#include "common.cuh"
#include "mma_frag.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTok = 64;             // tokens a block holds: ws * ws <= kTok
constexpr int kWinThreads = 256;     // threads a block: warps as (kWinThreads / 128) x 4 over a product
constexpr int kMT = kTok / 16 / (kWinThreads / 128);  // 16-row tiles a warp holds in a weight product
constexpr int kNT = 6;               // 8-column tiles a warp holds in a weight product
constexpr int kBN = 4 * kNT * 8;     // columns a weight product computes in one pass: 192
constexpr int kKC = 16;              // depth of a weight chunk
constexpr int kWLD = kKC + 8;        // row stride of a weight chunk, in elements
constexpr int kStages = 4;           // weight chunks in the ring: three in flight while one is read
constexpr int kHid = kBN + 8;        // row stride of a hidden chunk of up to kBN columns
constexpr int kRowUnits = kKC / 4;   // 4-element copy units a weight row has in a chunk
constexpr int kChunkUnits = kBN * kRowUnits;                                // units a chunk has
constexpr int kStageUnits = (kChunkUnits + kWinThreads - 1) / kWinThreads;  // units a thread copies a chunk
constexpr int kLnLanes = kWinThreads / kTok;                                // lanes a token in a LayerNorm

__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
// the row stride of a token-major map of n columns: padded to 8, and 8 (mod 16)
__host__ __device__ constexpr int ld_of(int n) { return pad8(n) % 16 ? pad8(n) : pad8(n) + 8; }

struct WinLayout {
  int hd, hdp, group, ldc, ldq;  // head width and its padding; heads a pass; row strides of C and hdp columns
  __host__ __device__ WinLayout(int C, int heads)
      : hd(C / heads), hdp(pad8(C / heads)), group(heads > 1 && 6 * pad8(C / heads) <= kBN ? 2 : 1),
        ldc(ld_of(C)), ldq(ld_of(pad8(C / heads))) {}
  // floats of one head's q and k (64 x hdp) and v^T (hdp x 64)
  __host__ __device__ int head_floats() const { return 2 * kTok * ldq + hdp * ld_of(kTok); }
  __host__ __device__ int region() const {
    return group * head_floats() > kTok * kHid ? group * head_floats() : kTok * kHid;
  }
  // floats of dynamic shared memory a block takes (ops/window_attention.py::smem_bytes / 4)
  __host__ __device__ int floats() const { return 2 * kTok * ldc + region() + kStages * kBN * kWLD + kTok; }
};

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  float2 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<float2*>(p) = v;
}

// This thread's place in the fragments of a weight product: warp 4 wm + wn
// holds rows 16 (kMT wm + mi) + {g, g + 8} and columns 8 (kNT wn + j) + 2t + {0, 1}.
struct Frag {
  int g, t, wm, wn;
  __device__ Frag() : g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3), wm(threadIdx.x >> 7), wn((threadIdx.x >> 5) & 3) {}
  __device__ int row(int mi) const { return 16 * (kMT * wm + mi) + g; }
};
typedef float WinAcc[kMT][kNT][4];

// The weight rows this thread copies into every chunk of a product: row n of
// W at wrow(n) (depth K), or nullptr for a row of zeros, rows n < rows (and
// zeros up to pad8(rows)); `base` any address of the weight, what a
// zero-filling copy names.  vec: every row starts 4-element aligned and
// K % 4 == 0, so each 4-element unit is one cp.async (16 bytes of fp32, 8 of
// bf16); otherwise plain loads.  The row pointers are found once a product.
template <typename T>
struct WinStream {
  const T* row[kStageUnits];
  int dst[kStageUnits], kk[kStageUnits];
  const T* base;
  int K, kp;
  bool vec;
  template <typename WRow>
  __device__ __forceinline__ WinStream(int K_, int rows, WRow wrow, const T* base_, bool vec_)
      : base(base_), K(K_), kp(pad8(K_)), vec(vec_) {
#pragma unroll
    for (int i = 0; i < kStageUnits; ++i) {
      const int u = threadIdx.x + i * kWinThreads, n = u / kRowUnits;
      kk[i] = 4 * (u % kRowUnits);
      dst[i] = u < kChunkUnits && n < pad8(rows) ? n * kWLD + kk[i] : -1;
      row[i] = n < rows ? wrow(n) : nullptr;
    }
  }
  // chunk [k0, k0 + kKC) into the ring stage at dst (row n at n * kWLD), depth pad8(K)
  __device__ __forceinline__ void stage(T* ring_stage, int k0) const {
#pragma unroll
    for (int i = 0; i < kStageUnits; ++i) {
      const int k = k0 + kk[i];
      if (dst[i] < 0 || k >= kp) continue;
      T* d = ring_stage + dst[i];
      if (vec) {
        const bool live = row[i] != nullptr && k < K;
        cp_async<4 * sizeof(T)>(d, live ? row[i] + k : base, live ? 4 * (int)sizeof(T) : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = row[i] != nullptr && k + e < K ? row[i][k + e] : st<T>(0.f);
      }
    }
  }
};

// acc[mi][j] += a[mi] . b[j] over the warp's live tiles
__device__ __forceinline__ void win_pass(WinAcc& acc, const float (&a)[kMT][4], const float (&b)[kNT][2], int rows,
                                         int ntok, const Frag& f) {
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      if (8 * (kNT * f.wn + j) < rows && 16 * (kMT * f.wm + mi) < ntok) mma_tf32(acc[mi][j], a[mi], b[j]);
}

// acc = A . W^T on the tensor cores: A(p, k) = sA[p * lda + k] in fp32 (columns
// [K, pad8(K)) zero, every row finite), W as WinStream takes it.  Column
// tiles at or beyond `rows` and token tiles at or beyond ntok are skipped
// (their sums stay zero).  The weights stream through the ring kStages - 1
// chunks ahead of the MMAs, one barrier a chunk: chunk c + kStages - 1 is
// copied into the stage chunk c - 1 used once every thread has passed chunk
// c's barrier.  The first barrier comes before any read of A (so the caller's
// writes of A are seen) and a last one after every read (so the caller may
// write what the product read, and the next product may fill the ring).
template <typename T, typename WRow>
__device__ __forceinline__ void win_mma(const float* sA, int lda, int K, int rows, int ntok, WRow wrow,
                                        const T* base, bool vec, T* ring, WinAcc& acc) {
  const Frag f;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const WinStream<T> stream(K, rows, wrow, base, vec);
  const int kp = stream.kp, chunks = (kp + kKC - 1) / kKC;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) stream.stage(ring + c * kBN * kWLD, c * kKC);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < chunks) stream.stage(ring + (next % kStages) * kBN * kWLD, next * kKC);
    cp_async_commit();
    const T* w = ring + (c % kStages) * kBN * kWLD;
    const int steps = min(kKC, kp - c * kKC) / 8;
    for (int s = 0; s < steps; ++s) {
      const int ka = c * kKC + 8 * s + 2 * f.t;
      float ahi[kMT][4], alo[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int r = f.row(mi);
        const float2 u = ld2(sA + r * lda + ka), v = ld2(sA + (r + 8) * lda + ka);
        split(u.x, ahi[mi][0], alo[mi][0]);
        split(v.x, ahi[mi][1], alo[mi][1]);
        split(u.y, ahi[mi][2], alo[mi][2]);
        split(v.y, ahi[mi][3], alo[mi][3]);
      }
      float bhi[kNT][2], blo[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float2 bw = ld2(w + (8 * (kNT * f.wn + j) + f.g) * kWLD + 8 * s + 2 * f.t);
        if (sizeof(T) == sizeof(float)) {
          split(bw.x, bhi[j][0], blo[j][0]);
          split(bw.y, bhi[j][1], blo[j][1]);
        } else {  // a bf16 weight is a TF32 value
          bhi[j][0] = bw.x;
          bhi[j][1] = bw.y;
        }
      }
      // the small terms first, each pass over all the warp's tiles, so that
      // consecutive MMAs are independent
      if (sizeof(T) == sizeof(float)) win_pass(acc, alo, bhi, rows, ntok, f);
      win_pass(acc, sizeof(T) == sizeof(float) ? ahi : alo, sizeof(T) == sizeof(float) ? blo : bhi, rows, ntok, f);
      win_pass(acc, ahi, bhi, rows, ntok, f);
    }
  }
  __syncthreads();
}

// For each pair of columns (n, n + 1) this thread holds in the column tiles
// below `rows`: ctx = col(n), all of them first (their loads issue together),
// then fn(ctx, p, v0, v1) at each of its token rows p < ntok.
template <typename Col, typename F>
__device__ __forceinline__ void win_each(const WinAcc& acc, int rows, int ntok, Col col, F fn) {
  const Frag f;
  decltype(col(0)) ctx[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    if (8 * (kNT * f.wn + j) < rows) ctx[j] = col(8 * (kNT * f.wn + j) + 2 * f.t);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (8 * (kNT * f.wn + j) >= rows) continue;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int p = f.row(mi);
      if (p < ntok) fn(ctx[j], p, acc[mi][j][0], acc[mi][j][1]);
      if (p + 8 < ntok) fn(ctx[j], p + 8, acc[mi][j][2], acc[mi][j][3]);
    }
  }
}

// An epilogue's view of a column pair (n, n + 1): where its values go, an
// index (which of q, k and v in the qkv product, the column in the others),
// and the biases (zero for a column beyond the width).
struct WinCol {
  float* dst;
  int idx;
  float b0, b1;
};

// LayerNorm over the C channels of each of the kTok token rows of src into dst
// (row stride ldc both), dst's columns [C, ldc) zero: kLnLanes lanes a token
// sum every kLnLanes-th channel and combine by shuffles, each lane ending with
// the same bits (two passes, biased variance).
template <typename T>
__device__ __forceinline__ void win_layer_norm(const float* src, float* dst, int C, int ldc, const T* w, const T* b,
                                               float eps) {
  const int q = threadIdx.x % kLnLanes;
  const float* row = src + threadIdx.x / kLnLanes * ldc;
  float s = 0.f;
  for (int c = q; c < C; c += kLnLanes) s += row[c];
#pragma unroll
  for (int m = 1; m < kLnLanes; m *= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
  const float mu = s / C;
  float v = 0.f;
  for (int c = q; c < C; c += kLnLanes) {
    const float d = row[c] - mu;
    v += d * d;
  }
#pragma unroll
  for (int m = 1; m < kLnLanes; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  const float rs = 1.f / sqrtf(v / C + eps);
  float* out = dst + threadIdx.x / kLnLanes * ldc;
  for (int c = q; c < ldc; c += kLnLanes) out[c] = c < C ? (row[c] - mu) * rs * ld(w[c]) + ld(b[c]) : 0.f;
}

// The attention of heads h0 and h0 + 1 (those below `heads`) from their q, k
// and v^T in sR: warp w takes head h0 + w / 4 and query rows 16 (w % 4) + [0,
// 16), keys p < ntok, and writes the head's hd output columns into sO.
__device__ __forceinline__ void win_attention(const float* sR, float* sO, const WinLayout& L, int h0, int heads,
                                              int ntok) {
  const Frag f;
  const int hp = threadIdx.x >> 7, r0 = 16 * ((threadIdx.x >> 5) & 3);  // warps from 8 on wait
  if (hp >= L.group || h0 + hp >= heads || r0 >= ntok) return;  // the same for the whole warp
  const float* sq = sR + hp * L.head_floats();
  const float* sk = sq + kTok * L.ldq;
  const float* svt = sk + kTok * L.ldq;
  constexpr int kLdv = ld_of(kTok);
  const int dt = L.hdp / 8;
  // scores: s[j] holds rows r0 + g (s[j][0], [1]) and r0 + g + 8 ([2], [3]) at keys 8j + 2t + {0, 1}
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int ks = 0; ks < dt; ++ks) {
    const int kd = 8 * ks + 2 * f.t;
    float ahi[4], alo[4];
    const float2 u = ld2(sq + (r0 + f.g) * L.ldq + kd), v = ld2(sq + (r0 + f.g + 8) * L.ldq + kd);
    split(u.x, ahi[0], alo[0]);
    split(v.x, ahi[1], alo[1]);
    split(u.y, ahi[2], alo[2]);
    split(v.y, ahi[3], alo[3]);
    float bhi[8][2], blo[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bk = ld2(sk + (8 * j + f.g) * L.ldq + kd);
      split(bk.x, bhi[j][0], blo[j][0]);
      split(bk.y, bhi[j][1], blo[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < ntok) mma_tf32(s[j], alo, bhi[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < ntok) mma_tf32(s[j], ahi, blo[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < ntok) mma_tf32(s[j], ahi, bhi[j]);
  }
  // softmax over the keys below ntok, the row maximum subtracted
  float inv0, inv1;
  softmax_frags(s, ntok, inv0, inv1);
  // out = attn . v: the probabilities of key tile j are the A fragment of depth step j
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * j >= ntok) continue;
    float ahi[4], alo[4];
    split(s[j][0] * inv0, ahi[0], alo[0]);
    split(s[j][2] * inv1, ahi[1], alo[1]);
    split(s[j][1] * inv0, ahi[2], alo[2]);
    split(s[j][3] * inv1, ahi[3], alo[3]);
    float bhi[8][2], blo[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i >= dt) continue;
      const float2 bv = ld2(svt + (8 * i + f.g) * kLdv + 8 * j + 2 * f.t);
      split(bv.x, bhi[i][0], blo[i][0]);
      split(bv.y, bhi[i][1], blo[i][1]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < dt) mma_tf32(o[i], alo, bhi[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < dt) mma_tf32(o[i], ahi, blo[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < dt) mma_tf32(o[i], ahi, bhi[i]);
  }
  float* out0 = sO + (r0 + f.g) * L.ldc + (h0 + hp) * L.hd;
  float* out1 = out0 + 8 * L.ldc;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * i + 2 * f.t + e;
      if (i < dt && d < L.hd) {
        out0[d] = o[i][e];
        out1[d] = o[i][2 + e];
      }
    }
}

// The window of block (blockIdx.x = wy * (W / ws) + wx, blockIdx.y = b).
// LN1: LayerNorm before qkv.  BLOCK: the whole Swin block into out (K8);
// otherwise out gets the attention branch alone, proj's output (K10).
// Tokens p >= N = ws * ws (windows smaller than 8 x 8) are computed on finite
// values, masked out of the softmax and never stored.
template <typename T, bool LN1, bool BLOCK>
__device__ __forceinline__ void swin_window_body(
    float* smem, const T* __restrict__ x, const T* __restrict__ ln1w, const T* __restrict__ ln1b,
    const T* __restrict__ wqkv, const T* __restrict__ bqkv, const T* __restrict__ wproj, const T* __restrict__ bproj,
    const T* __restrict__ ln2w, const T* __restrict__ ln2b, const T* __restrict__ wfc1, const T* __restrict__ bfc1,
    const T* __restrict__ wfc2, const T* __restrict__ bfc2, T* __restrict__ out, int H, int W, int C, int heads,
    int ws, int shift, int hidden, float eps) {
  const WinLayout L(C, heads);
  const int N = ws * ws, ldc = L.ldc, hd = L.hd, w3 = 3 * L.hdp, head_floats = L.head_floats();
  float* sA = smem;
  float* sO = sA + kTok * ldc;
  float* sR = sO + kTok * ldc;
  T* ring = reinterpret_cast<T*>(sR + L.region());
  int* sPix = reinterpret_cast<int*>(sR + L.region() + kStages * kBN * kWLD);
  const int nwx = W / ws, wy = blockIdx.x / nwx, wx = blockIdx.x % nwx, b = blockIdx.y;
  const bool vec_c = C % 4 == 0;  // rows of C elements start 16-byte (fp32) or 8-byte (bf16) aligned
  WinAcc acc;

  // the window's pixels, then its tokens of x in fp32, zero beyond the tokens and channels:
  // into sO for LN1 to read, else into sA with sO zeroed (proj reads its padding)
  if (threadIdx.x < N) {
    const int t = threadIdx.x;
    const int yy = (wy * ws + t / ws + shift) % H, xx = (wx * ws + t % ws + shift) % W;
    sPix[t] = (b * H + yy) * W + xx;
  }
  __syncthreads();
  float* sX = LN1 ? sO : sA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < kTok; p += kWinThreads / 32) {
    const T* src = x + (size_t)(p < N ? sPix[p] : 0) * C;
    for (int c = lane; c < ldc; c += 32) {
      sX[p * ldc + c] = p < N && c < C ? ld(src[c]) : 0.f;
      if (!LN1) sO[p * ldc + c] = 0.f;
    }
  }
  __syncthreads();
  if (LN1) win_layer_norm(sO, sA, C, ldc, ln1w, ln1b, eps);

  // attention, L.group heads a pass: q, k, v of the pass (output column n of
  // head h0 + n / w3 is part (n % w3) / hdp, channel d = n % hdp), then the heads
  const float scale = 1.f / sqrtf((float)hd);
  for (int h0 = 0; h0 < heads; h0 += L.group) {
    const int cols = min(L.group, heads - h0) * w3;
    win_mma(sA, ldc, C, cols, N,
            [&](int n) -> const T* {
              const int h = h0 + n / w3, part = (n % w3) / L.hdp, d = n % L.hdp;
              return d < hd ? wqkv + (size_t)(part * C + h * hd + d) * C : nullptr;
            },
            wqkv, vec_c, ring, acc);
    win_each(
        acc, cols, kTok,
        [&](int n) {  // d even, d + 1 < hdp: both columns in one part of one head
          const int h = h0 + n / w3, part = (n % w3) / L.hdp, d = n % L.hdp;
          const T* bias = bqkv + part * C + h * hd + d;
          float* sq = sR + (n / w3) * head_floats;
          float* dst = part == 0 ? sq + d : part == 1 ? sq + kTok * L.ldq + d : sq + 2 * kTok * L.ldq + d * ld_of(kTok);
          const float s = part == 0 ? scale : 1.f;
          return WinCol{dst, part, d < hd ? ld(bias[0]) * s : 0.f, d + 1 < hd ? ld(bias[1]) * s : 0.f};
        },
        [&](const WinCol& col, int p, float v0, float v1) {  // q = (acc + bias) scale, as acc scale + bias scale
          if (col.idx == 0) {
            st2(col.dst + p * L.ldq, fmaf(v0, scale, col.b0), fmaf(v1, scale, col.b1));
          } else if (col.idx == 1) {
            st2(col.dst + p * L.ldq, v0 + col.b0, v1 + col.b1);
          } else {
            col.dst[p] = v0 + col.b0;
            col.dst[ld_of(kTok) + p] = v1 + col.b1;
          }
        });
    __syncthreads();
    win_attention(sR, sO, L, h0, heads, N);
    // the next pass's product begins with a barrier
  }

  // proj: K10 writes it to its pixels; K8 writes y = x + attn into sA
  for (int n0 = 0; n0 < C; n0 += kBN) {
    const int nc = min(kBN, C - n0);
    win_mma(sO, ldc, C, nc, N, [&](int n) -> const T* { return wproj + (size_t)(n0 + n) * C; }, wproj, vec_c, ring,
            acc);
    win_each(
        acc, nc, BLOCK ? kTok : N,
        [&](int n) {
          const int c = n0 + n;
          return WinCol{nullptr, c, c < C ? ld(bproj[c]) : 0.f, c + 1 < C ? ld(bproj[c + 1]) : 0.f};
        },
        [&](const WinCol& col, int p, float v0, float v1) {  // col.idx: the channel
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = col.idx + e;
            if (c >= C) continue;
            const float a = (e ? v1 : v0) + (e ? col.b1 : col.b0);
            if (BLOCK)
              sA[p * ldc + c] = (p < N ? ld(x[(size_t)sPix[p] * C + c]) : 0.f) + a;
            else
              out[(size_t)sPix[p] * C + c] = st<T>(a);
          }
        });
  }
  if (!BLOCK) return;
  __syncthreads();

  // MLP: LN2(y) into sO; per chunk of up to kBN hidden channels, GELU(fc1) into
  // sR, then sA += fc2's product with the chunk, chunk by chunk
  win_layer_norm(sA, sO, C, ldc, ln2w, ln2b, eps);
  const int chunks = (hidden + kBN - 1) / kBN, hc = pad8((hidden + chunks - 1) / chunks);
  for (int j0 = 0; j0 < hidden; j0 += hc) {
    const int nh = min(hc, hidden - j0);
    win_mma(sO, ldc, C, nh, N, [&](int n) -> const T* { return wfc1 + (size_t)(j0 + n) * C; }, wfc1, vec_c, ring,
            acc);
    win_each(
        acc, nh, kTok,
        [&](int n) {
          return WinCol{sR + n, n, n < nh ? ld(bfc1[j0 + n]) : 0.f, n + 1 < nh ? ld(bfc1[j0 + n + 1]) : 0.f};
        },
        [&](const WinCol& col, int p, float v0, float v1) {  // zero beyond the chunk's nh columns
          const float a0 = v0 + col.b0, a1 = v1 + col.b1;
          col.dst[p * kHid] = col.idx < nh ? 0.5f * a0 * (1.f + erff(a0 * 0.70710678118654752f)) : 0.f;
          col.dst[p * kHid + 1] = col.idx + 1 < nh ? 0.5f * a1 * (1.f + erff(a1 * 0.70710678118654752f)) : 0.f;
        });
    for (int n0 = 0; n0 < C; n0 += kBN) {
      const int nc = min(kBN, C - n0);
      win_mma(sR, kHid, nh, nc, N, [&](int n) -> const T* { return wfc2 + (size_t)(n0 + n) * hidden + j0; }, wfc2,
              hidden % 4 == 0, ring, acc);
      win_each(
          acc, nc, kTok, [&](int n) { return WinCol{sA + n0 + n, n0 + n, 0.f, 0.f}; },
          [&](const WinCol& col, int p, float v0, float v1) {
            if (col.idx < C) col.dst[p * ldc] += v0;
            if (col.idx + 1 < C) col.dst[p * ldc + 1] += v1;
          });
    }
  }
  __syncthreads();
  for (int p = warp; p < N; p += kWinThreads / 32) {
    T* dst = out + (size_t)sPix[p] * C;
    for (int c = lane; c < C; c += 32) dst[c] = st<T>(sA[p * ldc + c] + ld(bfc2[c]));
  }
}

// Launch `kernel` over the B * (H / ws) * (W / ws) windows with the shared memory it needs.
template <typename K, typename... Args>
inline cudaError_t launch_windows(K kernel, int B, int H, int W, int C, int heads, int ws, cudaStream_t stream,
                                  Args... args) {
  const int smem = WinLayout(C, heads).floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((H / ws) * (W / ws), B), kWinThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
