// MDTA's transposed (channel) attention on Hopper (sm_90a): the Gram and
// attn . v on the tensor cores (mma.sync m16n8k8 TF32 through tc_gemm.cuh's
// pieces, 3xTF32 for fp32 operands, one MMA for two bf16 ones), fp32 or bf16
// I/O.
//
// Replaces the TPU kernels of dcpt_tpu/ops/mdta.py::mdta_attention: _kernel
// (pallas_call :62), and the L-tiled pair _gram_kernel (:116) and _pv_kernel
// (:138).  Per (batch * head) bh, with q, k, v (BH, c, L) channels-first
// (L contiguous) and temperature t (BH):
//
//   attn = act(q k^T * rsqrt(max(|q|^2, 1e-24)) rsqrt(max(|k|^2, 1e-24))^T * t)
//   out  = attn . v                     (attn rounded to v's dtype first)
//
// act is ReLU or a row softmax; the norms run over L, so the normalisation
// folds into the c x c Gram and no normalised copy of q or k is written.
//
// What bounds it on this card: 4 c^2 L flops per bh (the Gram and attn . v)
// against 16 c L bytes in fp32 (q, k, v read and out written once): c / 4
// flops a byte, at most 44 at the nets' head widths (40 ... 176), under the
// 49 flops a byte where 3xTF32 (a third of the 495 TFLOP/s TF32 peak) meets
// 3.35 TB/s.  So on the tensor cores every call is bound by its bytes: the
// design reads q, k and v once, writes out once, and keeps the card busy at
// BH = 1, where one block a head would leave 131 of 132 SMs idle.
//
//   gram    mdta_gram_kernel, grid (BH * chunks, tiles^2): a block computes
//           a square tile of q k^T over one chunk of the pixels, q and k both
//           read k-major from device memory (element (i, l) at q[bh c L +
//           i L + l]; neither is transposed), through a ring of cp.async
//           chunks 32 deep, each thread's copies unrolled.  The blocks of
//           column (row) tile 0 take |q_i|^2 (|k_j|^2) from the same staged
//           chunks.  The chunks cut L so that BH = 1 fills the card
//           (chunk_len: a function of BH, c and L alone).  Each 32-deep chunk
//           is summed from zero by the MMAs and added by one rounded add, as
//           tc_gemm.cuh does.  Where one chunk and one tile cover the head
//           (c <= 96, L <= 256) the block goes on to attn itself (kDirect):
//           two launches a call.  Otherwise it writes its partial Gram and
//           norms to the workspace (BH, chunks, c^2 + 2c);
//   reduce  mdta_reduce_kernel, grid (c / rows) x BH: a block sums the chunks
//           of its Gram rows, their |q|^2 and every |k|^2 in chunk order, as
//           runs of 8 consecutive chunks (every load of a run issued first,
//           16 bytes each where c % 4 == 0), then the runs in order: no
//           atomics, the same bits every run; then writes attn;
//   attn    attn_row (both ways): one warp a row; each row's and column's
//           rsqrt taken once, a softmax row's exp once per element, the
//           value rounded to v's dtype as dcpt_tpu's attn.astype(v.dtype);
//   av      mdta_av_kernel, grid (L / 128) x (c / rows) x BH: out[:, tile] =
//           attn . v[:, tile], attn (fp32 values of v's dtype) k-major from
//           the workspace, v depth-major (element (d, l) at v[bh c L + d L +
//           l]), the depth c in 32-deep chunks through the same kind of
//           ring; row tiles of 48 or 96 cover the whole head where c <= 96,
//           so each head reads v once.
//
// Each grid runs BH on its x dimension (blocks of a head adjacent), so any BH
// launches.  The block tiles come from the head width (pick_tile: the 48
// family where c <= 48, else the 96 one; c = 176, PromptIR's noise_level3, is
// 2 x 2 Gram tiles of 96 and two row tiles of attn . v); a C entry's tile
// argument forces one.  The chunks, each element's order of sums and the
// reduce's runs depend on the shape alone, and one chunk reduces to its one
// partial as it is: every tile gives the same bits.
//
// Where it departs from the TPU kernel: dcpt_tpu drops to the jnp reference
// when L % 128 != 0 and picks its single-shot or tiled kernel by VMEM size;
// every L and every head width c up to kMaxC is taken here.  The backward is
// the VJP of the plain version, as dcpt_tpu's custom VJP differentiates
// mdta_ref (ops/mdta.py).

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

// A block tile: kWM x (8 / kWM) warps that run MMAs (all 8 but for kWM = 3: 6), a warp MT x NT
// MMA tiles (16 rows, 8 columns each), a ring of STAGES chunks (STAGES - 1 in flight while one
// is read)
template <int WM, int MT, int NT, int STAGES, int MIN_BLOCKS = 2>
struct Tile {
  static constexpr int kWM = WM, kWN = 8 / WM, kMT = MT, kNT = NT, kStages = STAGES, kMinBlocks = MIN_BLOCKS;
  static constexpr int kBM = kWM * kMT * 16, kBN = kWN * kNT * 8, kMmaWarps = kWM * kWN;
  static_assert(kMmaWarps <= kThreads / 32, "8 warps at most");
};
// Two families, by the head width (pick_tile), the Gram's tile square:
//   48: Gram 48 x 48 (six warps of 16 x 24; at c = 48 a 64-wide tile spends 44 % of its MMAs
//       and fragment work on padding, and the Gram is bound by issue, not bytes), four chunks;
//       attn . v 48 rows x 128 pixels (warps 48 x 16), three blocks an SM (0.0242 -> 0.0220 ms
//       at (8, 48, 16384), PERF.md section 6);
//   96: Gram 96 x 96 (warps 48 x 24), attn . v 96 x 128 (warps 48 x 32).
// attn . v's ring of three holds a depth of up to 96 in flight at once.
using Gram48 = Tile<3, 1, 3, 4>;
using Gram96 = Tile<2, 3, 3, 3>;
using Av48 = Tile<1, 3, 2, 3, 3>;
using Av96 = Tile<2, 3, 4, 3>;

constexpr int kMinLen = 128;          // pixels of a Gram chunk at least, on a map of more than kOneChunk
constexpr int kOneChunk = 256;        // such a map is one chunk where one tile holds the head (c <= 96)
constexpr int kTargetBlocks = 2 * 132;  // Gram blocks to aim for: two an SM
constexpr int kMaxRows = 8;           // Gram rows a reduce block takes at most (a warp each)
constexpr int kSliceChunks = 8;       // chunks a reduce slice sums (its last: what is left)
constexpr int kSmemMax = 232448;      // bytes of shared memory a block may take on the H100
// Head widths taken: a reduce block of one row holds (slices + 1) (2c + 1) floats, the most at
// c = kMaxC (one slice: 131080 bytes), under kSmemMax at every BH and L
constexpr int kMaxC = 8192;

// Pixels of a Gram chunk: enough chunks to fill the card with BH heads of ceil(c / 96)^2 tiles, a
// multiple of 32, at least kMinLen on a map of more than kOneChunk pixels.  A map of at most
// kOneChunk is one chunk where c <= 96 (the Gram's block then takes attn: two launches); a wider
// head runs the reduce pass anyway, so its small map is cut too (PromptIR's (4, 176, 256): the
// Gram 0.0173 ms in one chunk, 0.0047 in eight, the same bits; PERF.md section 6).  A function
// of the shape only, whatever tile a call takes.
inline int chunk_len(int BH, int c, int L) {
  if (L <= kOneChunk && c <= 96) return L;
  const long long tiles = (long long)((c + 95) / 96) * ((c + 95) / 96) * BH;
  const int want = (int)((kTargetBlocks + tiles - 1) / tiles);
  int len = (L + want - 1) / want;
  len = (len + tc::kKC - 1) / tc::kKC * tc::kKC;
  return L > kOneChunk && len < kMinLen ? kMinLen : len;
}

inline int num_chunks(int BH, int c, int L) {
  const int len = chunk_len(BH, c, L);
  return (L + len - 1) / len;
}

// The reduce pass: the slices a block sums its chunks in, and its Gram rows: as few as keep
// about two blocks an SM (the more blocks, the more loads in flight; the fewer, the fewer times
// each block sums every |k|^2), at most kMaxRows and as many as its sums' slices fit in shared
// memory, (slices + 1) (rows c + rows + c) floats.  Neither changes any sum's order.
inline int reduce_slices(int chunks) { return (chunks + kSliceChunks - 1) / kSliceChunks; }
inline int reduce_rows(int BH, int c, int slices) {
  const long long want = ((long long)BH * c + kTargetBlocks - 1) / kTargetBlocks;
  const long long fit = ((long long)kSmemMax / (int)sizeof(float) / (slices + 1) - c) / (c + 1);
  long long r = want < kMaxRows ? want : kMaxRows;
  if (fit < r) r = fit;
  return r < 1 ? 1 : (int)r;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// tc::operand in device code: a head's operand, its pointer taken from the block index
template <bool K, typename T>
__device__ __forceinline__ tc::Operand<T, K> head_operand(const T* p, long long ld, int rows) {
  return tc::Operand<T, K>{p, ld, rows, ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0, 0};
}

// tc::stage with each thread's units unrolled (ln_proj.cu's stage_vec, for any row count R) for
// an operand of whole aligned 4-element units (op.vec): the generic loop's own instructions
// compete with the MMAs for issue slots; any other operand takes tc::stage
template <typename T, bool K, int R>
__device__ __forceinline__ void stage_unrolled(const tc::Operand<T, K>& op, T* buf, int r0, int k0, int k1) {
  if (!op.vec) return tc::stage<T, K, R>(op, buf, r0, k0, k1);
  constexpr int kUnits = R * tc::kKC / 4;
#pragma unroll
  for (int i = 0; i < (kUnits + kThreads - 1) / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads;
    if (kUnits % kThreads != 0 && u >= kUnits) break;
    int r, k, dst, n;  // the unit's first element, where it lands, its live elements
    if (K) {
      r = r0 + u / (tc::kKC / 4);
      k = k0 + 4 * (u % (tc::kKC / 4));
      dst = (u / (tc::kKC / 4)) * tc::kKLD + 4 * (u % (tc::kKC / 4));
      n = r < op.rows ? min(4, max(0, k1 - k)) : 0;
    } else {
      k = k0 + u / (R / 4);
      r = r0 + 4 * (u % (R / 4));
      dst = (u / (R / 4)) * (R + 4) + 4 * (u % (R / 4));
      n = k < k1 ? min(4, max(0, op.rows - r)) : 0;
    }
    const T* src = op.ptr + (K ? (long long)r * op.ld + k : (long long)k * op.ld + r);
    cp_async<4 * sizeof(T)>(buf + dst, n ? src : op.ptr, n * (int)sizeof(T));
  }
}

__device__ __forceinline__ float inv_norm(float n2) { return 1.f / sqrtf(fmaxf(n2, 1e-24f)); }

// Row i of attn, by one warp: g the row's c Gram values (shared memory, overwritten), rq its
// 1 / |q_i|, rk the columns' 1 / |k_j|, t the head's temperature; act(g_j rq rk_j t) rounded to
// T, written as fp32 to a.  A softmax row takes each exp once (kept in g), the sum over the
// lanes' strided partials in a fixed order.
template <typename T>
__device__ __forceinline__ void attn_row(float* g, float rq, const float* rk, float t, int c, bool softmax,
                                         float* __restrict__ a) {
  const int lane = threadIdx.x & 31;
  if (!softmax) {
    for (int j = lane; j < c; j += 32) a[j] = ld(st<T>(fmaxf(g[j] * rq * rk[j] * t, 0.f)));
    return;
  }
  float m = -INFINITY;
  for (int j = lane; j < c; j += 32) {
    const float x = g[j] * rq * rk[j] * t;
    g[j] = x;
    m = fmaxf(m, x);
  }
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < c; j += 32) {
    const float e = expf(g[j] - m);
    g[j] = e;
    s += e;
  }
  s = warp_sum(s);
  for (int j = lane; j < c; j += 32) a[j] = ld(st<T>(g[j] / s));
}

// Two adjacent values (n, n + 1) of a row; n + 1 only if two
__device__ __forceinline__ void store2(float* d, float v0, float v1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(d) & 7) == 0) {
    *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
  } else {
    d[0] = v0;
    if (two) d[1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* d, float v0, float v1, bool two) {
  d[0] = st<__nv_bfloat16>(v0);
  if (two) d[1] = st<__nv_bfloat16>(v1);
}

// acc (a warp's MT x NT fragments) += the staged chunk's first `live` depths of A (k-major rows)
// times B (rows kBN, k-major, or depth-major with row stride RLD): 3xTF32 where both are fp32, the
// small terms first; a lo part only for an operand of fp32 values (kAlo, kBlo)
template <class Tl, bool kAlo, bool kBlo, bool BK, int RLD, typename TA, typename TB>
__device__ __forceinline__ void mma_steps(float (&acc)[Tl::kMT][Tl::kNT][4], const TA* sa, const TB* sb, int live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (threadIdx.x >> 5) / Tl::kWN, wn = (threadIdx.x >> 5) % Tl::kWN;
  if ((threadIdx.x >> 5) >= Tl::kMmaWarps) return;
#pragma unroll
  for (int s = 0; s < tc::kKC / 8; ++s) {
    if (8 * s >= live) break;
    // depths k and k + 1 are the MMA's slots t and t + 4 in both operands (tc::mma_chunk)
    const int k = 8 * s + 2 * t;
    float ah[Tl::kMT][4], al[Tl::kMT][4], bh[Tl::kNT][2], bl[Tl::kNT][2];
#pragma unroll
    for (int mi = 0; mi < Tl::kMT; ++mi) {
      const int r = (wm * Tl::kMT + mi) * 16 + g;
      const float2 u = tc::pair<true>(sa, r, k), v = tc::pair<true>(sa, r + 8, k);
      split<kAlo>(u.x, ah[mi][0], al[mi][0]);
      split<kAlo>(v.x, ah[mi][1], al[mi][1]);
      split<kAlo>(u.y, ah[mi][2], al[mi][2]);
      split<kAlo>(v.y, ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int nj = 0; nj < Tl::kNT; ++nj) {
      const float2 u = tc::pair<BK, RLD>(sb, (wn * Tl::kNT + nj) * 8 + g, k);
      split<kBlo>(u.x, bh[nj][0], bl[nj][0]);
      split<kBlo>(u.y, bh[nj][1], bl[nj][1]);
    }
    if (kAlo) tc::mma_term(acc, al, bh);
    if (kBlo) tc::mma_term(acc, ah, bl);
    tc::mma_term(acc, ah, bh);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&a)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[mi][nj][e] = 0.f;
}

template <int MT, int NT>
__device__ __forceinline__ void add_to(float (&acc)[MT][NT][4], const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
}

template <class Tl>
constexpr int gram_smem_floats() {
  return Tl::kStages * (Tl::kBM + Tl::kBN) * tc::kKLD;
}

// The Gram tile blockIdx.y (column tiles fastest) of head blockIdx.x / chunks over its chunk of
// pixels, and the chunk's |q_i|^2 (the blocks of column tile 0) and |k_j|^2 (of row tile 0),
// each 32-deep chunk summed from zero by a row's own thread in
// an order rotated by (row / 4) % 4 pairs, so a half-warp's 8-byte loads of the k-major chunk
// (rows kKLD = 8 (mod 32) floats apart) hit distinct banks; the tiles start at multiples of 16
// rows, so the order is the row's own in every tile.  kDirect (one chunk, one tile): the block
// goes on to attn; otherwise it writes its partials to part (BH, chunks, c^2 + 2c).
template <class Tl, typename T, bool kDirect>
__global__ void __launch_bounds__(kThreads, Tl::kMinBlocks)
mdta_gram_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ temp,
                 float* __restrict__ part, float* __restrict__ attn, int c, int L, int chunks, int len,
                 int use_softmax) {
  static_assert(Tl::kBM == Tl::kBN && Tl::kBM <= 128, "square tiles; the norms' threads in two halves");
  constexpr int MT = Tl::kMT, NT = Tl::kNT, kStage = (Tl::kBM + Tl::kBN) * tc::kKLD;
  constexpr bool kLo = sizeof(T) == sizeof(float);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, bh = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int ntiles = (c + Tl::kBN - 1) / Tl::kBN, ti = blockIdx.y / ntiles, tj = blockIdx.y % ntiles;
  const int r0 = ti * Tl::kBM, n0 = tj * Tl::kBN;
  const int l0 = chunk * len, l1 = min(L, l0 + len), steps = (l1 - l0 + tc::kKC - 1) / tc::kKC;
  const auto a = head_operand<true>(q + (size_t)bh * c * L, L, c);
  const auto b = head_operand<true>(k + (size_t)bh * c * L, L, c);
  auto sa = [&](int s) { return reinterpret_cast<T*>(smem + (s % Tl::kStages) * kStage); };
  auto sb = [&](int s) { return reinterpret_cast<T*>(smem + (s % Tl::kStages) * kStage + Tl::kBM * tc::kKLD); };
  auto fill = [&](int s) {
    if (s < steps) {
      const int k0 = l0 + s * tc::kKC, k1 = min(l1, k0 + tc::kKC);
      stage_unrolled<T, true, Tl::kBM>(a, sa(s), r0, k0, k1);
      stage_unrolled<T, true, Tl::kBN>(b, sb(s), n0, k0, k1);
    }
    cp_async_commit();
  };
  // the norms' threads: those of the warps that run no MMA where a tile leaves some (Gram48: warps
  // 6 and 7, on two of the SM's four schedulers that hold one MMA warp each), a row or two each;
  // else threads [0, kBM) and [128, 128 + kBN)
  constexpr int kFree = kThreads - 32 * Tl::kMmaWarps;
  constexpr int kNormRows = kFree ? (Tl::kBM + Tl::kBN + kFree - 1) / kFree : 1;
  static_assert(kFree == 0 || kNormRows <= 2, "a norm thread takes at most two rows");
  float nsum[2] = {0.f, 0.f};
  auto norm_row = [&](int j, bool& is_q, int& nr) {  // the thread's j-th row: of q (its row in the tile) or k
    const int f = kFree ? tid - 32 * Tl::kMmaWarps + j * kFree : (tid < 128 ? tid : Tl::kBM + tid - 128);
    is_q = f < Tl::kBM;
    nr = is_q ? f : f - Tl::kBM;
    const bool live = kFree ? tid >= 32 * Tl::kMmaWarps && f < Tl::kBM + Tl::kBN
                            : (tid < 128 ? tid < Tl::kBM : tid - 128 < Tl::kBN) && j == 0;
    return live && (is_q ? tj == 0 : ti == 0);
  };
  float acc[MT][NT][4], prt[MT][NT][4];  // the sum so far, and the chunk's
  zero(acc);
  for (int s = 0; s < Tl::kStages - 1; ++s) fill(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<Tl::kStages - 2>();
    __syncthreads();  // chunk s is in; every thread is done with chunk s - 1, whose stage fill takes next
    fill(s + Tl::kStages - 1);
#pragma unroll
    for (int j = 0; j < kNormRows; ++j) {
      bool is_q;
      int nr;
      if (!norm_row(j, is_q, nr)) continue;
      const T* row = is_q ? sa(s) : sb(s);
      const int rot = 2 * ((nr >> 2) & 3);
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < tc::kKC / 2; ++e) {
        const float2 u = tc::pair<true>(row, nr, (2 * e + rot) & (tc::kKC - 1));
        p = fmaf(u.x, u.x, p);
        p = fmaf(u.y, u.y, p);
      }
      nsum[j] += p;
    }
    zero(prt);
    mma_steps<Tl, kLo, kLo, true, tc::kRLD>(prt, sa(s), sb(s), l1 - l0 - s * tc::kKC);
    add_to(acc, prt);
  }
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = (tid >> 5) / Tl::kWN, wn = (tid >> 5) % Tl::kWN;
  const size_t cn = (size_t)c * c + 2 * c;
  float* out = kDirect ? smem : part + ((size_t)bh * chunks + chunk) * cn;
  if (kDirect) {
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring: the Gram and norms take its place
  }
  const bool mma_warp = (tid >> 5) < Tl::kMmaWarps;
#pragma unroll
  for (int mi = 0; mi < MT && mma_warp; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      const int r = r0 + (wm * MT + mi) * 16 + g, n = n0 + (wn * NT + nj) * 8 + 2 * t;
      if (n >= c) continue;
      if (r < c) store2(out + (size_t)r * c + n, acc[mi][nj][0], acc[mi][nj][1], n + 1 < c);
      if (r + 8 < c) store2(out + (size_t)(r + 8) * c + n, acc[mi][nj][2], acc[mi][nj][3], n + 1 < c);
    }
  float* rq = smem + c * c;  // kDirect: 1 / |q_i|, then 1 / |k_j|
  float* rk = rq + c;
#pragma unroll
  for (int j = 0; j < kNormRows; ++j) {
    bool is_q;
    int nr;
    if (!norm_row(j, is_q, nr) || (is_q ? r0 : n0) + nr >= c) continue;
    if (kDirect)
      (is_q ? rq : rk)[nr] = inv_norm(nsum[j]);
    else
      out[(size_t)c * c + (is_q ? r0 + nr : c + n0 + nr)] = nsum[j];
  }
  if (!kDirect) return;
  __syncthreads();
  const float tv = ld(temp[bh]);
  for (int i = tid >> 5; i < c; i += kThreads / 32)
    attn_row<T>(smem + (size_t)i * c, rq[i], rk, tv, c, use_softmax, attn + ((size_t)bh * c + i) * c);
}

// V consecutive floats at p, as fp32
template <int V>
__device__ __forceinline__ void ldv(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

// dst[0, V) = the sums over chunks [c0, c1) (at most kSliceChunks) of the V floats at p + off of
// each (chunks cn apart), in chunk order; every load issued before the first add (a run of a
// length known only at run time compiles to a loop of one load round trip a chunk)
template <int V>
__device__ __forceinline__ void chunk_run(const float* __restrict__ p, size_t cn, size_t off, int c0, int c1,
                                          float* dst) {
  float x[kSliceChunks][V];
#pragma unroll
  for (int j = 0; j < kSliceChunks; ++j)
    if (c0 + j < c1) ldv<V>(p + (size_t)(c0 + j) * cn + off, x[j]);
#pragma unroll
  for (int j = 1; j < kSliceChunks; ++j)
    if (c0 + j < c1)
#pragma unroll
      for (int e = 0; e < V; ++e) x[0][e] += x[j][e];
#pragma unroll
  for (int e = 0; e < V; ++e) dst[e] = x[0][e];
}

// attn's rows [(blockIdx.x % blocks) rows, + rows) of head blockIdx.x / blocks from the chunks'
// partials (blocks = ceil(c / rows): a head's blocks adjacent).  The
// block's sums (its rows' Gram, their |q|^2, every |k|^2) are taken over `slices` runs of
// consecutive chunks, a thread a run of V sums (V = 4: 16-byte loads where c % 4 == 0), then
// the runs are added in order: each sum over the chunks in a fixed order, no atomics.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
mdta_reduce_kernel(const float* __restrict__ part, const T* __restrict__ temp, float* __restrict__ attn, int c,
                   int chunks, int rows, int slices, int use_softmax) {
  extern __shared__ __align__(16) float smem[];
  const int blocks = (c + rows - 1) / rows, bh = blockIdx.x / blocks, i0 = blockIdx.x % blocks * rows;
  const int tid = threadIdx.x, nr = min(rows, c - i0);
  const int n = nr * c + nr + c;  // this block's sums: its rows' Gram, their |q|^2, every |k|^2
  const int ug = nr * c / V, uk = c / V, units = ug + nr + uk;  // runs of V (the |q|^2 one at a time)
  const size_t cn = (size_t)c * c + 2 * c;
  const float* p = part + (size_t)bh * chunks * cn;
  float* sl = smem;  // slices x n
  float* sg = sl + (size_t)slices * n;  // the sums: Gram rows, then 1 / |q|, then 1 / |k|
  float* rq = sg + nr * c;
  float* rk = rq + nr;
  for (int it = tid; it < slices * units; it += kThreads) {
    const int s = it / units, u = it % units, c0 = s * kSliceChunks, c1 = min(chunks, c0 + kSliceChunks);
    float* dst = sl + (size_t)s * n;
    if (u < ug)
      chunk_run<V>(p, cn, (size_t)i0 * c + u * V, c0, c1, dst + u * V);
    else if (u < ug + nr)
      chunk_run<1>(p, cn, (size_t)c * c + i0 + (u - ug), c0, c1, dst + nr * c + (u - ug));
    else
      chunk_run<V>(p, cn, (size_t)c * c + c + (u - ug - nr) * V, c0, c1, dst + nr * c + nr + (u - ug - nr) * V);
  }
  __syncthreads();
  for (int e = tid; e < n; e += kThreads) {
    float v = sl[e];
    for (int s = 1; s < slices; ++s) v += sl[(size_t)s * n + e];
    sg[e] = e < nr * c ? v : inv_norm(v);
  }
  __syncthreads();
  const float tv = ld(temp[bh]);
  for (int i = tid >> 5; i < nr; i += kThreads / 32)
    attn_row<T>(sg + (size_t)i * c, rq[i], rk, tv, c, use_softmax, attn + ((size_t)bh * c + i0 + i) * c);
}

template <class Tl>
constexpr int av_smem_floats() {
  return Tl::kStages * (Tl::kBM * tc::kKLD + tc::kKC * (Tl::kBN + 4));
}

// out[bh][i][l] = sum over d of attn[bh][i][d] v[bh][d][l]: a kBM x kBN tile of head bh, the
// depth c in 32-deep chunks; blockIdx.x runs over the pixel tiles fastest, then the row tiles,
// then the heads
template <class Tl, typename T>
__global__ void __launch_bounds__(kThreads, Tl::kMinBlocks)
mdta_av_kernel(const float* __restrict__ attn, const T* __restrict__ v, T* __restrict__ out, int c, int L) {
  constexpr int MT = Tl::kMT, NT = Tl::kNT, kRLD = Tl::kBN + 4, kA = Tl::kBM * tc::kKLD;
  constexpr int kStage = kA + tc::kKC * kRLD;
  // attn holds values of T (TF32 already in bf16): a lo part only in fp32, as v's
  constexpr bool kLo = sizeof(T) == sizeof(float);
  extern __shared__ __align__(16) float smem[];
  const int lt = (L + Tl::kBN - 1) / Tl::kBN, rt = (c + Tl::kBM - 1) / Tl::kBM;
  const int n0 = blockIdx.x % lt * Tl::kBN, r0 = blockIdx.x / lt % rt * Tl::kBM, bh = blockIdx.x / lt / rt;
  const int steps = (c + tc::kKC - 1) / tc::kKC;
  const auto a = head_operand<true>(attn + (size_t)bh * c * c, c, c);
  const auto b = head_operand<false>(v + (size_t)bh * c * L, L, L);
  auto sa = [&](int s) { return smem + (s % Tl::kStages) * kStage; };
  auto sb = [&](int s) { return reinterpret_cast<T*>(smem + (s % Tl::kStages) * kStage + kA); };
  auto fill = [&](int s) {
    if (s < steps) {
      const int k0 = s * tc::kKC, k1 = min(c, k0 + tc::kKC);
      stage_unrolled<float, true, Tl::kBM>(a, sa(s), r0, k0, k1);
      stage_unrolled<T, false, Tl::kBN>(b, sb(s), n0, k0, k1);
    }
    cp_async_commit();
  };
  float acc[MT][NT][4];  // the depth is c (<= 176 at the nets' heads): one running sum
  zero(acc);
  for (int s = 0; s < Tl::kStages - 1; ++s) fill(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<Tl::kStages - 2>();
    __syncthreads();
    fill(s + Tl::kStages - 1);
    mma_steps<Tl, kLo, kLo, false, kRLD>(acc, sa(s), sb(s), c - s * tc::kKC);
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = (threadIdx.x >> 5) / Tl::kWN, wn = (threadIdx.x >> 5) % Tl::kWN;
  T* ob = out + (size_t)bh * c * L;
  if ((threadIdx.x >> 5) >= Tl::kMmaWarps) return;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) {
      const int r = r0 + (wm * MT + mi) * 16 + g, l = n0 + (wn * NT + nj) * 8 + 2 * t;
      if (l >= L) continue;
      if (r < c) store2(ob + (size_t)r * L + l, acc[mi][nj][0], acc[mi][nj][1], l + 1 < L);
      if (r + 8 < c) store2(ob + (size_t)(r + 8) * L + l, acc[mi][nj][2], acc[mi][nj][3], l + 1 < L);
    }
}

// A kernel's dynamic shared-memory limit raised to bytes once per device (raised: a bit a device)
template <class K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (raised >> dev & 1))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) raised |= 1ull << dev;
  return err;
}

// The tile family a call takes: 0 (Gram 48 x 48, attn . v 48 rows) where c <= 48, else 1 (96)
inline int pick_tile(int c) { return c <= 48 ? 0 : 1; }

template <class G, class A, typename T>
int run(const T* q, const T* k, const T* v, const T* temp, T* out, float* ws, int BH, int c, int L, int use_softmax,
        cudaStream_t s) {
  static unsigned long long raised[5] = {0, 0, 0, 0, 0};
  const int len = chunk_len(BH, c, L), chunks = (L + len - 1) / len, gt = (c + G::kBM - 1) / G::kBM;
  float* part = ws;
  float* attn = ws + (size_t)BH * chunks * ((size_t)c * c + 2 * c);
  const dim3 ggrid(BH * chunks, gt * gt);
  constexpr int gbytes = gram_smem_floats<G>() * sizeof(float);
  const int slices = reduce_slices(chunks), rows = reduce_rows(BH, c, slices);
  const long long rbytes = (long long)(slices + 1) * (rows * c + rows + c) * sizeof(float);
  if (rbytes > kSmemMax) return cudaErrorInvalidValue;  // not for any c <= kMaxC: checked before the first launch
  cudaError_t err;
  if (chunks == 1 && gt == 1) {  // one block a head's tile computes attn itself: two launches
    if ((err = allow_smem(mdta_gram_kernel<G, T, true>, gbytes, raised[0])) != cudaSuccess) return err;
    mdta_gram_kernel<G, T, true><<<ggrid, kThreads, gbytes, s>>>(q, k, temp, part, attn, c, L, chunks, len,
                                                                 use_softmax);
  } else {
    if ((err = allow_smem(mdta_gram_kernel<G, T, false>, gbytes, raised[1])) != cudaSuccess) return err;
    mdta_gram_kernel<G, T, false><<<ggrid, kThreads, gbytes, s>>>(q, k, temp, part, attn, c, L, chunks, len,
                                                                  use_softmax);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const unsigned rgrid = (unsigned)((c + rows - 1) / rows) * BH;
    if (c % 4 == 0) {  // every run 16-byte aligned
      if ((err = allow_smem(mdta_reduce_kernel<T, 4>, kSmemMax, raised[2])) != cudaSuccess) return err;
      mdta_reduce_kernel<T, 4><<<rgrid, kThreads, (int)rbytes, s>>>(part, temp, attn, c, chunks, rows, slices, use_softmax);
    } else {
      if ((err = allow_smem(mdta_reduce_kernel<T, 1>, kSmemMax, raised[4])) != cudaSuccess) return err;
      mdta_reduce_kernel<T, 1><<<rgrid, kThreads, (int)rbytes, s>>>(part, temp, attn, c, chunks, rows, slices, use_softmax);
    }
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int abytes = av_smem_floats<A>() * sizeof(float);
  if ((err = allow_smem(mdta_av_kernel<A, T>, abytes, raised[3])) != cudaSuccess) return err;
  const unsigned agrid = (unsigned)((L + A::kBN - 1) / A::kBN) * ((c + A::kBM - 1) / A::kBM) * BH;
  mdta_av_kernel<A, T><<<agrid, kThreads, abytes, s>>>(attn, v, out, c, L);
  return cudaGetLastError();
}

template <typename T>
int mdta(const void* q, const void* k, const void* v, const void* temp, void* out, void* workspace, int BH, int c,
         int L, int use_softmax, int tile, void* stream) {
  if (BH == 0 || c == 0 || L == 0) return cudaSuccess;
  if (c > kMaxC) return cudaErrorInvalidValue;
  const T *pq = static_cast<const T*>(q), *pk = static_cast<const T*>(k), *pv = static_cast<const T*>(v);
  const T* pt = static_cast<const T*>(temp);
  T* po = static_cast<T*>(out);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile < 0 ? pick_tile(c) : tile) {
    case 0: return run<Gram48, Av48, T>(pq, pk, pv, pt, po, ws, BH, c, L, use_softmax, s);
    default: return run<Gram96, Av96, T>(pq, pk, pv, pt, po, ws, BH, c, L, use_softmax, s);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers: q, k, v and out
// (BH, c, L) contiguous, temp (BH), all in the I/O type; workspace of
// mdta_workspace_floats(BH, c, L) floats; tile -1 (pick_tile's), or 0 (48) or
// 1 (96) to take that tile family (tests and A/B tools).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for c > kMaxC before any launch.
#define MDTA_ARGS const void *q, const void *k, const void *v, const void *temp, void *out, void *workspace, int BH, \
                  int c, int L, int use_softmax, int tile, void *stream
#define MDTA_PASS q, k, v, temp, out, workspace, BH, c, L, use_softmax, tile, stream

extern "C" int mdta_f32(MDTA_ARGS) { return mdta<float>(MDTA_PASS); }
extern "C" int mdta_bf16(MDTA_ARGS) { return mdta<__nv_bfloat16>(MDTA_PASS); }

// The chunks' partials (BH, chunks, c^2 + 2c), then attn (BH, c, c)
extern "C" long long mdta_workspace_floats(int BH, int c, int L) {
  if (BH == 0 || c == 0 || L == 0) return 0;
  return (long long)BH * num_chunks(BH, c, L) * ((long long)c * c + 2 * c) + (long long)BH * c * c;
}
