// Channel LayerNorm fused with a 1x1 projection on Hopper (sm_90a): the
// product on the tensor cores (mma.sync m16n8k8 TF32 through tc_gemm.cuh's
// pieces, 3xTF32 for fp32 operands), fp32 or bf16 I/O.
//
// Replaces two TPU kernels:
//   dcpt_tpu/ops/ln_proj.py::fused_ln_proj (_kernel :36, pallas_call :60), K14:
//     out = LN(x) . w, LN BiasFree ((x rs) lnw, centred variance, uncentred
//     output) or WithBias (((x - mu) rs) lnw + lnb), fp32 statistics; the
//     Restormer / PromptIR MDTA qkv and GDFN project_in prefix (MDTA and GDFN
//     with pre_norm);
//   dcpt_tpu/ops/naf_ffn.py::naf_expand (_expand_kernel :102, pallas_call
//     :115), K5': out = LN(x) . w1 + b1, WithBias, eps 1e-6 (NAFNet's LN ->
//     1x1 expand).
// x is (rows, C) row-major, w (C, N) in either layout: dcpt_tpu's (in, out)
// row-major, read depth-major, or a transposed view of PyTorch's (out, in)
// 1x1 weight (strides (1, C)), read k-major (tc::Operand), so the caller
// copies neither; the optional output bias is (N,).
//
// What bounds it on this card: 2 C N flops a row against (C + N) itemsize
// bytes (x read and out written once) and the weight once.  K5' at NAFNet's
// c = 512 stage, B = 8 (2048 x 512 -> 1024) is bound by operations: 0.013 ms
// of 3xTF32 on the tensor cores (PEAK_TF32 / 3), where the SIMT fp32 pipes
// alone need 0.032.  K14 at Restormer's first level (C 48 -> 144 and 254,
// 131 k rows at B = 8) is bound by the bytes it writes: its depth is 48.
// Measured (PERF.md, section 6), what held the kernel back beside the MMAs was
// what surrounds them: a pass over x for the rows' statistics before the
// first MMA (each column tile's block read its rows again: one wave at K5''s
// shape, so nothing hid it), and the staging's and the sums' instructions,
// which with two warps a scheduler compete with the MMAs for issue slots.
//
// What the design does about it: one launch a call.  A block computes a
// kBM x kBN tile of out (Tile: 8 warps, each MT x NT MMA tiles; pick_tile
// takes one of four by the call's shape).  It streams the depth through a
// ring of three cp.async chunks (32 deep: raw x, the weight, the chunk's LN
// weight and bias), one barrier a chunk, each thread's 16-byte copies
// unrolled (stage_vec).  Where a staged pair of x is read into an MMA
// fragment it is turned into A in registers and split into its TF32 parts
// (tc_gemm.cuh's 3xTF32: three MMAs a step for fp32 operands; two for
// naf_expand in bf16; one for fused_ln_proj in bf16, whose A is rounded to
// bf16 and so TF32 already).  LN(x) never goes to device memory.
//   fp32, and naf_expand in either type: the statistics are deferred.  rs
// factors out of each row's sum, so A is (x - m) lnw, m the mean of the row's
// first chunk (BiasFree: x lnw), and the epilogue takes rs (sum - (mu - m) c1)
// + c2 (BiasFree: rs sum), c1 and c2 the columns' sums of lnw w and lnb w.
// The block sums x - m, (x - m)^2, c1 and c2 from the chunks as they stream
// (two threads a row or column, 4-depth units in an order that keeps a
// quarter-warp's loads on distinct banks), so x is read once and no pass
// waits before the first MMA; m is the mean of 32 of the row's C values, so
// |mu - m| <= sqrt(C / 32) sigma (and about sigma / sqrt(32) without structure
// across the channels), and the shifted sums give mu and the centred variance
// to fp32 accuracy.
//   fused_ln_proj in bf16 (ROUND_LN) rounds the normalised value to bf16
// before the LN weight, and the affine again, as ln_proj_ref casts
// (ln_proj.py:31-33): the rows' mu, then the centred variance, come first,
// from the ring where it holds the whole depth (C <= 64), else from device
// memory while the first chunks fly, rows held in registers.
// Each 32-deep chunk is summed from zero and added to the block's sum by one
// rounded add, as tc_gemm.cuh does (an MMA rounds toward zero).  The output
// bias and the store in the I/O type are the epilogue.  No atomics, and
// every sum in an order set by the shape alone: the same bits from run to
// run, for either layout of w and at every tile.
//
// Where it departs from the TPU kernels: dcpt_tpu drops to the jnp reference
// at C > 512, C % 16 != 0 or a weight over 6 MB (VMEM limits of the TPU, and
// the same function either way); every C and N is taken here (ragged rows,
// columns and depth masked), so the PromptIR noise-level width of 704 runs
// the kernel too.  dcpt_tpu's custom VJPs differentiate the references; the
// port's autograd Functions run the plain versions' VJPs likewise.

#include "common.cuh"
#include "tc_gemm.cuh"

namespace {

// A block's tile: kWM x (8 / kWM) warps, a warp MT x NT MMA tiles (16 rows,
// 8 columns each), a ring of STAGES chunks
template <int WM, int MT, int NT, int STAGES>
struct Tile {
  static constexpr int kWM = WM, kWN = 8 / WM, kMT = MT, kNT = NT, kStages = STAGES;
  static constexpr int kBM = kWM * kMT * 16, kBN = kWN * kNT * 8;
  static constexpr int kA = kBM * tc::kKLD;  // floats of x's chunk (k-major), enough for bf16 too
  static constexpr int kB = kBN * tc::kKLD;  // floats of w's chunk, either layout
  static constexpr int kStage = kA + kB + 2 * tc::kKC;  // and the chunk's LN weight and bias, fp32
  // the ring, then the rows' mu, rs and first-chunk mean, the columns' two LN sums (ln_proj_kernel)
  static constexpr int kSmemFloats = kStages * kStage + 5 * kBM + 4 * kBN;
  static constexpr int kMinBlocks = 2 * kSmemFloats * 4 <= 227 * 1024 ? 2 : 1;
  static_assert(kWM * kWN == kThreads / 32, "8 warps");
  static_assert(kB >= tc::kKC * (kBN + 4), "a depth-major chunk of w fits its stage");
};

// The tiles a call may take, each two blocks an SM with a ring of three chunks
using Tile96 = Tile<2, 3, 3, 3>;  // 96 x 96, warps 48 x 24
using Tile64 = Tile<2, 2, 4, 3>;  // 64 x 128, warps 32 x 32
using Tile32 = Tile<2, 1, 2, 3>;  // 32 x 64, warps 16 x 16: small products
using Tile128 = Tile<4, 2, 8, 3>;  // 128 x 128, warps 32 x 64: one block an SM, the deep products

// The tile of a call (0 Tile96, 1 Tile64, 2 Tile32, 3 Tile128), by device time at the nets'
// shapes on the H100 (PERF.md, section 6): a product that gives Tile96 under one block an SM takes
// the small tile (its time is a few chunks' latency); any other the tile of least estimated
// time, waves (whole ones up to four) x the area an SM computes a wave / the tile's measured
// efficiency there (Tile128, one block an SM, loses its lead over the two-block tiles where
// the depth is short and each block's prologue and epilogue are most of its time).
inline int pick_tile(int rows, int C, int N) {
  constexpr int kSMs = 132;
  auto blocks = [&](int bm, int bn) { return (double)((rows + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (blocks(Tile96::kBM, Tile96::kBN) < kSMs) return 2;
  struct Cand {
    int tile, bm, bn, per_sm;
    double eff;
  };
  const Cand cands[3] = {{0, Tile96::kBM, Tile96::kBN, 2, 0.87},
                         {1, Tile64::kBM, Tile64::kBN, 2, 0.85},
                         {3, Tile128::kBM, Tile128::kBN, 1, C >= 256 ? 1.0 : 0.75}};
  int best = 0;
  double best_t = 0.0;
  for (const Cand& c : cands) {
    double waves = blocks(c.bm, c.bn) / (kSMs * c.per_sm);
    waves = waves > 4.0 ? waves : (double)(long long)(waves + 0.999999);
    const double t = waves * c.per_sm * c.bm * c.bn / c.eff;
    if (best_t == 0.0 || t < best_t) best = c.tile, best_t = t;
  }
  return best;
}

// Four elements of a row from p (16 bytes of fp32, 8 of bf16, so aligned), as fp32
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const float2 a = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[0]);
  const float2 b = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// tc::stage for an operand of whole aligned 4-element units (op.vec) and no paired rows: the
// same layout, each thread's units unrolled (R a multiple of 32: whole units a thread)
template <typename T, bool K, int R>
__device__ __forceinline__ void stage_vec(const tc::Operand<T, K>& op, T* buf, int r0, int k0, int k1) {
  constexpr int kUnits = R * tc::kKC / 4;
  static_assert(kUnits % kThreads == 0, "whole units a thread");
#pragma unroll
  for (int i = 0; i < kUnits / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads;
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

// out's column pair (n, n + 1) of a row in the I/O type; n + 1 only if two
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

// A's element from x's value, its row's off and rs, the depth's LN weight and bias.  With
// ROUND_LN the whole LayerNorm, off the row's mu, rounded as ln_proj_ref casts (the
// normalised value in T, then each step of the affine); otherwise the deferred form
// (ln_proj_kernel): (x - m) lnw, off = -m, or BiasFree x lnw
template <typename T, bool LN_BIAS, bool ROUND_LN>
__device__ __forceinline__ float norm(float xv, float off, float rs, float w, float b) {
  if (ROUND_LN) {
    const float a = ld(st<T>(ld(st<T>((LN_BIAS ? xv - off : xv) * rs)) * w));
    return LN_BIAS ? ld(st<T>(a + b)) : a;
  }
  return LN_BIAS ? (xv + off) * w : xv * w;
}

// a = hi + lo for 3xTF32 (kLo; else a is TF32 already and lo 0): hi rounded to TF32,
// lo left unrounded, since the MMA reads a TF32 operand's 19 high bits and drops the
// rest (the small part's own rounding error is 2^-11 of a term 2^-11 of a)
template <bool kLo>
__device__ __forceinline__ void split_hi(float a, float& hi, float& lo) {
  hi = kLo ? tf32_round(a) : a;
  lo = kLo ? a - hi : 0.f;
}

// The mean, then the centred variance, of the block's rows [r0, r0 + kBM) of x in fp32, from
// device memory: sMu, and sRs = 1 / sqrt(var + eps), zeros for rows past the last (their
// products are masked and stay finite).  A warp takes kG rows at a time.  Rows of whole
// aligned 4-element units, at most kQ of them a lane, are held in registers (each lane every
// 32nd unit), so that a group's loads are all in flight at once and the variance reads no
// row again; any other row is read twice, each lane every 32nd element.
template <class Tl, typename T>
__device__ __forceinline__ void row_stats(const tc::Operand<T, true>& a, int r0, int C, float eps, float* sMu,
                                          float* sRs) {
  constexpr int kG = 4, kQ = 4, kPerWarp = Tl::kBM / (kThreads / 32);
  static_assert(kPerWarp % kG == 0, "whole groups of rows");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool held = a.vec && C <= 128 * kQ;
  for (int g0 = 0; g0 < kPerWarp; g0 += kG) {
    int p[kG];
    bool live[kG];
    const T* xr[kG];
    float s[kG], v[kG], mu[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      p[j] = warp + (kThreads / 32) * (g0 + j);
      live[j] = r0 + p[j] < a.rows;
      xr[j] = a.ptr + (size_t)(live[j] ? r0 + p[j] : r0) * C;
      s[j] = v[j] = 0.f;
    }
    if (held) {
      float e[kG][kQ][4];
#pragma unroll
      for (int j = 0; j < kG; ++j)
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int c = 4 * lane + 128 * q;
          if (c < C) {
            ld4(xr[j] + c, e[j][q]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) e[j][q][i] = 0.f;
          }
        }
#pragma unroll
      for (int j = 0; j < kG; ++j) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) s[j] += ((e[j][q][0] + e[j][q][1]) + e[j][q][2]) + e[j][q][3];
        mu[j] = warp_sum(s[j]) / C;
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          if (4 * lane + 128 * q < C)
#pragma unroll
            for (int i = 0; i < 4; ++i) v[j] += (e[j][q][i] - mu[j]) * (e[j][q][i] - mu[j]);
      }
    } else {
      for (int c = lane; c < C; c += 32)
#pragma unroll
        for (int j = 0; j < kG; ++j) s[j] += ld(xr[j][c]);
#pragma unroll
      for (int j = 0; j < kG; ++j) mu[j] = warp_sum(s[j]) / C;
      for (int c = lane; c < C; c += 32)
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          const float d = ld(xr[j][c]) - mu[j];
          v[j] += d * d;
        }
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const float var = warp_sum(v[j]) / C;
      if (lane == 0) {
        sMu[p[j]] = live[j] ? mu[j] : 0.f;
        sRs[p[j]] = live[j] ? 1.f / sqrtf(var + eps) : 0.f;
      }
    }
  }
}

// out (rows, N) = LN(x) . w (+ ob): the block's tile blockIdx.x (column tiles fastest).
//
// Two ways to the statistics.  With ROUND_LN (fused_ln_proj in bf16) the normalised
// value itself is rounded, so the rows' mu and rs come first (from the ring, or
// row_stats) and A is the whole LN(x).  Otherwise they are deferred: rs factors out of
// each row's sum,
//   LN(x) . w = rs [sum_k (x_k - m) lnw_k w_kn - (mu - m) c1_n] + c2_n,
//   c1_n = sum_k lnw_k w_kn, c2_n = sum_k lnb_k w_kn (WithBias; BiasFree: rs sum_k x_k lnw_k w_kn),
// with m the mean of the row's first chunk: A is (x - m) lnw, and the block sums x - m,
// (x - m)^2 and c1, c2 from the chunks as they stream (two threads a row or column, 16
// depths of a chunk each, the same order for every tile), so x is read once and no
// statistics pass waits before the first MMA.  mu - m = s1 / C and the centred variance
// s2 / C - (mu - m)^2 keep fp32 accuracy: |mu - m| is at most sqrt(C / 32) sigma.
template <class Tl, typename T, bool BK, bool LN_BIAS, bool ROUND_LN, bool OUT_BIAS>
__global__ void __launch_bounds__(kThreads, Tl::kMinBlocks)
ln_proj_kernel(tc::Operand<T, true> a, const T* __restrict__ lnw, const T* __restrict__ lnb, tc::Operand<T, BK> w,
               const T* __restrict__ ob, T* __restrict__ out, int C, float eps) {
  constexpr int MT = Tl::kMT, NT = Tl::kNT, kSteps = tc::kKC / 8, kHalf = tc::kKC / 2;
  constexpr bool kDefer = !ROUND_LN;
  // A's parts: fused_ln_proj in bf16 rounds LN(x) to bf16, TF32 already; every other A is fp32
  constexpr bool kAlo = !ROUND_LN, kBlo = sizeof(T) == sizeof(float);
  extern __shared__ __align__(16) float smem[];
  const int rows = a.rows, N = w.rows, tid = threadIdx.x;
  const int ntiles = (N + Tl::kBN - 1) / Tl::kBN;
  const int r0 = (blockIdx.x / ntiles) * Tl::kBM, n0 = (blockIdx.x % ntiles) * Tl::kBN;
  const int chunks = (C + tc::kKC - 1) / tc::kKC;
  float* sMu = smem + Tl::kStages * Tl::kStage;  // mu (ROUND_LN), or mu - m
  float* sRs = sMu + Tl::kBM;
  float* sShift = sRs + Tl::kBM;  // m
  float* sP = sShift + Tl::kBM;  // the second halves' row partials (2 kBM), then column partials (2 kBN)
  float* sC1 = sP + 2 * Tl::kBM + 2 * Tl::kBN;
  float* sC2 = sC1 + Tl::kBN;
  auto base = [&](int c) { return smem + (c % Tl::kStages) * Tl::kStage; };
  auto fill = [&](int c) {
    if (c < chunks) {
      const int k0 = c * tc::kKC, k1 = min(C, k0 + tc::kKC);
      float* buf = base(c);
      if (a.vec && w.vec) {
        stage_vec<T, true, Tl::kBM>(a, reinterpret_cast<T*>(buf), r0, k0, k1);
        stage_vec<T, BK, Tl::kBN>(w, reinterpret_cast<T*>(buf + Tl::kA), n0, k0, k1);
      } else {
        tc::stage<T, true, Tl::kBM>(a, reinterpret_cast<T*>(buf), r0, k0, k1);
        tc::stage<T, BK, Tl::kBN>(w, reinterpret_cast<T*>(buf + Tl::kA), n0, k0, k1);
      }
      if (tid < 2 * tc::kKC) {  // the LN weight (and bias) of the chunk's depths, zero past k1
        const int i = tid % tc::kKC, k = k0 + i;
        const T* src = tid < tc::kKC ? lnw : lnb;
        float* dst = buf + Tl::kA + Tl::kB + tid;
        if (LN_BIAS || tid < tc::kKC) {
          if (sizeof(T) == sizeof(float))
            cp_async<4>(dst, k < k1 ? src + k : src, k < k1 ? 4 : 0);
          else
            *dst = k < k1 ? ld(src[k]) : 0.f;
        }
      }
    }
    cp_async_commit();
  };
  // the deferred sums: thread h kBM + r takes row r's depths [16 h, 16 h + 16) of each chunk,
  // and (WithBias) thread h kBN + n column n's, by 4-depth units in an order rotated by one
  // unit where (r / 4) is odd, so that a quarter-warp's 16-byte loads hit distinct banks of the
  // k-major chunks (rows kKLD = 8 (mod 32) apart); the same order in every tile and layout
  // (r0 and n0 are multiples of 32)
  constexpr int kCols = (2 * Tl::kBN + kThreads - 1) / kThreads;  // (column, half) pairs a thread
  const bool row_sums = kDefer && tid < 2 * Tl::kBM;
  const int my = tid % Tl::kBM, kh = tid / Tl::kBM * kHalf, rot = (my >> 2) & 1;
  float s1 = 0.f, s2 = 0.f, c1[kCols], c2[kCols], shift = 0.f;
#pragma unroll
  for (int q = 0; q < kCols; ++q) c1[q] = c2[q] = 0.f;
  auto col_pair = [&](int q, int& n, int& h) {  // pair q of the thread: column n, depth half h; false past them
    const int i = tid + q * kThreads;
    n = i % Tl::kBN;
    h = i / Tl::kBN * kHalf;
    return kDefer && LN_BIAS && i < 2 * Tl::kBN;
  };
  for (int c = 0; c < Tl::kStages - 1; ++c) fill(c);

  if (kDefer) {  // m: the mean of each row's first chunk
    cp_async_wait<Tl::kStages - 2>();
    __syncthreads();
    const T* xr = reinterpret_cast<const T*>(base(0)) + my * tc::kKLD + kh;
    float m = 0.f;
    if (row_sums) {
#pragma unroll
      for (int j = 0; j < kHalf / 4; ++j) {  // zero past C
        float e[4];
        ld4(xr + 4 * ((j + rot) & 3), e);
        m += ((e[0] + e[1]) + e[2]) + e[3];
      }
      if (kh) sP[my] = m;
    }
    __syncthreads();
    if (row_sums && !kh) sShift[my] = (m + sP[my]) / min(C, tc::kKC);
    __syncthreads();
    if (row_sums) shift = sShift[my];
  } else if (C <= (Tl::kStages - 1) * tc::kKC) {  // ROUND_LN, the whole depth in the ring: read there, two threads a row
    cp_async_wait<0>();
    __syncthreads();
    const bool mine = tid < 2 * Tl::kBM;
    auto over = [&](auto f) {  // f(x) over the thread's half of each chunk's live depths, as the deferred sums take them
      for (int c = 0; c < chunks; ++c)
#pragma unroll
        for (int j = 0; j < kHalf / 4; ++j) {
          const int k = kh + 4 * ((j + rot) & 3);
          float e[4];
          ld4(reinterpret_cast<const T*>(base(c)) + my * tc::kKLD + k, e);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c * tc::kKC + k + i < C) f(e[i]);
        }
    };
    float sum = 0.f, var = 0.f;
    if (mine) over([&](float v) { sum += v; });
    if (mine && kh) sP[my] = sum;
    __syncthreads();
    if (mine && !kh) sMu[my] = (sum + sP[my]) / C;
    __syncthreads();
    const float mu = mine ? sMu[my] : 0.f;
    if (mine) over([&](float v) { var += (v - mu) * (v - mu); });
    if (mine && kh) sP[my] = var;
    __syncthreads();
    if (mine && !kh) {
      sRs[my] = r0 + my < rows ? 1.f / sqrtf((var + sP[my]) / C + eps) : 0.f;
      if (r0 + my >= rows) sMu[my] = 0.f;
    }
  } else {  // ROUND_LN: from device memory while the first chunks fly
    row_stats<Tl>(a, r0, C, eps, sMu, sRs);
  }
  __syncthreads();

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = (tid >> 5) / Tl::kWN, wn = (tid >> 5) % Tl::kWN;
  float off[MT][2], rs[MT][2];  // the fragment rows' rows g and g + 8 of each row tile: norm's offset and rs
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + mi) * 16 + g + 8 * h;
      rs[mi][h] = kDefer ? 1.f : sRs[r];
      off[mi][h] = kDefer ? -sShift[r] : sMu[r];
    }
  float acc[MT][NT][4], part[MT][NT][4];  // the sum so far, and the chunk's
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<Tl::kStages - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1, whose stage fill takes next
    fill(c + Tl::kStages - 1);
    const float* buf = base(c);
    const T* sa = reinterpret_cast<const T*>(buf);
    const T* sb = reinterpret_cast<const T*>(buf + Tl::kA);
    const float* sl = buf + Tl::kA + Tl::kB;
    const int live = min(tc::kKC, C - c * tc::kKC), steps = (live + 7) / 8;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (s >= steps) break;
      // depths k and k + 1 are the MMA's slots t and t + 4 in both operands (tc::mma_chunk)
      const int k = 8 * s + 2 * t;
      const float2 lw = *reinterpret_cast<const float2*>(sl + k);
      const float2 lb = LN_BIAS && !kDefer ? *reinterpret_cast<const float2*>(sl + tc::kKC + k) : make_float2(0.f, 0.f);
      float ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = (wm * MT + mi) * 16 + g;
        const float2 u = tc::pair<true>(sa, r, k), v = tc::pair<true>(sa, r + 8, k);
        split_hi<kAlo>(norm<T, LN_BIAS, ROUND_LN>(u.x, off[mi][0], rs[mi][0], lw.x, lb.x), ah[mi][0], al[mi][0]);
        split_hi<kAlo>(norm<T, LN_BIAS, ROUND_LN>(v.x, off[mi][1], rs[mi][1], lw.x, lb.x), ah[mi][1], al[mi][1]);
        split_hi<kAlo>(norm<T, LN_BIAS, ROUND_LN>(u.y, off[mi][0], rs[mi][0], lw.y, lb.y), ah[mi][2], al[mi][2]);
        split_hi<kAlo>(norm<T, LN_BIAS, ROUND_LN>(v.y, off[mi][1], rs[mi][1], lw.y, lb.y), ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const float2 u = tc::pair<BK, Tl::kBN + 4>(sb, (wn * NT + nj) * 8 + g, k);
        split_hi<kBlo>(u.x, bh[nj][0], bl[nj][0]);
        split_hi<kBlo>(u.y, bh[nj][1], bl[nj][1]);
      }
      if (kAlo) tc::mma_term(part, al, bh);
      if (kBlo) tc::mma_term(part, ah, bl);
      tc::mma_term(part, ah, bh);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
    if (row_sums) {  // x - m and its square over the thread's half of the chunk's live depths
#pragma unroll
      for (int j = 0; j < kHalf / 4; ++j) {
        const int k = kh + 4 * ((j + rot) & 3);
        float e[4];
        ld4(sa + my * tc::kKLD + k, e);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (live == tc::kKC || k + i < live) {
            const float d = e[i] - shift;
            s1 += d;
            s2 += d * d;
          }
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {  // lnw . w and lnb . w down the thread's columns (zero past C)
      int n, h;
      if (!col_pair(q, n, h)) continue;
#pragma unroll
      for (int j = 0; j < kHalf / 4; ++j) {
        const int k = h + 4 * ((j + ((n >> 2) & 1)) & 3);
        float wv[4], lw[4], lb[4];
        if (BK) {
          ld4(sb + n * tc::kKLD + k, wv);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = ld(sb[(k + i) * (Tl::kBN + 4) + n]);
        }
        ld4(sl + k, lw);
        ld4(sl + tc::kKC + k, lb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c1[q] += lw[i] * wv[i];
          c2[q] += lb[i] * wv[i];
        }
      }
    }
  }
  if (kDefer) {  // each row's mu - m and rs, each column's c1 and c2: first half + second half
    float* sQ = sP + 2 * Tl::kBM;
    if (row_sums && kh) sP[my] = s1, sP[Tl::kBM + my] = s2;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      int n, h;
      if (col_pair(q, n, h) && h) sQ[n] = c1[q], sQ[Tl::kBN + n] = c2[q];
    }
    __syncthreads();
    if (row_sums && !kh) {
      const float dm = (s1 + sP[my]) / C, var = (s2 + sP[Tl::kBM + my]) / C - dm * dm;
      sMu[my] = dm;
      sRs[my] = r0 + my < rows ? 1.f / sqrtf(fmaxf(var, 0.f) + eps) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      int n, h;
      if (col_pair(q, n, h) && !h) {
        sC1[n] = c1[q] + sQ[n];
        sC2[n] = c2[q] + sQ[Tl::kBN + n];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + mi) * 16 + g + 8 * h;
      if (r0 + r >= rows) continue;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int nl = (wn * NT + nj) * 8 + 2 * t, n = n0 + nl;
        if (n >= N) continue;
        const bool two = n + 1 < N;
        float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (kDefer) {
          const float rsr = sRs[r];
          if (LN_BIAS) {
            const float dm = sMu[r];
            v0 = rsr * (v0 - dm * sC1[nl]) + sC2[nl];
            v1 = rsr * (v1 - dm * sC1[nl + 1]) + sC2[nl + 1];
          } else {
            v0 *= rsr;
            v1 *= rsr;
          }
        }
        if (OUT_BIAS) {
          v0 += ld(ob[n]);
          if (two) v1 += ld(ob[n + 1]);
        }
        store2(out + (size_t)(r0 + r) * N + n, v0, v1, two);
      }
    }
}

// One launch: the grid's tiles, the kernel's shared-memory limit raised once per
// instantiation and device (a call at B = 1 is a few microseconds of device work)
template <class Tl, typename T, bool BK, bool LN_BIAS, bool ROUND_LN, bool OUT_BIAS>
int launch_tile(const tc::Operand<T, true>& a, const T* lnw, const T* lnb, const tc::Operand<T, BK>& w, const T* ob,
                T* out, int C, float eps, cudaStream_t stream) {
  constexpr int bytes = Tl::kSmemFloats * sizeof(float);
  static unsigned long long raised = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(raised >> dev & 1)) {
    err = cudaFuncSetAttribute(ln_proj_kernel<Tl, T, BK, LN_BIAS, ROUND_LN, OUT_BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised |= 1ull << dev;
  }
  const unsigned grid = (unsigned)(((w.rows + Tl::kBN - 1) / Tl::kBN) * ((a.rows + Tl::kBM - 1) / Tl::kBM));
  ln_proj_kernel<Tl, T, BK, LN_BIAS, ROUND_LN, OUT_BIAS><<<grid, kThreads, bytes, stream>>>(a, lnw, lnb, w, ob, out,
                                                                                            C, eps);
  return cudaGetLastError();
}

template <typename T, bool LN_BIAS, bool ROUND_LN, bool OUT_BIAS, bool BK>
int launch_w(const tc::Operand<T, true>& a, const T* lw, const T* lb, const tc::Operand<T, BK>& w, const T* b, T* o,
             int C, float eps, int tile, cudaStream_t stream) {
  switch (tile < 0 ? pick_tile(a.rows, C, w.rows) : tile) {
    case 0: return launch_tile<Tile96, T, BK, LN_BIAS, ROUND_LN, OUT_BIAS>(a, lw, lb, w, b, o, C, eps, stream);
    case 1: return launch_tile<Tile64, T, BK, LN_BIAS, ROUND_LN, OUT_BIAS>(a, lw, lb, w, b, o, C, eps, stream);
    case 2: return launch_tile<Tile32, T, BK, LN_BIAS, ROUND_LN, OUT_BIAS>(a, lw, lb, w, b, o, C, eps, stream);
    default: return launch_tile<Tile128, T, BK, LN_BIAS, ROUND_LN, OUT_BIAS>(a, lw, lb, w, b, o, C, eps, stream);
  }
}

// w (C, N): element (k, n) at w[k ldw + n] (w_kmajor 0: dcpt_tpu's (in, out)) or
// w[n ldw + k] (1: a transposed view of an (out, in) weight); tile -1: pick_tile's, else that tile
template <typename T, bool LN_BIAS, bool ROUND_LN, bool OUT_BIAS>
int launch(const void* x, const void* lnw, const void* lnb, const void* w, long long ldw, int w_kmajor, const void* ob,
           void* out, int rows, int C, int N, float eps, int tile, cudaStream_t stream) {
  if (rows == 0 || N == 0) return cudaSuccess;
  const auto a = tc::operand<true>(static_cast<const T*>(x), C, rows);
  const T *pw = static_cast<const T*>(w), *lw = static_cast<const T*>(lnw), *lb = static_cast<const T*>(lnb);
  const T* b = static_cast<const T*>(ob);
  T* o = static_cast<T*>(out);
  if (w_kmajor) return launch_w<T, LN_BIAS, ROUND_LN, OUT_BIAS>(a, lw, lb, tc::operand<true>(pw, ldw, N), b, o, C, eps,
                                                                 tile, stream);
  return launch_w<T, LN_BIAS, ROUND_LN, OUT_BIAS>(a, lw, lb, tc::operand<false>(pw, ldw, N), b, o, C, eps, tile, stream);
}

template <typename T>
int ln_proj(const void* x, const void* lnw, const void* lnb, const void* w, long long ldw, int w_kmajor, void* out,
            int rows, int C, int N, float eps, int ln_bias, int tile, void* stream) {
  constexpr bool kRound = sizeof(T) < sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln_bias) return launch<T, true, kRound, false>(x, lnw, lnb, w, ldw, w_kmajor, nullptr, out, rows, C, N, eps, tile, s);
  return launch<T, false, kRound, false>(x, lnw, lnb, w, ldw, w_kmajor, nullptr, out, rows, C, N, eps, tile, s);
}

// naf_expand: WithBias, its LN in fp32 in both dtypes (no ROUND_LN), the output bias
template <typename T>
int naf_expand(const void* x, const void* lnw, const void* lnb, const void* w, long long ldw, int w_kmajor,
               const void* b, void* out, int rows, int C, int N, float eps, int tile, void* stream) {
  return launch<T, true, false, true>(x, lnw, lnb, w, ldw, w_kmajor, b, out, rows, C, N, eps, tile,
                                      static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers, all in the I/O
// type: x (rows, C) row-major, lnw and lnb (C; lnb unread when ln_bias is 0),
// w (C, N) as launch() reads it (ldw, w_kmajor), b (N), out (rows, N); tile -1
// (pick_tile's), or 0-2 to take that tile (tests and A/B tools).  Returns cudaGetLastError().
#define LN_PROJ_ARGS const void *x, const void *lnw, const void *lnb, const void *w, long long ldw, int w_kmajor, \
                     void *out, int rows, int C, int N, float eps, int ln_bias, int tile, void *stream
#define NAF_EXPAND_ARGS const void *x, const void *lnw, const void *lnb, const void *w, long long ldw, int w_kmajor, \
                        const void *b, void *out, int rows, int C, int N, float eps, int tile, void *stream

extern "C" int ln_proj_f32(LN_PROJ_ARGS) {
  return ln_proj<float>(x, lnw, lnb, w, ldw, w_kmajor, out, rows, C, N, eps, ln_bias, tile, stream);
}
extern "C" int ln_proj_bf16(LN_PROJ_ARGS) {
  return ln_proj<__nv_bfloat16>(x, lnw, lnb, w, ldw, w_kmajor, out, rows, C, N, eps, ln_bias, tile, stream);
}
extern "C" int naf_expand_f32(NAF_EXPAND_ARGS) {
  return naf_expand<float>(x, lnw, lnb, w, ldw, w_kmajor, b, out, rows, C, N, eps, tile, stream);
}
extern "C" int naf_expand_bf16(NAF_EXPAND_ARGS) {
  return naf_expand<__nv_bfloat16>(x, lnw, lnb, w, ldw, w_kmajor, b, out, rows, C, N, eps, tile, stream);
}
// The block tile a call of (rows, C) . (C, N) takes: which 0 its rows, 1 its columns
extern "C" int ln_proj_tile(int rows, int C, int N, int which) {
  static const int tiles[4][2] = {{Tile96::kBM, Tile96::kBN}, {Tile64::kBM, Tile64::kBN}, {Tile32::kBM, Tile32::kBN},
                                  {Tile128::kBM, Tile128::kBN}};
  return tiles[pick_tile(rows, C, N)][which != 0];
}
