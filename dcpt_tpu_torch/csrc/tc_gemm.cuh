// A product on Hopper's tensor cores for the port's token-wide GEMMs:
// D (M x N) = A (M x depth) . B (depth x N), in fp32 from fp32 or bf16
// operands, through mma.sync m16n8k8 TF32 (csrc/ptx.cuh) with fp32 sums.
// K9 (csrc/swin_block_bwd.cu), K7 (csrc/mdta_block_bwd.cu) and K2
// (csrc/naf_block_bwd.cu) run their token-wide products and weight gradients
// through it (K2 and K7 by token_bwd.cuh's product and wgrad), and the
// forwards K6 (csrc/mdta_block.cu) and K1 (csrc/naf_block.cu) their 1x1
// products (token_bwd.cuh's product_epi); it takes no kernel-specific argument.
//
// Each operand is read from device memory in either layout (Operand<T, K>):
//   k-major   (K) element (r, k) at ptr[r ld + k]: A = a (T, K) of a product,
//             B = W (N, K) in PyTorch's (out, in) layout (a . W^T)
//   otherwise element (r, k) at ptr[k ld + r]: B = W (K, N) read the other
//             way (a . W, the backward's products); A and B of a weight
//             gradient dW (M, N) = sum over tokens p of a[p][m] b[p][n],
//             the tokens being the depth
// so no operand is transposed in memory.
//
// A block of 256 threads computes a 96 x 96 tile of D (8 warps as 2 x 4, a
// warp 48 x 24: 3 x 3 MMA tiles); 96 leaves 7 % of padding at SwinIR's
// widths 180, 360 and 540.  The depth streams through a ring of three
// chunks of 32, two in flight while one is read, one barrier a chunk:
// cp.async copies of 16 bytes (4 fp32) or 8 (4 bf16), zero-filled past the
// operand's rows and depth (where a row is not so aligned, 4-byte copies of
// single fp32 elements, or plain loads of bf16 ones), in
// the operand's own layout: k-major rows 40 elements apart (8 (mod 16): a
// thread's two depth slots t and t + 4 of each MMA are taken as the adjacent
// depths 2t and 2t + 1 in both operands, so a fragment is one 8-byte load,
// and a half-warp's loads hit 32 distinct banks), depth-major rows 100 apart
// (4 (mod 16): depths 2t and 2t + 1 read as two loads, rows 2t apart 8
// (mod 32) banks).  Each fragment is split in registers as it is read into its
// TF32 high part and the rest (a bf16 value is TF32 already: high part
// only), and per 8-deep step the small terms go first (a_lo b_hi, a_hi b_lo),
// then a_hi b_hi: three MMAs for two fp32 operands (3xTF32, fp32 accuracy),
// two for an fp32 and a bf16 one, one for two bf16.  The MMAs of a chunk
// sum from zero, and each chunk's sum is added to the block's by one rounded
// fp32 add: an MMA rounds its sum toward zero, so over a long depth its errors
// add up in one direction.  The ring takes 92,160 bytes: two blocks an SM.
//
// The depth may be cut into chunks of len along blockIdx.y (a weight
// gradient's sum over 131 k tokens), each block adding its chunk's share in
// order; the caller adds the chunks in a fixed order (colsum).  With a_sums
// the blocks of the first column tile also write the chunk's sums over the
// depth of each row of A (a bias gradient) from the staged chunks.  No
// atomics: the same bits from run to run.
#pragma once

#include "common.cuh"
#include "mma_frag.cuh"
#include "ptx.cuh"

namespace {
namespace tc {

constexpr int kBM = 96;                   // rows of D a block computes
constexpr int kBN = 96;                   // columns of D a block computes
constexpr int kKC = 32;                   // depth of a staged chunk
constexpr int kKLD = kKC + 8;             // row stride of a k-major staged chunk
constexpr int kRLD = kBM + 4;             // row stride of a depth-major staged chunk
constexpr int kStage = kBM * kKLD;        // elements of an operand's chunk, either layout (>= kKC kRLD)
constexpr int kStages = 3;                // chunks in the ring
constexpr int kMT = 3, kNT = 3;           // MMA tiles of a warp: 3 x 16 rows, 3 x 8 columns
constexpr int kTargetBlocks = 2 * 132;    // a product cut along the depth: blocks to aim for (two an SM)
static_assert(kBM == 2 * kMT * 16 && kBN == 4 * kNT * 8, "8 warps as 2 x 4");
static_assert(kStage >= kKC * kRLD, "a depth-major chunk fits the stage");

// floats of dynamic shared memory a block takes: the ring's chunks of both
// operands, each in floats (enough for bf16 too)
constexpr int kSmemFloats = 2 * kStages * kStage;

// An operand: element (r, k) at ptr[r ld + k] (K, k-major) or ptr[k ld + r],
// for r < rows; vec when 4-element units are aligned to 4 elements (ld and
// ptr), so they stage by cp.async.  A k-major operand with pair > 0 takes
// its rows from two halves side by side: row r is stored row (r & 1) pair +
// r / 2 (a gate's weight, its pairs (j, pair + j) as adjacent rows 2j, 2j + 1).
template <typename T, bool K>
struct Operand {
  const T* ptr;
  long long ld;
  int rows;
  bool vec;
  int pair;
};

template <bool K, typename T>
Operand<T, K> operand(const T* ptr, long long ld, int rows, int pair = 0) {
  return Operand<T, K>{ptr, ld, rows, ld % 4 == 0 && reinterpret_cast<uintptr_t>(ptr) % (4 * sizeof(T)) == 0, pair};
}

// Depth [k0, k1) of rows [r0, r0 + kBM) into a stage: (r, k) at buf[r kKLD + k - k0]
// (k-major) or buf[(k - k0) kRLD + r], zero past the rows and k1.
template <typename T, bool K>
__device__ __forceinline__ void stage(const Operand<T, K>& op, T* buf, int r0, int k0, int k1) {
  constexpr int kUnits = kBM * kKC / 4;  // 4-element units of a chunk
  for (int u = threadIdx.x; u < kUnits; u += kThreads) {
    int r, k, dst, n;  // the unit's first element, where it lands, its live elements
    if (K) {
      r = r0 + u / (kKC / 4);
      k = k0 + 4 * (u % (kKC / 4));
      dst = (u / (kKC / 4)) * kKLD + 4 * (u % (kKC / 4));
      n = r < op.rows ? min(4, max(0, k1 - k)) : 0;
    } else {
      k = k0 + u / (kBM / 4);
      r = r0 + 4 * (u % (kBM / 4));
      dst = (u / (kBM / 4)) * kRLD + 4 * (u % (kBM / 4));
      n = k < k1 ? min(4, max(0, op.rows - r)) : 0;
    }
    const long long row = K && op.pair ? (long long)(r & 1) * op.pair + (r >> 1) : r;
    const T* src = op.ptr + (K ? row * op.ld + k : (long long)k * op.ld + r);
    if (op.vec) {
      cp_async<4 * sizeof(T)>(buf + dst, n ? src : op.ptr, n * (int)sizeof(T));
    } else if (sizeof(T) == 4) {  // fp32 rows no multiple of 4 elements apart: an element a copy
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async<4>(buf + dst + e, e < n ? src + e : op.ptr, e < n ? 4 : 0);
    } else {  // bf16: cp.async copies 4 bytes at least
#pragma unroll
      for (int e = 0; e < 4; ++e) buf[dst + e] = e < n ? src[e] : st<T>(0.f);
    }
  }
}

// The staged elements (r, k) and (r, k + 1) of a chunk
template <bool K>
__device__ __forceinline__ float2 pair(const float* buf, int r, int k) {
  if (K) return *reinterpret_cast<const float2*>(buf + r * kKLD + k);
  return make_float2(buf[k * kRLD + r], buf[(k + 1) * kRLD + r]);
}
template <bool K>
__device__ __forceinline__ float2 pair(const __nv_bfloat16* buf, int r, int k) {
  if (K) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(buf + r * kKLD + k));
  return make_float2(__bfloat162float(buf[k * kRLD + r]), __bfloat162float(buf[(k + 1) * kRLD + r]));
}

typedef float Acc[kMT][kNT][4];

// acc += one term: a (the warp's row tiles) times b (its column tiles)
__device__ __forceinline__ void mma_term(Acc& acc, const float (&a)[kMT][4], const float (&b)[kNT][2]) {
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) mma_tf32(acc[mi][nj], a[mi], b[nj]);
}

// acc += the staged chunk's first 8 `steps` depths of A's rows times B's
template <typename TA, bool AK, typename TB, bool BK>
__device__ __forceinline__ void mma_chunk(Acc& acc, const TA* sa, const TB* sb, int steps) {
  constexpr bool kAlo = sizeof(TA) == sizeof(float), kBlo = sizeof(TB) == sizeof(float);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = threadIdx.x >> 7, wn = (threadIdx.x >> 5) & 3;
  for (int s = 0; s < steps; ++s) {
    const int k = 8 * s + 2 * t;
    float ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int r = (wm * kMT + mi) * 16 + g;
      const float2 u = pair<AK>(sa, r, k), v = pair<AK>(sa, r + 8, k);
      split<kAlo>(u.x, ah[mi][0], al[mi][0]);
      split<kAlo>(v.x, ah[mi][1], al[mi][1]);
      split<kAlo>(u.y, ah[mi][2], al[mi][2]);
      split<kAlo>(v.y, ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) {
      const float2 u = pair<BK>(sb, (wn * kNT + nj) * 8 + g, k);
      split<kBlo>(u.x, bh[nj][0], bl[nj][0]);
      split<kBlo>(u.y, bh[nj][1], bl[nj][1]);
    }
    if (kAlo) mma_term(acc, al, bh);
    if (kBlo) mma_term(acc, ah, bl);
    mma_term(acc, ah, bh);
  }
}

// D's tile blockIdx.x (column tiles fastest) over the depth chunk blockIdx.y, [z len,
// min(depth, (z + 1) len)); then epi(z, r, n, v0, v1) for each pair of
// columns (n, n + 1) of a row r < a.rows, n < b.rows (n + 1 may be b.rows:
// epi masks it); a_sums (chunks, a.rows): the chunk's sums over the depth of
// A's rows, written by the blocks of column tile 0.  Owner is the number of
// the kernel that launches it (K1, K2, K6, K7, K9), so a profile tells their products apart.
template <int Owner, typename TA, bool AK, typename TB, bool BK, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
tc_gemm_kernel(Operand<TA, AK> a, Operand<TB, BK> b, int depth, int len, Epi epi, float* __restrict__ a_sums) {
  extern __shared__ __align__(16) float smem[];
  const int ntiles = (b.rows + kBN - 1) / kBN, tn = blockIdx.x % ntiles;
  const int r0 = (blockIdx.x / ntiles) * kBM, n0 = tn * kBN, z = blockIdx.y;
  const int kbeg = z * len, kend = min(depth, kbeg + len), chunks = (kend - kbeg + kKC - 1) / kKC;
  const bool sums = a_sums != nullptr && tn == 0;
  auto sa = [&](int c) { return reinterpret_cast<TA*>(smem + (c % kStages) * 2 * kStage); };
  auto sb = [&](int c) { return reinterpret_cast<TB*>(smem + (c % kStages) * 2 * kStage + kStage); };
  auto fill = [&](int c) {
    if (c < chunks) {
      const int k0 = kbeg + c * kKC, k1 = min(kend, k0 + kKC);
      stage(a, sa(c), r0, k0, k1);
      stage(b, sb(c), n0, k0, k1);
    }
    cp_async_commit();
  };
  float asum = 0.f;
  Acc acc, part;  // the sum so far, and the chunk's
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  for (int c = 0; c < kStages - 1; ++c) fill(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1, whose stage fill takes next
    fill(c + kStages - 1);
    if (sums && threadIdx.x < kBM) {  // in depth order
      const TA* buf = sa(c);
      for (int k = 0; k < kKC; ++k) asum += ld(AK ? buf[threadIdx.x * kKLD + k] : buf[k * kRLD + threadIdx.x]);
    }
    // the MMAs sum a chunk from zero, then one rounded add takes it into acc: a sum's
    // MMAs round toward zero, and over a long depth (131 k tokens) their errors would
    // add up in one direction
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
    mma_chunk<TA, AK, TB, BK>(part, sa(c), sb(c), (min(kKC, kend - kbeg - c * kKC) + 7) / 8);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
  }
  if (sums && threadIdx.x < kBM && r0 + threadIdx.x < a.rows) a_sums[(size_t)z * a.rows + r0 + threadIdx.x] = asum;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = threadIdx.x >> 7, wn = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) {
      const int r = r0 + (wm * kMT + mi) * 16 + g, n = n0 + (wn * kNT + nj) * 8 + 2 * t;
      if (n >= b.rows) continue;
      if (r < a.rows) epi(z, r, n, acc[mi][nj][0], acc[mi][nj][1]);
      if (r + 8 < a.rows) epi(z, r + 8, n, acc[mi][nj][2], acc[mi][nj][3]);
    }
}

// Depth chunks of a product cut along the depth: enough blocks to fill the
// card, each chunk a multiple of kKC.  Returns the count and sets *len.
inline int depth_chunks(int M, int N, int depth, int* len) {
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int most = (depth + kKC - 1) / kKC;
  int n = (kTargetBlocks + tiles - 1) / tiles;
  n = n < 1 ? 1 : (n > most ? most : n);
  const int l = ((depth + n - 1) / n + kKC - 1) / kKC * kKC;
  *len = l;
  return (depth + l - 1) / l;
}

// D = A . B over depth, in `chunks` chunks of len (1 and depth: the whole sum
// in each block), epi as tc_gemm_kernel's.  The kernel's shared-memory limit
// is raised once per instantiation and device (a forward at B = 1 is a few
// microseconds of work a launch, and the call costs the host about as much).
template <int Owner, typename TA, bool AK, typename TB, bool BK, class Epi>
inline cudaError_t gemm(const Operand<TA, AK>& a, const Operand<TB, BK>& b, int depth, int chunks, int len, Epi epi,
                        float* a_sums, cudaStream_t stream) {
  constexpr int bytes = kSmemFloats * sizeof(float);
  static unsigned long long raised = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(raised >> dev & 1)) {
    err = cudaFuncSetAttribute(tc_gemm_kernel<Owner, TA, AK, TB, BK, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised |= 1ull << dev;
  }
  // one grid index a tile, the column tiles of a row tile next to each other: they run side by
  // side, so A's tile comes from the L2 after its first read
  const dim3 grid(((b.rows + kBN - 1) / kBN) * ((a.rows + kBM - 1) / kBM), chunks);
  tc_gemm_kernel<Owner, TA, AK, TB, BK, Epi><<<grid, kThreads, bytes, stream>>>(a, b, depth, len, epi, a_sums);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
