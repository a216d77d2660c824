// MDTA's transposed (channel) attention on Hopper (sm_90a): SIMT fp32 math,
// fp32 or bf16 I/O.
//
// Replaces the TPU kernels of dcpt_tpu/ops/mdta.py::mdta_attention: _kernel
// (pallas_call :62), and the L-tiled pair _gram_kernel (:116) and _pv_kernel
// (:138).  Per (batch * head) bh, with q, k, v (BH, c, L) channels-first
// (L contiguous) and temperature t (BH):
//
//   attn = act(q k^T * rsqrt(max(|q|^2, 1e-24)) rsqrt(max(|k|^2, 1e-24))^T * t)
//   out  = attn . v                     (attn cast to v's dtype first)
//
// act is ReLU or a row softmax; the norms run over L, so the normalisation
// folds into the c x c Gram and no normalised copy of q or k is written.
//
//   pass 1  mdta_gram_kernel, grid (BH * chunks, c/64 row tiles, c/64 column
//           tiles): the raw Gram partial of one chunk of pixels and, in the
//           first row / column tile, |q|^2 and |k|^2 over it, into a
//           workspace (BH, chunks, c^2 + 2c); common.cuh's colsum then adds
//           the chunks in chunk order (no atomics: the same bits every run)
//   attn    mdta_attn_kernel, one block per bh: scale, temperature, ReLU or
//           a softmax over each row (one warp a row), rounded to v's dtype
//   pass 2  mdta_av_kernel, grid (L / 64 column tiles, c/64 row tiles, BH):
//           out[:, tile] = attn . v[:, tile], gemm.cuh's gemm_masked with v
//           read as a (c, L) row-major weight
//
// The layout is channels-first per head, unlike K6's channels-last Gram
// (gemm.cuh's head_tile_product), so pass 1 has its own loader: lanes run
// along the pixels of each channel row, which are contiguous.
//
// Where it departs from the TPU kernel: dcpt_tpu drops to the jnp reference
// when L % 128 != 0 and picks its single-shot or tiled kernel by VMEM size;
// every L and every head width c is taken here (the shipped nets have c = 40
// ... 176; Restormer 48, and 96 at the level-1 decoder and refinement), the
// chunk length chosen from the shape alone so that a shape gives the same bits
// every run.  The backward is the VJP of the plain version, as dcpt_tpu's
// custom VJP differentiates mdta_ref (ops/mdta.py).
//
// What bounds it on this card: 4 c^2 L flops per bh (the Gram and attn . v)
// against 4 c L itemsize bytes (q, k, v read and out written once): c flops a
// byte in fp32 (48 at Restormer's heads), so operations against the 67
// TFLOP/s SIMT fp32 peak; run here from shared memory on the SIMT pipes.

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kTile = 64;  // rows and columns of a Gram tile, rows of an attn . v tile

__device__ __forceinline__ float warp_max(float v) {
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Pixels of one Gram partial: at most 128 chunks of a multiple of 32 pixels,
// fewer when BH alone fills the card (a function of the shape only).
inline int chunk_len(int BH, int L) {
  int want = (512 + BH - 1) / BH;
  want = want < 1 ? 1 : (want > 128 ? 128 : want);
  int len = (L + want - 1) / want;
  len = (len + kKC - 1) / kKC * kKC;
  return len < kKC ? kKC : len;
}

// part[(bh * chunks + chunk)][i * c + j] = sum over the chunk's pixels of q[bh][i][l] k[bh][j][l],
// then |q_i|^2 at c^2 + i (column tile 0) and |k_j|^2 at c^2 + c + j (row tile 0)
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_gram_kernel(const T* __restrict__ q, const T* __restrict__ k, float* __restrict__ part, int c, int L,
                 int chunks, int len) {
  extern __shared__ float smem[];
  float* sA = smem;  // kKC pixels x kTile q rows, row stride kWS
  float* sB = sA + kKC * kWS;
  const int bh = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.z * kTile;
  const int l0 = chunk * len, l1 = min(L, l0 + len);
  const T* qb = q + (size_t)bh * c * L;
  const T* kb = k + (size_t)bh * c * L;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  float norm = 0.f;  // threads < kTile: |q_{i0 + t}|^2; threads in [kTile, 2 kTile): |k_{j0 + t - kTile}|^2
  for (int lb = l0; lb < l1; lb += kKC) {
    __syncthreads();
    // lanes along the pixels of a channel row: coalesced
    for (int idx = threadIdx.x; idx < kTile * kKC; idx += kThreads) {
      const int row = idx / kKC, kk = idx % kKC, l = lb + kk;
      const bool in = l < l1;
      sA[kk * kWS + row] = in && i0 + row < c ? ld(qb[(size_t)(i0 + row) * L + l]) : 0.f;
      sB[kk * kWS + row] = in && j0 + row < c ? ld(kb[(size_t)(j0 + row) * L + l]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = sA[kk * kWS + ty + 16 * r];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = sB[kk * kWS + tx + 16 * i];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(av[r], bv[i], acc[r][i]);
    }
    if (threadIdx.x < 2 * kTile) {
      const float* col = threadIdx.x < kTile ? sA + threadIdx.x : sB + threadIdx.x - kTile;
      for (int kk = 0; kk < kKC; ++kk) norm = fmaf(col[kk * kWS], col[kk * kWS], norm);
    }
  }
  const size_t stride = (size_t)c * c + 2 * c;
  float* out = part + ((size_t)bh * chunks + chunk) * stride;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * r, col = j0 + tx + 16 * i;
      if (row < c && col < c) out[(size_t)row * c + col] = acc[r][i];
    }
  if (threadIdx.x < kTile && blockIdx.z == 0 && i0 + threadIdx.x < c) out[(size_t)c * c + i0 + threadIdx.x] = norm;
  if (threadIdx.x >= kTile && threadIdx.x < 2 * kTile && blockIdx.y == 0 && j0 + threadIdx.x - kTile < c)
    out[(size_t)c * c + c + j0 + threadIdx.x - kTile] = norm;
}

// attn[bh] (c, c) from the reduced Gram and norms: one warp a row; rounded to T
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_attn_kernel(const float* __restrict__ red, const T* __restrict__ temp, float* __restrict__ attn, int c,
                 int use_softmax) {
  const int bh = blockIdx.x;
  const float* gram = red + (size_t)bh * ((size_t)c * c + 2 * c);
  const float* qn2 = gram + (size_t)c * c;
  const float* kn2 = qn2 + c;
  float* a = attn + (size_t)bh * c * c;
  const float t = ld(temp[bh]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < c; i += kThreads / 32) {
    const float rq = 1.f / sqrtf(fmaxf(qn2[i], 1e-24f));
    auto logit = [&](int j) { return gram[(size_t)i * c + j] * rq * (1.f / sqrtf(fmaxf(kn2[j], 1e-24f))) * t; };
    if (!use_softmax) {
      for (int j = lane; j < c; j += 32) a[(size_t)i * c + j] = ld(st<T>(fmaxf(logit(j), 0.f)));
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < c; j += 32) m = fmaxf(m, logit(j));
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += expf(logit(j) - m);
    s = warp_sum(s);
    for (int j = lane; j < c; j += 32) a[(size_t)i * c + j] = ld(st<T>(expf(logit(j) - m) / s));
  }
}

// out[bh][i][l] = sum over d of attn[bh][i][d] v[bh][d][l], a tile of 64 rows x 64 pixels
template <typename T>
__global__ void __launch_bounds__(kThreads)
mdta_av_kernel(const float* __restrict__ attn, const T* __restrict__ v, T* __restrict__ out, int c, int L) {
  extern __shared__ float smem[];
  const int n0 = blockIdx.x * kNB, i0 = blockIdx.y * kTile, bh = blockIdx.z;
  const float* a = attn + (size_t)bh * c * c;
  const T* vb = v + (size_t)bh * c * L;
  float acc[4][4];
  gemm_masked<4, true>(smem, vb, L, L, n0, 0, c, [&](int p, int d) {
    return i0 + p < c ? a[(size_t)(i0 + p) * c + d] : 0.f;
  }, acc);
  T* ob = out + (size_t)bh * c * L;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * r, l = n0 + tx + 16 * i;
      if (row < c && l < L) ob[(size_t)row * L + l] = st<T>(acc[r][i]);
    }
}

struct Workspace {
  float* part;   // (BH, chunks, c^2 + 2c) partials
  float* red;    // (BH, c^2 + 2c) their sums
  float* attn;   // (BH, c, c)
  float* scratch;
};

inline Workspace carve(float* ws, int BH, int c, int L) {
  const int chunks = (L + chunk_len(BH, L) - 1) / chunk_len(BH, L);
  const size_t cn = (size_t)c * c + 2 * c;
  Workspace w;
  w.part = ws;
  w.red = w.part + (size_t)BH * chunks * cn;
  w.attn = w.red + (size_t)BH * cn;
  w.scratch = w.attn + (size_t)BH * c * c;
  return w;
}

template <typename T>
int mdta(const void* q, const void* k, const void* v, const void* temp, void* out, void* workspace, int BH, int c,
         int L, int use_softmax, void* stream) {
  if (BH == 0 || c == 0 || L == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int len = chunk_len(BH, L), chunks = (L + len - 1) / len;
  const int tiles = (c + kTile - 1) / kTile;
  const int cn = c * c + 2 * c;
  Workspace w = carve(static_cast<float*>(workspace), BH, c, L);
  mdta_gram_kernel<T><<<dim3(BH * chunks, tiles, tiles), kThreads, 2 * kKC * kWS * sizeof(float), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), w.part, c, L, chunks, len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = colsum<13>(w.part, BH, chunks, cn, cn, w.red, w.scratch, s)) != cudaSuccess) return err;
  mdta_attn_kernel<T><<<BH, kThreads, 0, s>>>(w.red, static_cast<const T*>(temp), w.attn, c, use_softmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = (kKC * (16 * 4 + 1) + 2 * kWChunk) * sizeof(float);  // gemm_smem_floats(4)
  mdta_av_kernel<T><<<dim3((L + kNB - 1) / kNB, tiles, BH), kThreads, smem, s>>>(
      w.attn, static_cast<const T*>(v), static_cast<T*>(out), c, L);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers: q, k, v and out
// (BH, c, L) contiguous, temp (BH), all in the I/O type; workspace of
// mdta_workspace_floats(BH, c, L) floats.  Returns cudaGetLastError().
#define MDTA_ARGS const void *q, const void *k, const void *v, const void *temp, void *out, void *workspace, int BH, \
                  int c, int L, int use_softmax, void *stream
#define MDTA_PASS q, k, v, temp, out, workspace, BH, c, L, use_softmax, stream

extern "C" int mdta_f32(MDTA_ARGS) { return mdta<float>(MDTA_PASS); }
extern "C" int mdta_bf16(MDTA_ARGS) { return mdta<__nv_bfloat16>(MDTA_PASS); }

extern "C" long long mdta_workspace_floats(int BH, int c, int L) {
  const int chunks = (L + chunk_len(BH, L) - 1) / chunk_len(BH, L);
  const long long cn = (long long)c * c + 2 * c;
  return (long long)BH * chunks * cn + (long long)BH * cn + (long long)BH * c * c +
         (long long)colsum_scratch(BH, chunks, (int)cn);
}
