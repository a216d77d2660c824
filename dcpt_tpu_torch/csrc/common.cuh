// Helpers shared by the port's CUDA sources: loads and stores in the I/O type,
// a warp sum, a depthwise 3x3 stencil, a deterministic column sum over rows
// (no atomics, so a sum over pixels comes out the same bit for bit from run to
// run), and the cast of fp32 results into the I/O type.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumRows = 64;  // rows that one block of colsum_kernel adds

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Depthwise 3x3 (cross-correlation, as F.conv2d) of channel c of a (B, H, W, ld)
// fp32 map at pixel (b, yy, xx), zero outside the image; w (channels, 3, 3).
template <typename T>
__device__ __forceinline__ float dw3x3(const float* __restrict__ in, const T* __restrict__ w, int b, int yy, int xx,
                                       int c, int H, int W, int ld_) {
  float s = 0.f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int y = yy + dy;
    if (y < 0 || y >= H) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xq = xx + dx;
      if (xq < 0 || xq >= W) continue;
      s = fmaf(in[(((size_t)b * H + y) * W + xq) * ld_ + c], ld(w[(size_t)c * 9 + (dy + 1) * 3 + dx + 1]), s);
    }
  }
  return s;
}

// out[b][r'][c] = sum over r in [r' * kSumRows, (r' + 1) * kSumRows) of in[b][r][c],
// in row order; a row of in is lda elements apart, a row of out Cn.  Owner is the
// number of the kernel that calls it (K2, K3, K6, K7, K9), so a profile tells their sums apart.
template <int Owner, typename TI = float>
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const TI* __restrict__ in, int R, int Cn, int lda, float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= Cn) return;
  const int r0 = blockIdx.y * kSumRows, n = min(kSumRows, R - r0);
  const TI* src = in + ((size_t)blockIdx.z * R + r0) * lda + c;
  float s = 0.f;
#pragma unroll 8
  for (int r = 0; r < n; ++r) s += ld(src[(size_t)r * lda]);
  out[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * Cn + c] = s;
}

// Floats of scratch that colsum needs for (batches, R, Cn).
inline size_t colsum_scratch(int batches, int R, int Cn) {
  return R <= kSumRows ? 0 : 2 * (size_t)batches * ((R + kSumRows - 1) / kSumRows) * Cn;
}

// out (batches, Cn) = sum over R of in (batches, R, lda), in passes of kSumRows-row
// sums in a fixed order; scratch holds colsum_scratch(batches, R, Cn) floats.  in
// is fp32 or the I/O type (its first pass reads it through ld()); the passes after
// it read fp32 partials.
template <int Owner, typename TI>
inline cudaError_t colsum(const TI* in, int batches, int R, int Cn, int lda, float* out, float* scratch,
                          cudaStream_t stream) {
  float* bufs[2] = {scratch, scratch + (size_t)batches * ((R + kSumRows - 1) / kSumRows) * Cn};
  int rout = (R + kSumRows - 1) / kSumRows;
  float* dst = rout == 1 ? out : bufs[0];
  colsum_kernel<Owner, TI><<<dim3((Cn + kThreads - 1) / kThreads, rout, batches), kThreads, 0, stream>>>(in, R, Cn, lda, dst);
  for (int which = 1;; which ^= 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || rout == 1) return err;
    const float* next = dst;
    R = rout;
    rout = (R + kSumRows - 1) / kSumRows;
    dst = rout == 1 ? out : bufs[which];
    colsum_kernel<Owner><<<dim3((Cn + kThreads - 1) / kThreads, rout, batches), kThreads, 0, stream>>>(next, R, Cn, Cn, dst);
  }
}

// Up to kMaxCasts fp32 buffers cast into the I/O type in one launch: the
// backward kernels sum their weight gradients in fp32 and store each once in
// its primal's dtype.
constexpr int kMaxCasts = 20;

template <typename T>
struct CastList {
  const float* src[kMaxCasts];
  T* dst[kMaxCasts];
  long long n[kMaxCasts];
  int count = 0;
  void add(const float* s, T* d, long long len) {
    src[count] = s;
    dst[count] = d;
    n[count++] = len;
  }
};

// grid (blocks, list.count): blockIdx.y picks the buffer
template <typename T>
__global__ void __launch_bounds__(kThreads) cast_kernel(CastList<T> list) {
  const int k = blockIdx.y;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < list.n[k]; i += (long long)gridDim.x * kThreads)
    list.dst[k][i] = st<T>(list.src[k][i]);
}

template <typename T>
inline cudaError_t cast_all(const CastList<T>& list, cudaStream_t stream) {
  long long most = 1;
  for (int k = 0; k < list.count; ++k) most = list.n[k] > most ? list.n[k] : most;
  const long long blocks = (most + kThreads - 1) / kThreads;
  cast_kernel<T><<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), list.count), kThreads, 0, stream>>>(list);
  return cudaGetLastError();
}

// A backward kernel's N parameter gradients, of len[k] elements each, summed in
// fp32 at g32[k]: the caller's outputs in an fp32 call; in a bf16 call
// consecutive stretches of the fp32 staging at stage (the sum of the lengths, in
// floats), which cast() stores into the caller's outputs in one launch.
template <typename T, int N>
struct StagedGrads {
  static_assert(N <= kMaxCasts, "one CastList takes at most kMaxCasts buffers");
  static constexpr bool f32 = sizeof(T) == sizeof(float);
  float* g32[N];
  void* out[N];
  long long len[N];
  StagedGrads(void* const (&outs)[N], const long long (&lens)[N], float* stage) {
    for (int k = 0; k < N; stage += lens[k++]) {
      out[k] = outs[k];
      len[k] = lens[k];
      g32[k] = f32 ? static_cast<float*>(outs[k]) : stage;
    }
  }
  cudaError_t cast(cudaStream_t stream) const {
    if (f32) return cudaSuccess;
    CastList<T> casts;
    for (int k = 0; k < N; ++k) casts.add(g32[k], static_cast<T*>(out[k]), len[k]);
    return cast_all(casts, stream);
  }
};

}  // namespace
