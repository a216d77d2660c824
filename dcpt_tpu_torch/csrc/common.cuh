// Helpers shared by the port's CUDA sources: loads and stores in the I/O type,
// a warp sum, a depthwise 3x3 stencil, and a deterministic column sum over rows
// (no atomics, so a sum over pixels comes out the same bit for bit from run to run).
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
// in row order; a row of in is ld floats apart, a row of out Cn.  Owner is the
// number of the kernel that calls it (K2, K3, K6, K7), so a profile tells their sums apart.
template <int Owner>
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ in, int R, int Cn, int ld, float* __restrict__ out) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= Cn) return;
  const int r0 = blockIdx.y * kSumRows, n = min(kSumRows, R - r0);
  const float* src = in + ((size_t)blockIdx.z * R + r0) * ld + c;
  float s = 0.f;
#pragma unroll 8
  for (int r = 0; r < n; ++r) s += src[(size_t)r * ld];
  out[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * Cn + c] = s;
}

// Floats of scratch that colsum needs for (batches, R, Cn).
inline size_t colsum_scratch(int batches, int R, int Cn) {
  return R <= kSumRows ? 0 : 2 * (size_t)batches * ((R + kSumRows - 1) / kSumRows) * Cn;
}

// out (batches, Cn) = sum over R of in (batches, R, ld), in passes of kSumRows-row
// sums in a fixed order; scratch holds colsum_scratch(batches, R, Cn) floats.
template <int Owner>
inline cudaError_t colsum(const float* in, int batches, int R, int Cn, int ld, float* out, float* scratch,
                          cudaStream_t stream) {
  float* bufs[2] = {scratch, scratch + (size_t)batches * ((R + kSumRows - 1) / kSumRows) * Cn};
  for (int which = 0;; which ^= 1) {
    const int rout = (R + kSumRows - 1) / kSumRows;
    float* dst = rout == 1 ? out : bufs[which];
    colsum_kernel<Owner><<<dim3((Cn + kThreads - 1) / kThreads, rout, batches), kThreads, 0, stream>>>(in, R, Cn, ld, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || rout == 1) return err;
    in = dst;
    R = rout;
    ld = Cn;
  }
}

}  // namespace
