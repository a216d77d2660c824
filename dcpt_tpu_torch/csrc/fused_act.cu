// Fused bias + LeakyReLU + scale (StyleGAN2's fused_act), forward and
// backward, on Hopper (sm_90a): fp32 or bf16 I/O.
//
// Replaces the TPU kernels of dcpt_tpu/ops/fused_act.py::fused_bias_leaky_relu:
// _fwd_kernel (pallas_call :42) and _bwd_kernel (pallas_call :64).  Over a
// channels-last (rows, C) view with the bias (C,):
//
//   forward   v = x + b;  mask = v > 0 (int8);  out = (mask ? v : v slope) scale
//   backward  gx = (mask ? g : g slope) scale
//
// The mask is strict, so at x + b == 0 the gradient is slope * scale, as in
// the TPU kernel.  The bias gradient (the sum of gx over rows) is left to the
// caller, as dcpt_tpu leaves it to XLA (fused_act.py:89-94).  Each value is
// rounded to the I/O type after every operation, as the plain PyTorch
// version's elementwise ops round in bf16, so the two agree bit for bit in
// both dtypes.  Channels-last like dcpt_tpu, not the reference's NCHW
// fused_bias_act_kernel.cu.
//
// Where it departs from the TPU kernel: dcpt_tpu tiles rows by the largest
// power of two up to 1024 that divides them (one tile of every row when none
// does); here a grid-stride loop takes every row count and every C.
//
// What bounds it on this card: bytes.  Forward: x read and out written (2 n
// itemsize), the int8 mask written (n), the bias read (C itemsize).
// Backward: g read, gx written, the mask read (2 n itemsize + n).  A few
// operations an element, far below the fp32 peak.

#include "common.cuh"

namespace {

// v rounded to the I/O type, back in fp32
template <typename T>
__device__ __forceinline__ float rnd(float v) { return ld(st<T>(v)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ out,
                     int8_t* __restrict__ mask, long long n, int C, float slope, float scale) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += (long long)gridDim.x * kThreads) {
    const float v = rnd<T>(ld(x[i]) + ld(b[i % C]));
    const bool pos = v > 0.f;
    mask[i] = pos ? 1 : 0;
    out[i] = st<T>((pos ? v : rnd<T>(v * slope)) * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_act_bwd_kernel(const T* __restrict__ g, const int8_t* __restrict__ mask, T* __restrict__ gx, long long n,
                     float slope, float scale) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += (long long)gridDim.x * kThreads) {
    const float v = ld(g[i]);
    gx[i] = st<T>((mask[i] > 0 ? v : rnd<T>(v * slope)) * scale);
  }
}

inline unsigned act_blocks(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

template <typename T>
int fused_act_fwd(const void* x, const void* b, void* out, void* mask, long long n, int C, float slope, float scale,
                  void* stream) {
  if (n == 0) return cudaSuccess;
  fused_act_fwd_kernel<T><<<act_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(out), static_cast<int8_t*>(mask), n, C,
      slope, scale);
  return cudaGetLastError();
}

template <typename T>
int fused_act_bwd(const void* g, const void* mask, void* gx, long long n, float slope, float scale, void* stream) {
  if (n == 0) return cudaSuccess;
  fused_act_bwd_kernel<T><<<act_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const int8_t*>(mask), static_cast<T*>(gx), n, slope, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers: x, out, g and
// gx (n elements, rows of C), b (C), all in the I/O type; mask (n) int8.
// Returns cudaGetLastError().
#define FA_FWD_ARGS const void *x, const void *b, void *out, void *mask, long long n, int C, float slope, float scale, \
                    void *stream
#define FA_BWD_ARGS const void *g, const void *mask, void *gx, long long n, float slope, float scale, void *stream

extern "C" int fused_act_fwd_f32(FA_FWD_ARGS) { return fused_act_fwd<float>(x, b, out, mask, n, C, slope, scale, stream); }
extern "C" int fused_act_fwd_bf16(FA_FWD_ARGS) {
  return fused_act_fwd<__nv_bfloat16>(x, b, out, mask, n, C, slope, scale, stream);
}
extern "C" int fused_act_bwd_f32(FA_BWD_ARGS) { return fused_act_bwd<float>(g, mask, gx, n, slope, scale, stream); }
extern "C" int fused_act_bwd_bf16(FA_BWD_ARGS) {
  return fused_act_bwd<__nv_bfloat16>(g, mask, gx, n, slope, scale, stream);
}
