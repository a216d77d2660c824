// Channel LayerNorm over (rows, C) on Hopper (sm_90a): fp32 or bf16 I/O, fp32 math.
//
// Replaces the TPU kernel dcpt_tpu/ops/layernorm2d.py::layer_norm_2d
// (_fwd_kernel_primal, _fwd_kernel, _bwd_kernel), itself the reference's
// layernorm op: out = y * w + b with y = (x - mean) / sqrt(var + eps), the
// biased variance over the C channels of a row.
//
//   forward   one warp per row: mean and variance in fp32 (two passes over the
//             row, which stays in L1), then out; y and 1/sigma only when a
//             gradient is needed (the primal call writes out alone).
//   backward  one warp per row: gx = rs * (g*w - y * mean(g*w*y) - mean(g*w));
//             gw = sum_rows g*y and gb = sum_rows g as partial column sums over
//             row chunks, added by colsum in a fixed order (deterministic, no
//             atomics).
//
// What bounds it on this card: bytes.  A few flops per element against 8 bytes
// read and written (forward, 16 with y; backward 12 plus the column pass), so
// the ceiling is device-memory bandwidth; rows of 512 or 1024 channels keep a
// warp's loads coalesced and every row's sums in registers.  The function
// itself needs 20 bytes per element over forward and backward (x, out, g, x,
// gx); the y residual, kept as the TPU kernel keeps it, adds 8.
//
// In bf16 (mixed-precision training) x, w, b, out, g and gx are bf16; the
// statistics, y and 1/sigma are fp32 (the TPU kernel writes y in x's dtype;
// fp32 here keeps the backward's rounding at the forward's), the column
// partials are fp32 and summed by colsum as in fp32, and gw and gb are cast
// to bf16 once, at the end.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kColBlocks = 2 * 132;  // backward column pass: blocks to aim for

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
              T* __restrict__ out, float* __restrict__ y, float* __restrict__ rsig, int rows, int C, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += ld(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = ld(xr[c]) - mu;
    v += d * d;
  }
  const float rs = 1.f / sqrtf(warp_sum(v) / C + eps);
  T* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float yv = (ld(xr[c]) - mu) * rs;
    orow[c] = st<T>(yv * ld(w[c]) + ld(b[c]));
    if (y) y[(size_t)row * C + c] = yv;
  }
  if (rsig && lane == 0) rsig[row] = rs;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const T* __restrict__ g, const float* __restrict__ y, const float* __restrict__ rsig,
                   const T* __restrict__ w, T* __restrict__ gx, int rows, int C) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* gr = g + (size_t)row * C;
  const float* yr = y + (size_t)row * C;
  float s_gy = 0.f, s_g = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float gw = ld(gr[c]) * ld(w[c]);
    s_gy = fmaf(gw, yr[c], s_gy);
    s_g += gw;
  }
  const float mean_gy = warp_sum(s_gy) / C, mean_g = warp_sum(s_g) / C;
  const float rs = rsig[row];
  T* out = gx + (size_t)row * C;
  for (int c = lane; c < C; c += 32) out[c] = st<T>(rs * (ld(gr[c]) * ld(w[c]) - yr[c] * mean_gy - mean_g));
}

// part (chunks, 2C): the chunk's column sums of g*y, then of g.  grid (ceil(C / kThreads), chunks)
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_cols_kernel(const T* __restrict__ g, const float* __restrict__ y, float* __restrict__ part, int rows,
                   int C, int len) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * len, r1 = min(rows, r0 + len);
  float sw = 0.f, sb = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float gv = ld(g[(size_t)r * C + c]);
    sw = fmaf(gv, y[(size_t)r * C + c], sw);
    sb += gv;
  }
  part[(size_t)blockIdx.y * 2 * C + c] = sw;
  part[(size_t)blockIdx.y * 2 * C + C + c] = sb;
}

// Row chunks of the column pass, and the workspace: partials then colsum's scratch.
int col_chunks(int rows, int C, int* len) {
  const int cblocks = (C + kThreads - 1) / kThreads;
  int n = (kColBlocks + cblocks - 1) / cblocks;
  n = n < 1 ? 1 : (n > rows ? rows : n);
  *len = (rows + n - 1) / n;
  return (rows + *len - 1) / *len;
}

// partials (n, 2C), colsum's scratch, then gw and gb in fp32 (2C) for a bf16 call
size_t bwd_workspace(int rows, int C) {
  int len;
  const int n = col_chunks(rows, C, &len);
  return (size_t)n * 2 * C + colsum_scratch(1, n, C) + 2 * (size_t)C;
}

template <typename T>
int ln_fwd(const void* x, const void* w, const void* b, void* out, void* y, void* rsig, int rows, int C, float eps,
           void* stream) {
  ln_fwd_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out),
      static_cast<float*>(y), static_cast<float*>(rsig), rows, C, eps);
  return cudaGetLastError();
}

template <typename T>
int ln_bwd(const void* g_, const void* y_, const void* rsig, const void* w, void* gx, void* gw, void* gb, void* ws_,
           int rows, int C, void* stream_) {
  const T* g = static_cast<const T*>(g_);
  const float* y = static_cast<const float*>(y_);
  float* ws = static_cast<float*>(ws_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  ln_bwd_rows_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
      g, y, static_cast<const float*>(rsig), static_cast<const T*>(w), static_cast<T*>(gx), rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int len;
  const int n = col_chunks(rows, C, &len);
  ln_bwd_cols_kernel<T><<<dim3((C + kThreads - 1) / kThreads, n), kThreads, 0, stream>>>(g, y, ws, rows, C, len);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* scratch = ws + (size_t)n * 2 * C;
  // fp32 I/O sums straight into gw and gb; bf16 into fp32 buffers, cast once below
  const bool f32 = sizeof(T) == sizeof(float);
  float* sums = scratch + colsum_scratch(1, n, C);
  float* gw32 = f32 ? static_cast<float*>(gw) : sums;
  float* gb32 = f32 ? static_cast<float*>(gb) : sums + C;
  if ((err = colsum<3>(ws, 1, n, C, 2 * C, gw32, scratch, stream)) != cudaSuccess) return err;
  if ((err = colsum<3>(ws + C, 1, n, C, 2 * C, gb32, scratch, stream)) != cudaSuccess || f32) return err;
  CastList<T> casts;
  casts.add(gw32, static_cast<T*>(gw), C);
  casts.add(gb32, static_cast<T*>(gb), C);
  return cast_all(casts, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes); every pointer is a device pointer.
// x and out (rows, C), w and b (C) in the I/O type (f32: float, bf16:
// bfloat16); y (rows, C) and rsig (rows) fp32, written when not null.  Each
// returns the first CUDA error, or 0.
#define LN_FWD_ARGS \
  const void *x, const void *w, const void *b, void *out, void *y, void *rsig, int rows, int C, float eps, void *stream
extern "C" int ln_fwd_f32(LN_FWD_ARGS) { return ln_fwd<float>(x, w, b, out, y, rsig, rows, C, eps, stream); }
extern "C" int ln_fwd_bf16(LN_FWD_ARGS) { return ln_fwd<__nv_bfloat16>(x, w, b, out, y, rsig, rows, C, eps, stream); }

// gx (rows, C), gw and gb (C) in the I/O type from g (rows, C) in the I/O type
// and the forward's fp32 y and rsig; ws holds ln_bwd_workspace_floats(rows, C) floats.
#define LN_BWD_ARGS                                                                                         \
  const void *g, const void *y, const void *rsig, const void *w, void *gx, void *gw, void *gb, void *ws, int rows, \
      int C, void *stream
extern "C" int ln_bwd_f32(LN_BWD_ARGS) { return ln_bwd<float>(g, y, rsig, w, gx, gw, gb, ws, rows, C, stream); }
extern "C" int ln_bwd_bf16(LN_BWD_ARGS) {
  return ln_bwd<__nv_bfloat16>(g, y, rsig, w, gx, gw, gb, ws, rows, C, stream);
}

extern "C" long long ln_bwd_workspace_floats(int rows, int C) { return (long long)bwd_workspace(rows, C); }
