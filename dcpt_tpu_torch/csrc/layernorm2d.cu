// Channel LayerNorm over (rows, C) on Hopper (sm_90a): fp32 I/O, fp32 math.
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

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kColBlocks = 2 * 132;  // backward column pass: blocks to aim for

__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
              float* __restrict__ out, float* __restrict__ y, float* __restrict__ rsig, int rows, int C, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    v += d * d;
  }
  const float rs = 1.f / sqrtf(warp_sum(v) / C + eps);
  float* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float yv = (xr[c] - mu) * rs;
    orow[c] = yv * w[c] + b[c];
    if (y) y[(size_t)row * C + c] = yv;
  }
  if (rsig && lane == 0) rsig[row] = rs;
}

__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const float* __restrict__ g, const float* __restrict__ y, const float* __restrict__ rsig,
                   const float* __restrict__ w, float* __restrict__ gx, int rows, int C) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* gr = g + (size_t)row * C;
  const float* yr = y + (size_t)row * C;
  float s_gy = 0.f, s_g = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float gw = gr[c] * w[c];
    s_gy = fmaf(gw, yr[c], s_gy);
    s_g += gw;
  }
  const float mean_gy = warp_sum(s_gy) / C, mean_g = warp_sum(s_g) / C;
  const float rs = rsig[row];
  float* out = gx + (size_t)row * C;
  for (int c = lane; c < C; c += 32) out[c] = rs * (gr[c] * w[c] - yr[c] * mean_gy - mean_g);
}

// part (chunks, 2C): the chunk's column sums of g*y, then of g.  grid (ceil(C / kThreads), chunks)
__global__ void __launch_bounds__(kThreads)
ln_bwd_cols_kernel(const float* __restrict__ g, const float* __restrict__ y, float* __restrict__ part, int rows,
                   int C, int len) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * len, r1 = min(rows, r0 + len);
  float sw = 0.f, sb = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float gv = g[(size_t)r * C + c];
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

size_t bwd_workspace(int rows, int C) {
  int len;
  const int n = col_chunks(rows, C, &len);
  return (size_t)n * 2 * C + colsum_scratch(1, n, C);
}

}  // namespace

// Plain C entry points (loaded with ctypes); every pointer is a device pointer
// to fp32, x and out (rows, C), w and b (C).  y (rows, C) and rsig (rows) are
// written when not null.  Each returns the first CUDA error, or 0.
extern "C" int ln_fwd_f32(const void* x, const void* w, const void* b, void* out, void* y, void* rsig, int rows,
                          int C, float eps, void* stream) {
  ln_fwd_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<float*>(y), static_cast<float*>(rsig), rows, C, eps);
  return cudaGetLastError();
}

// gx (rows, C), gw and gb (C) from g (rows, C) and the forward's y and rsig;
// ws holds ln_bwd_workspace_floats(rows, C) floats.
extern "C" int ln_bwd_f32(const void* g_, const void* y_, const void* rsig, const void* w, void* gx, void* gw,
                          void* gb, void* ws_, int rows, int C, void* stream_) {
  const float* g = static_cast<const float*>(g_);
  const float* y = static_cast<const float*>(y_);
  float* ws = static_cast<float*>(ws_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  ln_bwd_rows_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
      g, y, static_cast<const float*>(rsig), static_cast<const float*>(w), static_cast<float*>(gx), rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int len;
  const int n = col_chunks(rows, C, &len);
  ln_bwd_cols_kernel<<<dim3((C + kThreads - 1) / kThreads, n), kThreads, 0, stream>>>(g, y, ws, rows, C, len);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* scratch = ws + (size_t)n * 2 * C;
  if ((err = colsum<3>(ws, 1, n, C, 2 * C, static_cast<float*>(gw), scratch, stream)) != cudaSuccess) return err;
  return colsum<3>(ws + C, 1, n, C, 2 * C, static_cast<float*>(gb), scratch, stream);
}

extern "C" long long ln_bwd_workspace_floats(int rows, int C) { return (long long)bwd_workspace(rows, C); }
