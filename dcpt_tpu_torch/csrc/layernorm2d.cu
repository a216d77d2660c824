// Channel LayerNorm over (rows, C) on Hopper (sm_90a): fp32 or bf16 I/O, fp32 math.
//
// Replaces the TPU kernel dcpt_tpu/ops/layernorm2d.py::layer_norm_2d
// (_fwd_kernel_primal, _fwd_kernel, _bwd_kernel), itself the reference's
// layernorm op: out = y * w + b with y = (x - mean) / sqrt(var + eps), the
// biased variance over the C channels of a row.
//
//   forward   one pass: a row is loaded once into the registers of the
//             32 wpr threads that share it (wpr = 1 warp for C <= 512, 2 for
//             C <= 1024, up to 8), its mean and centred variance taken from
//             the registers, out written; mean and 1/sigma per row when a
//             gradient is needed (the primal call writes out alone), as
//             F.layer_norm keeps them: no y residual.
//   backward  one pass that recomputes y from x, mean and 1/sigma and writes
//             gx = rs * (g*w - y * mean(g*w*y) - mean(g*w)), each block
//             walking a fixed set of rows and keeping its column sums of g*y
//             and g in registers, added across the block's rows in shared
//             memory and written once a block; then one reduction kernel
//             adds the blocks' partials in a fixed order and stores gw and
//             gb in the I/O type.  Two launches, no atomics: the same bits
//             from run to run.
//   wide rows a row wider than a block's registers hold (C > 4096) takes a
//             block of its own and is read again by each pass: the forward
//             reads x three times (sum, centred variance, out), the backward
//             twice (the row sums, then gx), each thread adding its own
//             columns of the block's partials in device memory, row by row.
//             The same launches, the same reduction, any C.
//
// What bounds it on this card: bytes.  A few flops per element against the
// bytes the function needs: x read and out written (forward), x and g read
// and gx written (backward), 5 elements of the I/O type an element (20 bytes
// in fp32, 10 in bf16); the per-row statistics and the column partials add
// under 1 %.  Every load and store moves 16 bytes a thread (4 fp32 or 8 bf16
// elements) when C is a multiple of that and the rows are aligned; any other
// C takes 1-element units in the same kernels.
//
// In bf16 (mixed-precision training) x, w, b, out, g and gx are bf16; the
// statistics, the column partials and every sum are fp32, and gw and gb are
// cast to bf16 once, by the reduction.

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kLaneFloats = 16;       // elements of a row a thread holds: C <= 512 wpr
constexpr int kMaxRowWarps = 8;       // warps a row at most (a block)
constexpr int kRowCap = 32 * kMaxRowWarps * kLaneFloats;  // widest row in the registers: 4096
constexpr int kBwdBlocks = 2 * 132;   // backward blocks to aim for: two an SM
constexpr int kSumCols = 32;          // reduction: columns of a block (a warp wide)
constexpr int kSumSlices = kThreads / kSumCols;

// VEC elements of the I/O type moved as one load or store (16 bytes when VEC = 16 / sizeof(T))
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Unit {
  T v[VEC];
};

// Warps a row: a power of two, so that a block holds whole rows.
int row_warps(int C) {
  int wpr = 1;
  while (wpr < kMaxRowWarps && 32 * wpr * kLaneFloats < C) wpr *= 2;
  return wpr;
}

// A row's place in the block: thread q of the row's 32 wpr threads (nq) holds
// units q, q + nq, ... (kLaneFloats / VEC of them at most) of VEC elements.
struct RowPlace {
  int nq, q, group, groups;
  __device__ RowPlace(int wpr)
      : nq(32 * wpr), q(threadIdx.x % (32 * wpr)), group(threadIdx.x / (32 * wpr)), groups(kThreads / (32 * wpr)) {}
};

// v[e] = element u VEC + e of src
template <typename T, int VEC>
__device__ __forceinline__ void load_unit(const T* __restrict__ src, int u, float* v) {
  const Unit<T, VEC> d = reinterpret_cast<const Unit<T, VEC>*>(src)[u];
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = ld(d.v[e]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_unit(T* __restrict__ dst, int u, const float* v) {
  Unit<T, VEC> d;
#pragma unroll
  for (int e = 0; e < VEC; ++e) d.v[e] = st<T>(v[e]);
  reinterpret_cast<Unit<T, VEC>*>(dst)[u] = d;
}

// v[i VEC + e] = element (q + i nq) VEC + e of src, zero past `units` units
template <typename T, int VEC>
__device__ __forceinline__ void load_units(const T* __restrict__ src, const RowPlace& rp, int units,
                                           float (&v)[kLaneFloats]) {
#pragma unroll
  for (int i = 0; i < kLaneFloats / VEC; ++i) {
    const int u = rp.q + i * rp.nq;
    if (u < units) {
      load_unit<T, VEC>(src, u, v + i * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i * VEC + e] = 0.f;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_units(T* __restrict__ dst, const RowPlace& rp, int units,
                                            const float (&v)[kLaneFloats]) {
#pragma unroll
  for (int i = 0; i < kLaneFloats / VEC; ++i) {
    const int u = rp.q + i * rp.nq;
    if (u < units) store_unit<T, VEC>(dst, u, v + i * VEC);
  }
}

// a and b summed over the row's threads: each warp's shuffle tree, then the
// row's warps in order through red (2 floats a warp).  Every thread of the
// block calls it; every thread of a row ends with the same bits.
__device__ __forceinline__ void row_sum2(float& a, float& b, float* red, int wpr) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5, first = warp / wpr * wpr;
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  a = b = 0.f;
  for (int k = first; k < first + wpr; ++k) {
    a += red[2 * k];
    b += red[2 * k + 1];
  }
  __syncthreads();
}

// grid: ceil(rows / groups) blocks; shared memory 2 floats a warp
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ln2d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ out,
              float* __restrict__ mean, float* __restrict__ rsig, int rows, int C, int wpr, float eps) {
  extern __shared__ float smem[];
  const RowPlace rp(wpr);
  const int row = blockIdx.x * rp.groups + rp.group, units = C / VEC;
  const bool live = row < rows;
  float v[kLaneFloats];
  load_units<T, VEC>(x + (size_t)(live ? row : 0) * C, rp, live ? units : 0, v);
  float s = 0.f, unused = 0.f;
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) s += v[i];
  row_sum2(s, unused, smem, wpr);
  const float mu = s / C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) {
    const float d = rp.q + i / VEC * rp.nq < units ? v[i] - mu : 0.f;
    var += d * d;
  }
  unused = 0.f;
  row_sum2(var, unused, smem, wpr);
  const float rs = 1.f / sqrtf(var / C + eps);
  if (!live) return;
  float wv[kLaneFloats], bv[kLaneFloats];
  load_units<T, VEC>(w, rp, units, wv);
  load_units<T, VEC>(b, rp, units, bv);
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) v[i] = (v[i] - mu) * rs * wv[i] + bv[i];
  store_units<T, VEC>(out + (size_t)row * C, rp, units, v);
  if (mean && rp.q == 0) {
    mean[row] = mu;
    rsig[row] = rs;
  }
}

// grid: min(ceil(rows / groups), kBwdBlocks) blocks; block k takes the row
// tiles k, k + gridDim.x, ... of `groups` rows and writes its column sums of
// g*y, then of g, to part[k] (2C floats).  Shared memory: 2 floats a warp,
// then groups x 2C.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ln2d_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mean, const float* __restrict__ rsig,
              const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ gx, float* __restrict__ part,
              int rows, int C, int wpr) {
  extern __shared__ float smem[];
  float* sums = smem + 2 * (kThreads / 32);
  const RowPlace rp(wpr);
  const int units = C / VEC;
  float wv[kLaneFloats], pgy[kLaneFloats], pg[kLaneFloats];
  load_units<T, VEC>(w, rp, units, wv);
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) pgy[i] = pg[i] = 0.f;
  for (int tile = blockIdx.x; tile * rp.groups < rows; tile += gridDim.x) {
    const int row = tile * rp.groups + rp.group;
    const bool live = row < rows;
    float y[kLaneFloats], gv[kLaneFloats];
    load_units<T, VEC>(x + (size_t)(live ? row : 0) * C, rp, live ? units : 0, y);
    load_units<T, VEC>(g + (size_t)(live ? row : 0) * C, rp, live ? units : 0, gv);
    const float mu = live ? mean[row] : 0.f, rs = live ? rsig[row] : 0.f;
    float s_gy = 0.f, s_g = 0.f;
#pragma unroll
    for (int i = 0; i < kLaneFloats; ++i) {
      y[i] = (y[i] - mu) * rs;  // the forward's y, bit for bit
      const float gw = gv[i] * wv[i];
      s_gy = fmaf(gw, y[i], s_gy);
      s_g += gw;
      pgy[i] = fmaf(gv[i], y[i], pgy[i]);
      pg[i] += gv[i];
    }
    row_sum2(s_gy, s_g, smem, wpr);
    const float mean_gy = s_gy / C, mean_g = s_g / C;
#pragma unroll
    for (int i = 0; i < kLaneFloats; ++i) gv[i] = rs * (gv[i] * wv[i] - y[i] * mean_gy - mean_g);
    if (live) store_units<T, VEC>(gx + (size_t)row * C, rp, units, gv);
  }
  // the block's rows: each group's sums, then the groups added in order
  float* mine = sums + (size_t)rp.group * 2 * C;
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) {
    const int u = rp.q + i / VEC * rp.nq;
    if (u < units) {
      mine[u * VEC + i % VEC] = pgy[i];
      mine[C + u * VEC + i % VEC] = pg[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    float s = 0.f;
    for (int k = 0; k < rp.groups; ++k) s += sums[(size_t)k * 2 * C + c];
    part[(size_t)blockIdx.x * 2 * C + c] = s;
  }
}

// A row wider than kRowCap, one block a row (grid: rows); shared memory 2 floats a warp.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ln2d_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ out,
                     float* __restrict__ mean, float* __restrict__ rsig, int C, float eps) {
  extern __shared__ float smem[];
  const int units = C / VEC;
  const T* xr = x + (size_t)blockIdx.x * C;
  float v[VEC], s = 0.f, var = 0.f, unused = 0.f;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    load_unit<T, VEC>(xr, u, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += v[e];
  }
  row_sum2(s, unused, smem, kMaxRowWarps);
  const float mu = s / C;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    load_unit<T, VEC>(xr, u, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) var += (v[e] - mu) * (v[e] - mu);
  }
  unused = 0.f;
  row_sum2(var, unused, smem, kMaxRowWarps);
  const float rs = 1.f / sqrtf(var / C + eps);
  for (int u = threadIdx.x; u < units; u += kThreads) {
    float wv[VEC], bv[VEC];
    load_unit<T, VEC>(xr, u, v);
    load_unit<T, VEC>(w, u, wv);
    load_unit<T, VEC>(b, u, bv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = (v[e] - mu) * rs * wv[e] + bv[e];
    store_unit<T, VEC>(out + (size_t)blockIdx.x * C, u, v);
  }
  if (mean && threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rsig[blockIdx.x] = rs;
  }
}

// A row wider than kRowCap: grid min(rows, kBwdBlocks) blocks, block k takes
// rows k, k + gridDim.x, ... and sums g*y, then g, into part[k] (2C floats),
// each thread its own columns, in row order.  Shared memory 2 floats a warp.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ln2d_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ mean, const float* __restrict__ rsig,
                     const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ gx, float* __restrict__ part,
                     int rows, int C) {
  extern __shared__ float smem[];
  const int units = C / VEC;
  float* pgy = part + (size_t)blockIdx.x * 2 * C;
  float* pg = pgy + C;
  for (int c = threadIdx.x * VEC; c < units * VEC; c += kThreads * VEC)
#pragma unroll
    for (int e = 0; e < VEC; ++e) pgy[c + e] = pg[c + e] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T *xr = x + (size_t)row * C, *gr = g + (size_t)row * C;
    const float mu = mean[row], rs = rsig[row];
    float xv[VEC], gv[VEC], wv[VEC], s_gy = 0.f, s_g = 0.f;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      load_unit<T, VEC>(xr, u, xv);
      load_unit<T, VEC>(gr, u, gv);
      load_unit<T, VEC>(w, u, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float gw = gv[e] * wv[e];
        s_gy = fmaf(gw, (xv[e] - mu) * rs, s_gy);
        s_g += gw;
      }
    }
    row_sum2(s_gy, s_g, smem, kMaxRowWarps);
    const float mean_gy = s_gy / C, mean_g = s_g / C;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      load_unit<T, VEC>(xr, u, xv);
      load_unit<T, VEC>(gr, u, gv);
      load_unit<T, VEC>(w, u, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float y = (xv[e] - mu) * rs;
        const int c = u * VEC + e;
        pgy[c] = fmaf(gv[e], y, pgy[c]);
        pg[c] += gv[e];
        xv[e] = rs * (gv[e] * wv[e] - y * mean_gy - mean_g);
      }
      store_unit<T, VEC>(gx + (size_t)row * C, u, xv);
    }
  }
}

// gw = the first C and gb = the last C of the sums over n blocks' partials
// (n, 2C), in the I/O type: a block takes kSumCols columns, its warps every
// kSumSlices-th partial, then the slices are added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln2d_sum_kernel(const float* __restrict__ part, int n, int C, T* __restrict__ gw, T* __restrict__ gb) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kSumCols, slice = threadIdx.x / kSumCols, c = blockIdx.x * kSumCols + lane;
  float s = 0.f;
  if (c < 2 * C)
    for (int r = slice; r < n; r += kSumSlices) s += part[(size_t)r * 2 * C + c];
  smem[slice * kSumCols + lane] = s;
  __syncthreads();
  if (slice != 0 || c >= 2 * C) return;
  float t = 0.f;
  for (int k = 0; k < kSumSlices; ++k) t += smem[k * kSumCols + lane];
  if (c < C)
    gw[c] = st<T>(t);
  else
    gb[c - C] = st<T>(t);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte units when C and every row pointer allow them
template <typename T>
bool wide_units(int C, std::initializer_list<const void*> ptrs) {
  if (C % (16 / sizeof(T))) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

int bwd_blocks(int rows, int C) {
  const int groups = kThreads / (32 * row_warps(C)), tiles = (rows + groups - 1) / groups;
  return tiles < kBwdBlocks ? tiles : kBwdBlocks;
}

constexpr size_t kRedBytes = 2 * (kThreads / 32) * sizeof(float);  // row_sum2's shared memory

template <typename T, int VEC>
cudaError_t launch_fwd(const T* x, const T* w, const T* b, T* out, float* mean, float* rsig, int rows, int C,
                       float eps, cudaStream_t stream) {
  if (C > kRowCap) {
    ln2d_fwd_wide_kernel<T, VEC><<<rows, kThreads, kRedBytes, stream>>>(x, w, b, out, mean, rsig, C, eps);
  } else {
    const int wpr = row_warps(C), groups = kThreads / (32 * wpr);
    ln2d_fwd_kernel<T, VEC><<<(rows + groups - 1) / groups, kThreads, kRedBytes, stream>>>(x, w, b, out, mean, rsig,
                                                                                         rows, C, wpr, eps);
  }
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const T* x, const float* mean, const float* rsig, const T* g, const T* w, T* gx, float* part,
                       int rows, int C, cudaStream_t stream) {
  if (C > kRowCap) {
    ln2d_bwd_wide_kernel<T, VEC><<<bwd_blocks(rows, C), kThreads, kRedBytes, stream>>>(x, mean, rsig, g, w, gx, part,
                                                                                      rows, C);
  } else {
    const int wpr = row_warps(C), groups = kThreads / (32 * wpr);
    const size_t smem = kRedBytes + (size_t)groups * 2 * C * sizeof(float);
    ln2d_bwd_kernel<T, VEC><<<bwd_blocks(rows, C), kThreads, smem, stream>>>(x, mean, rsig, g, w, gx, part, rows, C,
                                                                           wpr);
  }
  return cudaGetLastError();
}

template <typename T>
int ln_fwd(const void* x_, const void* w_, const void* b_, void* out_, void* mean, void* rsig, int rows, int C,
           float eps, void* stream_) {
  if (C < 1 || rows < 1) return cudaErrorInvalidValue;
  const T *x = static_cast<const T*>(x_), *w = static_cast<const T*>(w_), *b = static_cast<const T*>(b_);
  T* out = static_cast<T*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  float *mu = static_cast<float*>(mean), *rs = static_cast<float*>(rsig);
  if (wide_units<T>(C, {x, w, b, out})) return launch_fwd<T, 16 / sizeof(T)>(x, w, b, out, mu, rs, rows, C, eps, stream);
  return launch_fwd<T, 1>(x, w, b, out, mu, rs, rows, C, eps, stream);
}

template <typename T>
int ln_bwd(const void* x_, const void* mean_, const void* rsig_, const void* g_, const void* w_, void* gx_,
           void* gw, void* gb, void* ws, int rows, int C, void* stream_) {
  if (C < 1 || rows < 1) return cudaErrorInvalidValue;
  const T *x = static_cast<const T*>(x_), *g = static_cast<const T*>(g_), *w = static_cast<const T*>(w_);
  const float *mean = static_cast<const float*>(mean_), *rsig = static_cast<const float*>(rsig_);
  T* gx = static_cast<T*>(gx_);
  float* part = static_cast<float*>(ws);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const cudaError_t err = wide_units<T>(C, {x, g, w, gx})
                              ? launch_bwd<T, 16 / sizeof(T)>(x, mean, rsig, g, w, gx, part, rows, C, stream)
                              : launch_bwd<T, 1>(x, mean, rsig, g, w, gx, part, rows, C, stream);
  if (err != cudaSuccess) return err;
  ln2d_sum_kernel<T><<<(2 * C + kSumCols - 1) / kSumCols, kThreads, kThreads * sizeof(float), stream>>>(
      part, bwd_blocks(rows, C), C, static_cast<T*>(gw), static_cast<T*>(gb));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes); every pointer is a device pointer.
// x and out (rows, C), w and b (C) in the I/O type (f32: float, bf16:
// bfloat16); mean and rsig (rows) fp32, written when not null.  Each returns
// the first CUDA error, or 0.
#define LN_FWD_ARGS \
  const void *x, const void *w, const void *b, void *out, void *mean, void *rsig, int rows, int C, float eps, void *stream
extern "C" int ln_fwd_f32(LN_FWD_ARGS) { return ln_fwd<float>(x, w, b, out, mean, rsig, rows, C, eps, stream); }
extern "C" int ln_fwd_bf16(LN_FWD_ARGS) {
  return ln_fwd<__nv_bfloat16>(x, w, b, out, mean, rsig, rows, C, eps, stream);
}

// gx (rows, C), gw and gb (C) in the I/O type from x and g (rows, C) in the
// I/O type and the forward's fp32 mean and rsig; ws holds
// ln_bwd_workspace_floats(rows, C) floats.
#define LN_BWD_ARGS                                                                                             \
  const void *x, const void *mean, const void *rsig, const void *g, const void *w, void *gx, void *gw, void *gb, \
      void *ws, int rows, int C, void *stream
extern "C" int ln_bwd_f32(LN_BWD_ARGS) {
  return ln_bwd<float>(x, mean, rsig, g, w, gx, gw, gb, ws, rows, C, stream);
}
extern "C" int ln_bwd_bf16(LN_BWD_ARGS) {
  return ln_bwd<__nv_bfloat16>(x, mean, rsig, g, w, gx, gw, gb, ws, rows, C, stream);
}

extern "C" long long ln_bwd_workspace_floats(int rows, int C) { return (long long)bwd_blocks(rows, C) * 2 * C; }
