// Cyclic shift fused with the Swin window partition, and its inverse, on
// Hopper (sm_90a): an exact copy of elements of any type.
//
// Replaces the TPU kernels of dcpt_tpu/ops/window_process.py:
// window_partition_fused (_partition_kernel, pallas_call :52) and
// window_reverse_fused (_reverse_kernel, pallas_call :70).  On a (B, H, W, C)
// channels-last map and windows of ws x ws pixels:
//
//   partition  out[b * nW + wy * nx + wx][i * ws + j][c]
//                = x[b][(wy ws + i + shift) % H][(wx ws + j + shift) % W][c]
//   reverse    its inverse: x[...][(... + shift) % H][(... + shift) % W][c]
//                = windows[...][i * ws + j][c]
//
// i.e. torch.roll by -shift then the window view (partition), and the window
// view back then torch.roll by +shift (reverse), in one pass with no rolled
// copy in device memory.  One block per window.  A window row is ws pixels of
// one image row: with the shift they are contiguous in the image but for one
// wrap at the right edge, so the row is copied as at most two contiguous
// segments of C-element pixels, lanes running along the segment (coalesced
// for every C; C = 180 is not a multiple of 32).  The data move as units of
// 1, 2, 4, 8 or 16 bytes (unsigned integers, or a float4 bit pattern): the
// wrapper passes a pixel as C units of the widest size that divides it and
// aligns both buffers (SwinIR's 180 fp32 channels are 45 units of 16 bytes),
// so any dtype comes out bit for bit.
//
// Where it departs from the TPU kernel: dcpt_tpu divides H and W by ws with
// //, so on a ragged map its partition drops the last rows and columns and
// its reverse leaves them unwritten; the wrapper (ops/window_process.py)
// raises on an H or W that is not a multiple of ws instead.  Every shift is
// taken (the wrapper reduces it modulo H and W).  dcpt_tpu gives neither
// function a VJP, and neither has one here.
//
// What bounds it on this card: bytes, 2 B H W C itemsize (each element read
// once and written once) over the 3.35 TB/s of HBM3.

#include "common.cuh"

namespace {

template <typename E, bool REVERSE>
__global__ void __launch_bounds__(kThreads)
window_copy_kernel(const E* __restrict__ src, E* __restrict__ dst, int H, int W, int C, int ws, int shift_h,
                   int shift_w) {
  const int nx = W / ws, ny = H / ws;
  const long long win = blockIdx.x;  // b * nW + wy * nx + wx
  const int b = (int)(win / (ny * nx)), wy = (int)(win / nx % ny), wx = (int)(win % nx);
  const int col0 = (wx * ws + shift_w) % W;
  const int n1 = min(ws, W - col0) * C;  // elements of a window row before the wrap
  const int row_len = ws * C;
  for (int i = 0; i < ws; ++i) {
    const int row = (wy * ws + i + shift_h) % H;
    const size_t image = ((size_t)b * H + row) * W * C;
    const size_t window = ((size_t)win * ws + i) * row_len;
    for (int t = threadIdx.x; t < row_len; t += kThreads) {
      const size_t im = image + (t < n1 ? (size_t)col0 * C + t : (size_t)(t - n1));
      if (REVERSE)
        dst[im] = src[window + t];
      else
        dst[window + t] = src[im];
    }
  }
}

template <typename E>
int window_copy(const void* src, void* dst, int B, int H, int W, int C, int ws, int shift_h, int shift_w,
                int reverse, cudaStream_t stream) {
  const long long windows = (long long)B * (H / ws) * (W / ws);
  if (windows == 0) return cudaSuccess;
  auto s = static_cast<const E*>(src);
  auto d = static_cast<E*>(dst);
  if (reverse)
    window_copy_kernel<E, true><<<(unsigned)windows, kThreads, 0, stream>>>(s, d, H, W, C, ws, shift_h, shift_w);
  else
    window_copy_kernel<E, false><<<(unsigned)windows, kThreads, 0, stream>>>(s, d, H, W, C, ws, shift_h, shift_w);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  src and dst are device pointers:
// the (B, H, W, C) map and the (B nW, ws^2, C) windows, in that order for the
// partition and the other way round for the reverse (reverse != 0); C units of
// itemsize bytes (1, 2, 4, 8 or 16) a pixel, both buffers aligned to it; H and
// W multiples of ws; 0 <= shift_h < H and 0 <= shift_w < W.  Returns
// cudaGetLastError(), or 1 for an itemsize it does not take.
extern "C" int window_process(const void* src, void* dst, int B, int H, int W, int C, int ws, int shift_h,
                              int shift_w, int itemsize, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return window_copy<uint8_t>(src, dst, B, H, W, C, ws, shift_h, shift_w, reverse, s);
    case 2: return window_copy<uint16_t>(src, dst, B, H, W, C, ws, shift_h, shift_w, reverse, s);
    case 4: return window_copy<uint32_t>(src, dst, B, H, W, C, ws, shift_h, shift_w, reverse, s);
    case 8: return window_copy<unsigned long long>(src, dst, B, H, W, C, ws, shift_h, shift_w, reverse, s);
    case 16: return window_copy<float4>(src, dst, B, H, W, C, ws, shift_h, shift_w, reverse, s);
    default: return 1;
  }
}
