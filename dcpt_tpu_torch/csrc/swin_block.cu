// Whole SwinIR SwinTransformerBlock forward on Hopper (sm_90a): K8.  SIMT
// fp32 math, fp32 or bf16 I/O, one block of 256 threads per window.
//
// Replaces the TPU kernel dcpt_tpu/ops/window_attention.py::fused_swin_block
// (_swin_block_pallas / _block_kernel, called from
// dcpt_tpu/archs/swinir_arch.py:285-304 between a roll, window_partition,
// window_reverse and the roll back).  It computes what swin_block_map_ref
// computes on a (B, H, W, C) map with windows of ws x ws shifted by `shift`:
//
//   y = x + proj(softmax_h(q_h k_h^T) v_h)   q, k, v = LN1(x) . Wqkv^T + b, q * hd^-0.5
//   z = y + fc2(GELU(fc1(LN2(y))))            exact-erf GELU
//
// in one launch, reading each pixel once and writing it once; the roll and
// the partition are the block's index map (csrc/swin_window.cuh).
//
// What bounds it on this card: per token 2 (3C^2 + C^2 + 2 C hidden + 2 N C)
// flops against 2 C values of I/O, about 560 k flops per 1.4 KB at C = 180:
// operations, on the SIMT fp32 pipes from shared memory.  The design keeps
// every intermediate of a window in shared memory, transposed so that one
// 16-byte load feeds four tokens (204 KB at C = 180, one block per SM), and
// streams the weights, which all windows share, from the L2 in 32-deep chunks
// prefetched into registers.  Head width 30, C = 180 and hidden 360 are no
// multiples of 64: every product masks its ragged columns and depth.  Tensor
// cores (wgmma, or mma.sync in split TF32 for fp32 accuracy) and TMA are the
// next steps.
//
// Weights come in PyTorch's layout: every Linear as (out, in) row-major.

#include "swin_window.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_block_kernel(const T* __restrict__ x, const T* __restrict__ ln1w, const T* __restrict__ ln1b,
                  const T* __restrict__ wqkv, const T* __restrict__ bqkv, const T* __restrict__ wproj,
                  const T* __restrict__ bproj, const T* __restrict__ ln2w, const T* __restrict__ ln2b,
                  const T* __restrict__ wfc1, const T* __restrict__ bfc1, const T* __restrict__ wfc2,
                  const T* __restrict__ bfc2, T* __restrict__ z, int H, int W, int C, int heads, int ws, int shift,
                  int hidden, float eps) {
  extern __shared__ __align__(16) float smem[];  // 16-byte rows for float4
  swin_window_body<T, true, true>(smem, x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, ln2w, ln2b, wfc1, bfc1, wfc2, bfc2,
                                  z, H, W, C, heads, ws, shift, hidden, eps);
}

template <typename T>
int swin_block_fwd(const void* x, const void* ln1w, const void* ln1b, const void* wqkv, const void* bqkv,
                   const void* wproj, const void* bproj, const void* ln2w, const void* ln2b, const void* wfc1,
                   const void* bfc1, const void* wfc2, const void* bfc2, void* z, int B, int H, int W, int C,
                   int heads, int ws, int shift, int hidden, float eps, void* stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  return launch_windows(swin_block_kernel<T>, B, H, W, C, heads, ws, static_cast<cudaStream_t>(stream), p(x),
                        p(ln1w), p(ln1b), p(wqkv), p(bqkv), p(wproj), p(bproj), p(ln2w), p(ln2b), p(wfc1), p(bfc1),
                        p(wfc2), p(bfc2), static_cast<T*>(z), H, W, C, heads, ws, shift, hidden, eps);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer, every tensor in the I/O type: x and z (B, H, W, C); the norm
// weights and biases (C,); Wqkv (3C, C), bqkv (3C,), Wproj (C, C), bproj (C,),
// Wfc1 (hidden, C), bfc1 (hidden,), Wfc2 (C, hidden), bfc2 (C,).  H and W are
// multiples of ws, ws * ws <= 64, 0 <= shift < ws.  Returns cudaGetLastError().
#define SWIN_BLOCK_ARGS                                                                                        \
  const void *x, const void *ln1w, const void *ln1b, const void *wqkv, const void *bqkv, const void *wproj,   \
      const void *bproj, const void *ln2w, const void *ln2b, const void *wfc1, const void *bfc1,               \
      const void *wfc2, const void *bfc2, void *z, int B, int H, int W, int C, int heads, int ws, int shift,   \
      int hidden, float eps, void *stream
#define SWIN_BLOCK_PASS \
  x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, ln2w, ln2b, wfc1, bfc1, wfc2, bfc2, z, B, H, W, C, heads, ws, shift, hidden, eps, stream

extern "C" int swin_block_fwd_f32(SWIN_BLOCK_ARGS) { return swin_block_fwd<float>(SWIN_BLOCK_PASS); }
extern "C" int swin_block_fwd_bf16(SWIN_BLOCK_ARGS) { return swin_block_fwd<__nv_bfloat16>(SWIN_BLOCK_PASS); }
