// SwinIR's window attention on Hopper (sm_90a): K10.  Every product on the
// tensor cores (mma.sync m16n8k8 TF32, fp32 sums), fp32 or bf16 I/O, one block
// of 256 threads per window.
//
// Replaces the TPU kernel dcpt_tpu/ops/window_attention.py::_wa_pallas /
// _kernel behind fused_window_attention and fused_window_attention_ln, the
// route of dcpt_tpu/archs/swinir_arch.py:306-339 when DCPT_TPU_SWIN_BLOCK=0.
// It computes what window_attention_map_ref computes on a (B, H, W, C) map
// with windows of ws x ws shifted by `shift`:
//
//   out = proj(softmax_h(q_h k_h^T) v_h)   q, k, v = [LN1](x) . Wqkv^T + b, q * hd^-0.5
//
// the attention branch alone, written to the pixels it was read from (the
// caller adds the shortcut and runs the MLP); the roll and the partition are
// the block's index map (csrc/swin_window.cuh, whose body K8 shares).
//
// What bounds it on this card: per token 2 (4 C^2 + 2 N C) flops against
// 2 C values of I/O: operations, at a third of the TF32 tensor-core rate with
// fp32 I/O (3xTF32).  The design and what holds it back are K8's
// (csrc/swin_block.cu, csrc/swin_window.cuh).
//
// Weights come in PyTorch's layout: every Linear as (out, in) row-major.

#include "swin_window.cuh"

namespace {

template <typename T, bool LN>
__global__ void __launch_bounds__(kWinThreads)
window_attention_kernel(const T* __restrict__ x, const T* __restrict__ lnw, const T* __restrict__ lnb,
                        const T* __restrict__ wqkv, const T* __restrict__ bqkv, const T* __restrict__ wproj,
                        const T* __restrict__ bproj, T* __restrict__ out, int H, int W, int C, int heads, int ws,
                        int shift, float eps) {
  extern __shared__ __align__(16) float smem[];  // 16-byte rows for float4
  swin_window_body<T, LN, false>(smem, x, lnw, lnb, wqkv, bqkv, wproj, bproj, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, out, H, W, C, heads, ws, shift, 0, eps);
}

template <typename T>
int window_attention_fwd(const void* x, const void* lnw, const void* lnb, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bproj, void* out, int B, int H, int W, int C, int heads,
                         int ws, int shift, int use_ln, float eps, void* stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  auto kernel = use_ln ? window_attention_kernel<T, true> : window_attention_kernel<T, false>;
  return launch_windows(kernel, B, H, W, C, heads, ws, static_cast<cudaStream_t>(stream), p(x), p(lnw), p(lnb),
                        p(wqkv), p(bqkv), p(wproj), p(bproj), static_cast<T*>(out), H, W, C, heads, ws, shift, eps);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer, every tensor in the I/O type: x and out (B, H, W, C); the norm
// weight and bias (C,), read only when use_ln is 1; Wqkv (3C, C), bqkv (3C,),
// Wproj (C, C), bproj (C,).  H and W are multiples of ws, ws * ws <= 64,
// 0 <= shift < ws.  Returns cudaGetLastError().
#define WINDOW_ATTENTION_ARGS                                                                                  \
  const void *x, const void *lnw, const void *lnb, const void *wqkv, const void *bqkv, const void *wproj,     \
      const void *bproj, void *out, int B, int H, int W, int C, int heads, int ws, int shift, int use_ln,      \
      float eps, void *stream
#define WINDOW_ATTENTION_PASS x, lnw, lnb, wqkv, bqkv, wproj, bproj, out, B, H, W, C, heads, ws, shift, use_ln, eps, stream

extern "C" int window_attention_fwd_f32(WINDOW_ATTENTION_ARGS) {
  return window_attention_fwd<float>(WINDOW_ATTENTION_PASS);
}
extern "C" int window_attention_fwd_bf16(WINDOW_ATTENTION_ARGS) {
  return window_attention_fwd<__nv_bfloat16>(WINDOW_ATTENTION_PASS);
}
