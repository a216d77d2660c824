// NAFBlock attention-branch prefix on Hopper (sm_90a): fp32 math, fp32 or bf16
// I/O; the 1x1 expand on the tensor cores.
//
// Replaces the TPU kernel dcpt_tpu/ops/naf_prefix.py::naf_prefix (_kernel): on a
// (B, H, W, C) channels-last map, LN (fp32 statistics, biased variance) ->
// 1x1 C->DW (+b1) -> depthwise 3x3 with zero padding (+bdw) -> SimpleGate,
// giving (B, H, W, DW/2), DW = 2C.  dcpt_tpu runs it at every c = 512 NAFBlock
// under DCPT_TPU_PALLAS=1 when the whole-block kernel is not taken.
//
// It is the first half of K1's spatial branch (naf_block.cu), from the passes
// they share (naf_common.cuh, token_bwd.cuh), without the SCA sums:
//
//   LN1   LN1(x) (B, HW, C) fp32 scratch (ln_fwd_kernel<4>)
//   W1    t = LN1(x) . W1^T + b1 (B, HW, 2C) fp32 scratch (tc_gemm_kernel<4>,
//         ExpandEpi; chunk_epi_kernel<4> where it is cut along its depth)
//   gate  per (image row segment, 32 gate channels): the depthwise 3x3 of t
//         with its bias on channels j and C + j, zero outside the image, then
//         g = a b in the I/O type (naf_gate_kernel<4>)
//
// The TPU kernel holds the whole (H, W, 2C) map in VMEM and so runs only
// where it fits (prefix_fits, a 10 MB budget); here t goes to device memory,
// mostly to stay in the 50 MB L2 between the passes, so any H x W is taken,
// down to 1 x 1, ragged rows and segments masked, and so is any C.
//
// What bounds it on this card: the expand's 2 C^2 multiply-adds a pixel (the
// 3x3 stencil adds 18 C): operations.  They run on the tensor cores: 96 x 96
// tiles of mma.sync m16n8k8 TF32 with fp32 sums, three MMAs a step for fp32
// operands (3xTF32, fp32 accuracy; 495 / 3 TFLOP/s against the SIMT pipes'
// 67), two for the fp32 LN1 map and a bf16 weight.  The expand is computed
// once a pixel (the halo tiles of the SIMT design recomputed it on 1.5 x the
// pixels), at the price of writing t (2C floats a pixel) and reading it back
// in the gate pass.  Where the product's tiles would leave the card idle (33
// of 96 x 96 at B = 1) it is cut along its depth and its chunks added in a
// fixed order before the epilogue (chunk_epi_kernel<4>), at every row count:
// uncut, one wave of blocks walking the whole depth took 0.056 ms of device
// time a call at B = 1 on an H100 at 700 W, cut 0.027, for one more launch
// (K1, with 9 launches a call, is bound by the host there and cuts only from
// 1024 rows, kForwardMinCutRows).

#include "naf_common.cuh"

namespace {

// The fp32 scratch: LN1(x), t and the product's depth-chunk partials with
// colsum's buffers.
struct PrefixScratch {
  size_t ln, t, prod_part, prod_sum, total;
};

inline PrefixScratch prefix_plan(int npix, int C) {
  PrefixScratch sc;
  ScratchPlan plan;
  sc.ln = plan.take((size_t)npix * C);
  sc.t = plan.take((size_t)npix * 2 * C);
  size_t part = 0, sum = 0;
  product_floats(npix, C, 2 * C, &part, &sum);
  sc.prod_part = plan.take(part);
  sc.prod_sum = plan.take(sum);
  sc.total = plan.off;
  return sc;
}

template <typename T>
int naf_prefix_fwd(const T* x, const T* n1w, const T* n1b, const T* w1, const T* b1, const T* wdw, const T* bdw,
                   T* g, float* part, int B, int H, int W, int C, float eps, cudaStream_t stream) {
  const int npix = B * H * W;
  const PrefixScratch sc = prefix_plan(npix, C);
  float* ln = part + sc.ln;
  float* t = part + sc.t;
  cudaError_t err = ln_fwd<4>(x, n1w, n1b, ln, npix, C, eps, 1, stream);
  if (err != cudaSuccess) return err;
  err = product_epi<4>(tc::operand<true>(ln, C, npix), tc::operand<true>(w1, C, 2 * C), C, ExpandEpi<T>{b1, t, 2 * C},
                       part + sc.prod_part, part + sc.prod_sum, stream);
  if (err != cudaSuccess) return err;
  return naf_gate<4>(t, wdw, bdw, g, nullptr, B, H, W, C, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers: x (B, H, W, C),
// n1w, n1b (C), w1 (2C, C) (PyTorch's (out, in)), b1 (2C), wdw (2C, 3, 3),
// bdw (2C), g (B, H, W, C) out, all in the I/O type; part fp32 scratch of
// naf_prefix_scratch_floats floats.  Returns the first CUDA error, or 0.
#define NAF_PREFIX_ARGS                                                                                       \
  const void *x, const void *n1w, const void *n1b, const void *w1, const void *b1, const void *wdw,         \
      const void *bdw, void *g, void *part, int B, int H, int W, int C, float eps, void *stream
#define NAF_PREFIX_PASS(T)                                                                                    \
  static_cast<const T*>(x), static_cast<const T*>(n1w), static_cast<const T*>(n1b), static_cast<const T*>(w1), \
      static_cast<const T*>(b1), static_cast<const T*>(wdw), static_cast<const T*>(bdw), static_cast<T*>(g),  \
      static_cast<float*>(part), B, H, W, C, eps, static_cast<cudaStream_t>(stream)

extern "C" int naf_prefix_f32(NAF_PREFIX_ARGS) { return naf_prefix_fwd<float>(NAF_PREFIX_PASS(float)); }
extern "C" int naf_prefix_bf16(NAF_PREFIX_ARGS) {
  return naf_prefix_fwd<__nv_bfloat16>(NAF_PREFIX_PASS(__nv_bfloat16));
}

// Floats of the fp32 scratch part, so the caller can size it.
extern "C" long long naf_prefix_scratch_floats(int B, int H, int W, int C) {
  return (long long)prefix_plan(B * H * W, C).total;
}
