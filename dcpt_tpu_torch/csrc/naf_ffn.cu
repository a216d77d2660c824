// NAFBlock FFN half on Hopper (sm_90a): fp32 math, fp32 or bf16 I/O; the 1x1
// products on the tensor cores.
//
// Replaces the TPU kernel dcpt_tpu/ops/naf_ffn.py::naf_ffn (_kernel): over rows
// (N, C), z = y + gamma * (gate(LN(y) . W4^T + b4) . W5^T + b5), gate(h) =
// h[:, :C] * h[:, C:], LN with fp32 statistics and biased variance.  dcpt_tpu
// runs it at every c = 512 NAFBlock under DCPT_TPU_PALLAS=1 when the
// whole-block kernel is not taken.
//
// It is K1's FFN half (naf_block.cu), from the passes they share
// (naf_common.cuh, token_bwd.cuh), with y read in the I/O type:
//
//   LN2   LN2(y) (N, C) fp32 scratch (ln_fwd_kernel<5>)
//   W4    h = LN2(y) . W4^T + b4, hidden = h[:C] * h[C:] (N, C) fp32 scratch
//         (tc_gemm_kernel<5>, GateEpi: W4's rows staged with each gate pair
//         side by side, 2j <- j and 2j + 1 <- C + j, tc_gemm.cuh's paired
//         operand, so that one column pair holds h1 and h2 of a channel)
//   W5    o = hidden . W5^T + b5, z = y + gamma * o in the I/O type
//         (tc_gemm_kernel<5>, OutEpi)
//
// The TPU kernel keeps the 2C-wide h in VMEM per row tile; here only the gated
// C-wide hidden map goes to device memory between the products (4 N C bytes,
// which stays in the 50 MB L2 at the deep stage's sizes).  Any C is taken.
//
// What bounds it on this card: 3 C^2 multiply-adds a row (C x 2C, then C x C):
// operations.  They run on the tensor cores: 96 x 96 tiles of mma.sync m16n8k8
// TF32 with fp32 sums, three MMAs a step for fp32 operands (3xTF32, fp32
// accuracy; 495 / 3 TFLOP/s against the SIMT pipes' 67), two for an fp32 map
// and a bf16 weight.  Where a product's tiles would leave the card idle (W5
// at 2048 rows, both products at 256) it is cut along its depth and its
// chunks added in a fixed order before the epilogue (chunk_epi_kernel<5>), at
// every row count: uncut, one wave of blocks walking the whole depth took
// 0.095 ms of device time a call at B = 1 on an H100 at 700 W, more than the
// SIMT design's 0.086, cut 0.037, for two more launches (K1, with 9 launches
// a call, is bound by the host there and cuts only from 1024 rows,
// kForwardMinCutRows).

#include "naf_common.cuh"

namespace {

// The fp32 scratch: LN2(y), hidden and the products' depth-chunk partials
// with colsum's buffers.
struct FfnScratch {
  size_t ln, hidden, prod_part, prod_sum, total;
};

inline FfnScratch ffn_plan(int N, int C) {
  FfnScratch sc;
  ScratchPlan plan;
  sc.ln = plan.take((size_t)N * C);
  sc.hidden = plan.take((size_t)N * C);
  size_t part = 0, sum = 0;
  const int prods[2] = {2 * C, C};  // the outputs of W4 and W5, each of depth C
  for (const int n : prods) product_floats(N, C, n, &part, &sum);
  sc.prod_part = plan.take(part);
  sc.prod_sum = plan.take(sum);
  sc.total = plan.off;
  return sc;
}

template <typename T>
int naf_ffn_fwd(const T* y, const T* n2w, const T* n2b, const T* w4, const T* b4, const T* w5, const T* b5,
                const T* gamma, float* part, T* z, int N, int C, float eps, cudaStream_t stream) {
  const FfnScratch sc = ffn_plan(N, C);
  float* ln = part + sc.ln;
  float* hidden = part + sc.hidden;
  float* ppart = part + sc.prod_part;
  float* psum = part + sc.prod_sum;
  cudaError_t err = ln_fwd<5>(y, n2w, n2b, ln, N, C, eps, 1, stream);
  if (err != cudaSuccess) return err;
  // W4's rows read with each gate pair side by side (2j <- j, 2j + 1 <- C + j)
  err = product_epi<5>(tc::operand<true>(ln, C, N), tc::operand<true>(w4, C, 2 * C, C), C,
                       GateEpi<T>{b4, hidden, nullptr, C}, ppart, psum, stream);
  if (err != cudaSuccess) return err;
  return product_epi<5>(tc::operand<true>(hidden, C, N), tc::operand<true>(w5, C, C), C,
                        OutEpi<T, T>{y, b5, gamma, z, nullptr, C}, ppart, psum, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers: y and z (N, C),
// n2w, n2b, b5, gamma (C), w4 (2C, C) and w5 (C, C) (PyTorch's (out, in)), b4
// (2C), all in the I/O type; part fp32 scratch of naf_ffn_scratch_floats
// floats.  Returns the first CUDA error, or 0.
#define NAF_FFN_ARGS                                                                                          \
  const void *y, const void *n2w, const void *n2b, const void *w4, const void *b4, const void *w5,           \
      const void *b5, const void *gamma, void *part, void *z, int N, int C, float eps, void *stream
#define NAF_FFN_PASS(T)                                                                                       \
  static_cast<const T*>(y), static_cast<const T*>(n2w), static_cast<const T*>(n2b), static_cast<const T*>(w4), \
      static_cast<const T*>(b4), static_cast<const T*>(w5), static_cast<const T*>(b5),                        \
      static_cast<const T*>(gamma), static_cast<float*>(part), static_cast<T*>(z), N, C, eps,                 \
      static_cast<cudaStream_t>(stream)

extern "C" int naf_ffn_f32(NAF_FFN_ARGS) { return naf_ffn_fwd<float>(NAF_FFN_PASS(float)); }
extern "C" int naf_ffn_bf16(NAF_FFN_ARGS) { return naf_ffn_fwd<__nv_bfloat16>(NAF_FFN_PASS(__nv_bfloat16)); }

// Floats of the fp32 scratch part, so the caller can size it.
extern "C" long long naf_ffn_scratch_floats(int N, int C) { return (long long)ffn_plan(N, C).total; }
