// NAFBlock FFN half on Hopper (sm_90a): SIMT fp32 math, fp32 or bf16 I/O.
//
// Replaces the TPU kernel dcpt_tpu/ops/naf_ffn.py::naf_ffn (_kernel): over rows
// (N, C), z = y + gamma * (gate(LN(y) . W4^T + b4) . W5^T + b5), gate(h) =
// h[:, :C] * h[:, C:], LN with fp32 statistics and biased variance.  dcpt_tpu
// runs it at every c = 512 NAFBlock under DCPT_TPU_PALLAS=1 when the
// whole-block kernel is not taken.
//
// It is K1's FFN passes (naf_common.cuh::naf_p2b_kernel, naf_p2c_kernel) with
// y read in the I/O type: per (tile of 16 or 32 rows, 64 output columns) a block
// computes the LN statistics of its rows, the paired columns n and C + n of
// the expand, and the gate into an fp32 hidden map (N, C); a second grid
// multiplies it by W5 and adds the residual.  The TPU kernel keeps the 2C-wide
// h in VMEM per row tile; here the gated C-wide hidden map goes to device
// memory between the passes (4 N C bytes, which stays in the 50 MB L2 at the
// deep stage's sizes), so that every product is spread over pixel tiles x
// column blocks and fills the card at 16 x 16 maps.
//
// What bounds it on this card: 3 C^2 multiply-adds per row (C x 2C, then
// C x C), i.e. arithmetic, on the SIMT fp32 pipes from shared memory.
// wgmma/TMA tiles come later.

#include "naf_common.cuh"

namespace {

template <typename T>
int naf_ffn(const void* y, const void* n2w, const void* n2b, const void* w4, const void* b4, const void* w5,
            const void* b5, const void* gamma, void* hidden, void* z, int N, int C, float eps, void* stream) {
  auto p = [](const void* v) { return static_cast<const T*>(v); };
  float* hid = static_cast<float*>(hidden);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p2_rows(N) == 2)
    return launch_ffn<T, T, 2>(p(y), p(n2w), p(n2b), p(w4), p(b4), p(w5), p(b5), p(gamma), hid, static_cast<T*>(z),
                               nullptr, nullptr, 1, N, C, eps, s);
  return launch_ffn<T, T, 1>(p(y), p(n2w), p(n2b), p(w4), p(b4), p(w5), p(b5), p(gamma), hid, static_cast<T*>(z),
                             nullptr, nullptr, 1, N, C, eps, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers: y and z (N, C),
// n2w, n2b, b5, gamma (C), w4 (2C, C) and w5 (C, C) (PyTorch's (out, in)), b4
// (2C), all in the I/O type; hidden (N, C) fp32 scratch; C a multiple of 64.
// Returns cudaGetLastError().
#define NAF_FFN_ARGS                                                                                          \
  const void *y, const void *n2w, const void *n2b, const void *w4, const void *b4, const void *w5,           \
      const void *b5, const void *gamma, void *hidden, void *z, int N, int C, float eps, void *stream
#define NAF_FFN_PASS y, n2w, n2b, w4, b4, w5, b5, gamma, hidden, z, N, C, eps, stream

extern "C" int naf_ffn_f32(NAF_FFN_ARGS) { return naf_ffn<float>(NAF_FFN_PASS); }
extern "C" int naf_ffn_bf16(NAF_FFN_ARGS) { return naf_ffn<__nv_bfloat16>(NAF_FFN_PASS); }
