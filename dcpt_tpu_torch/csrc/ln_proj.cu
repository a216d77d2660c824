// Channel LayerNorm fused with a 1x1 projection on Hopper (sm_90a): SIMT fp32
// math, fp32 or bf16 I/O.
//
// Replaces two TPU kernels:
//   dcpt_tpu/ops/ln_proj.py::fused_ln_proj (_kernel :36, pallas_call :60):
//     out = LN(x) . w, LN BiasFree ((x rs) lnw, centred variance, uncentred
//     output) or WithBias (((x - mu) rs) lnw + lnb), fp32 statistics; the
//     Restormer / PromptIR MDTA qkv and GDFN project_in prefix (MDTA and GDFN
//     with pre_norm);
//   dcpt_tpu/ops/naf_ffn.py::naf_expand (_expand_kernel :102, pallas_call
//     :115): out = LN(x) . w1 + b1, WithBias, eps 1e-6 (NAFNet's LN -> 1x1
//     expand).
// x is (rows, C), w (C, N) row-major (dcpt_tpu's layout: the 1x1 conv as
// (in, out)), the optional output bias (N,).
//
// One kernel: a block takes 16 RM rows and 64 output columns, RM 4, 2 or 1,
// the largest that still gives the card two blocks an SM (the deep stages'
// 256-row maps make 64 blocks at RM = 4 against 132 SMs).  Its warps
// first take the LayerNorm statistics of its rows (two passes over each row
// in fp32: the mean, then the centred variance); then gemm.cuh's
// gemm_masked streams the product through shared memory in 32-deep chunks,
// applying the LayerNorm as it loads each element of x (as K6's ln_value
// does, csrc/mdta_block.cu), so LN(x) never goes to device memory; the
// output bias is added in the epilogue.  With ROUND_LN (fused_ln_proj in
// bf16) the normalised value is rounded to bf16 before the LN weight, and the
// affine rounded again, as ln_proj_ref casts (ln_proj.py:31-33);
// naf_expand's LN follows naf_expand_ref, whose math is in x's dtype: here it
// is fp32 in both dtypes.  Every product masks its ragged rows, columns and
// depth.
//
// Where it departs from the TPU kernels: dcpt_tpu drops to the jnp reference
// at C > 512, C % 16 != 0 or a weight over 6 MB (VMEM limits of the TPU, and
// the same function either way); every C and N is taken here, so the PromptIR
// noise-level width of 704 runs the kernel too.  dcpt_tpu's custom VJPs
// differentiate the references; the port's autograd Functions run the plain
// versions' VJPs likewise.
//
// What bounds it on this card: 2 C N flops per row against (C + N) itemsize
// bytes (x read and out written once) and C N itemsize for the weight.  At
// Restormer's widths (48 -> 144 ... 384 -> 2042) that is 18-140 flops a byte
// against the card's 20 fp32 flops a byte: operations at every width but the
// narrowest, on the SIMT fp32 pipes from shared memory here; wgmma tiles come later.

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kMinBlocks = 2 * 132;  // two blocks for each of the H100's SMs

template <typename T, bool LN_BIAS, bool ROUND_LN, bool OUT_BIAS, int RM>
__global__ void __launch_bounds__(kThreads)
ln_proj_kernel(const T* __restrict__ x, const T* __restrict__ lnw, const T* __restrict__ lnb,
               const T* __restrict__ w, const T* __restrict__ ob, T* __restrict__ out, int rows, int C, int N,
               float eps) {
  constexpr int P = 16 * RM;
  constexpr int kGemmFloats = kKC * (P + 1) + 2 * kWChunk;  // gemm_smem_floats(RM)
  extern __shared__ float smem[];
  float* sMu = smem + kGemmFloats;
  float* sRs = sMu + P;
  const long long p0 = (long long)blockIdx.x * P;
  const int n0 = blockIdx.y * kNB;
  const int np = (int)min((long long)P, rows - p0);
  const T* xb = x + p0 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = warp; p < P; p += kThreads / 32) {
    float s = 0.f, v = 0.f;
    if (p < np)
      for (int c = lane; c < C; c += 32) s += ld(xb[(size_t)p * C + c]);
    const float mu = warp_sum(s) / C;
    if (p < np)
      for (int c = lane; c < C; c += 32) {
        const float d = ld(xb[(size_t)p * C + c]) - mu;
        v += d * d;
      }
    v = warp_sum(v);
    if (lane == 0) {
      sMu[p] = mu;
      sRs[p] = 1.f / sqrtf(v / C + eps);
    }
  }
  // gemm_masked's first barrier orders these statistics before every read of them
  auto load_a = [&](int p, int k) -> float {
    if (p >= np) return 0.f;
    const float xv = ld(xb[(size_t)p * C + k]);
    float nv = (LN_BIAS ? xv - sMu[p] : xv) * sRs[p];
    if (ROUND_LN) {
      const float a = ld(st<T>(ld(st<T>(nv)) * ld(lnw[k])));
      return LN_BIAS ? ld(st<T>(a + ld(lnb[k]))) : a;
    }
    nv *= ld(lnw[k]);
    return LN_BIAS ? nv + ld(lnb[k]) : nv;
  };
  float acc[RM][4];
  gemm_masked<RM, true>(smem, w, N, N, n0, 0, C, load_a, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * r, n = n0 + tx + 16 * i;
      if (p < np && n < N) out[(size_t)(p0 + p) * N + n] = st<T>(OUT_BIAS ? acc[r][i] + ld(ob[n]) : acc[r][i]);
    }
}

template <typename T, bool LN_BIAS, bool ROUND_LN, bool OUT_BIAS, int RM>
int launch_rm(const void* x, const void* lnw, const void* lnb, const void* w, const void* ob, void* out, int rows,
              int C, int N, float eps, cudaStream_t stream) {
  constexpr int P = 16 * RM;
  const size_t smem = (kKC * (P + 1) + 2 * kWChunk + 2 * P) * sizeof(float);
  const dim3 grid((unsigned)((rows + P - 1) / P), (unsigned)((N + kNB - 1) / kNB));
  ln_proj_kernel<T, LN_BIAS, ROUND_LN, OUT_BIAS, RM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lnw), static_cast<const T*>(lnb), static_cast<const T*>(w),
      static_cast<const T*>(ob), static_cast<T*>(out), rows, C, N, eps);
  return cudaGetLastError();
}

template <typename T, bool LN_BIAS, bool ROUND_LN, bool OUT_BIAS>
int launch(const void* x, const void* lnw, const void* lnb, const void* w, const void* ob, void* out, int rows, int C,
           int N, float eps, cudaStream_t stream) {
  const long long cols = (N + kNB - 1) / kNB;
  if ((rows + 63LL) / 64 * cols >= kMinBlocks)
    return launch_rm<T, LN_BIAS, ROUND_LN, OUT_BIAS, 4>(x, lnw, lnb, w, ob, out, rows, C, N, eps, stream);
  if ((rows + 31LL) / 32 * cols >= kMinBlocks)
    return launch_rm<T, LN_BIAS, ROUND_LN, OUT_BIAS, 2>(x, lnw, lnb, w, ob, out, rows, C, N, eps, stream);
  return launch_rm<T, LN_BIAS, ROUND_LN, OUT_BIAS, 1>(x, lnw, lnb, w, ob, out, rows, C, N, eps, stream);
}

template <typename T>
int ln_proj(const void* x, const void* lnw, const void* lnb, const void* w, void* out, int rows, int C, int N,
            float eps, int ln_bias, void* stream) {
  if (rows == 0 || N == 0) return cudaSuccess;
  constexpr bool kRound = sizeof(T) < sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln_bias) return launch<T, true, kRound, false>(x, lnw, lnb, w, nullptr, out, rows, C, N, eps, s);
  return launch<T, false, kRound, false>(x, lnw, lnb, w, nullptr, out, rows, C, N, eps, s);
}

template <typename T>
int naf_expand(const void* x, const void* lnw, const void* lnb, const void* w, const void* b, void* out, int rows,
               int C, int N, float eps, void* stream) {
  if (rows == 0 || N == 0) return cudaSuccess;
  return launch<T, true, false, true>(x, lnw, lnb, w, b, out, rows, C, N, eps, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Device pointers, all in the I/O
// type: x (rows, C), lnw and lnb (C; lnb unread when ln_bias is 0), w (C, N)
// row-major, b (N), out (rows, N).  Returns cudaGetLastError().
#define LN_PROJ_ARGS const void *x, const void *lnw, const void *lnb, const void *w, void *out, int rows, int C, int N, \
                     float eps, int ln_bias, void *stream
#define NAF_EXPAND_ARGS const void *x, const void *lnw, const void *lnb, const void *w, const void *b, void *out, \
                        int rows, int C, int N, float eps, void *stream

extern "C" int ln_proj_f32(LN_PROJ_ARGS) { return ln_proj<float>(x, lnw, lnb, w, out, rows, C, N, eps, ln_bias, stream); }
extern "C" int ln_proj_bf16(LN_PROJ_ARGS) {
  return ln_proj<__nv_bfloat16>(x, lnw, lnb, w, out, rows, C, N, eps, ln_bias, stream);
}
extern "C" int naf_expand_f32(NAF_EXPAND_ARGS) { return naf_expand<float>(x, lnw, lnb, w, b, out, rows, C, N, eps, stream); }
extern "C" int naf_expand_bf16(NAF_EXPAND_ARGS) {
  return naf_expand<__nv_bfloat16>(x, lnw, lnb, w, b, out, rows, C, N, eps, stream);
}
