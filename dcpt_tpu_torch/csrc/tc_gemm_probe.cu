// A test kernel for csrc/tc_gemm.cuh, on no path of the port: its product
// alone, D = A . B in both of a weight's layouts and as a weight gradient cut
// along the tokens, with plain stores for the epilogue.  Built by nvcc it
// shows what the card computes, and built by the CPU emulation
// (tools/cuda_emu) what the emulation computes; the tests hold both to numpy
// in float64 (tests/test_torch_tc_gemm_emu.py, tests/test_torch_cuda.py).

#include "tc_gemm.cuh"

namespace {

// out[z] (rows, N) row-major
struct StoreEpi {
  float* out;
  int rows, N;
  __device__ __forceinline__ void operator()(int z, int r, int n, float v0, float v1) const {
    float* d = out + ((size_t)z * rows + r) * N + n;
    d[0] = v0;
    if (n + 1 < N) d[1] = v1;
  }
};

template <typename TW>
int product(const float* a, const void* w, float* out, int T, int K, int N, int wt, cudaStream_t stream) {
  const TW* wp = static_cast<const TW*>(w);
  const StoreEpi epi{out, T, N};
  if (wt) return tc::gemm<0>(tc::operand<true>(a, K, T), tc::operand<false>(wp, N, N), K, 1, K, epi, nullptr, stream);
  return tc::gemm<0>(tc::operand<true>(a, K, T), tc::operand<true>(wp, K, N), K, 1, K, epi, nullptr, stream);
}

template <typename TA>
int weight_grad(const void* a, const float* b, float* part, float* sums, int T, int M, int N, cudaStream_t stream) {
  int len;
  const int chunks = tc::depth_chunks(M, N, T, &len);
  return tc::gemm<0>(tc::operand<false>(static_cast<const TA*>(a), M, M), tc::operand<false>(b, N, N), T, chunks,
                     len, StoreEpi{part, M, N}, sums, stream);
}

}  // namespace

// out (T, N) = a (T, K) . W^T with W (N, K) row-major, or with wt a . W, W (K, N);
// a fp32, W fp32 or (w_bf16) bf16; every pointer a device pointer.
extern "C" int tc_gemm_probe(const void* a, const void* w, void* out, int T, int K, int N, int wt, int w_bf16,
                             void* stream) {
  const float* af = static_cast<const float*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_bf16 ? product<__nv_bfloat16>(af, w, static_cast<float*>(out), T, K, N, wt, s)
                : product<float>(af, w, static_cast<float*>(out), T, K, N, wt, s);
}

// The token chunks of a weight gradient with an M x N output over T tokens; sets *len.
extern "C" int tc_depth_chunks(int M, int N, int T, int* len) { return tc::depth_chunks(M, N, T, len); }

// part (chunks, M, N): each chunk's sum over its tokens p of a[p][m] b[p][n];
// sums (chunks, M): each chunk's sums of a[p][m]; a (T, M) fp32 or (a_bf16)
// bf16, b (T, N) fp32.
extern "C" int tc_wgrad_probe(const void* a, const void* b, void* part, void* sums, int T, int M, int N, int a_bf16,
                              void* stream) {
  const float* bf = static_cast<const float*>(b);
  float *p = static_cast<float*>(part), *sm = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? weight_grad<__nv_bfloat16>(a, bf, p, sm, T, M, N, s) : weight_grad<float>(a, bf, p, sm, T, M, N, s);
}
