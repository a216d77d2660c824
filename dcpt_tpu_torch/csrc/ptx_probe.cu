// A test kernel for csrc/ptx.cuh, on no path of the port: one warp loads a
// 16 x 8 A, an 8 x 8 B and a 16 x 8 C (row-major fp32) into mma_tf32's
// fragments, returns D = A B + C, and rounds n values with tf32_round.  Built
// by nvcc it shows what the card's instructions do, and built by the CPU
// emulation (tools/cuda_emu) what the emulation does; the tests hold both to
// numpy (tests/test_torch_swin_emu.py, tests/test_torch_cuda.py).

#include "ptx.cuh"

namespace {

__global__ void ptx_probe_kernel(const float* a, const float* b, const float* c, float* d, const float* x,
                                 float* rounded, int n) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const float fa[4] = {a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + t + 4], a[(g + 8) * 8 + t + 4]};
  const float fb[2] = {b[t * 8 + g], b[(t + 4) * 8 + g]};
  float fd[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t], c[(g + 8) * 8 + 2 * t + 1]};
  mma_tf32(fd, fa, fb);
  d[g * 8 + 2 * t] = fd[0];
  d[g * 8 + 2 * t + 1] = fd[1];
  d[(g + 8) * 8 + 2 * t] = fd[2];
  d[(g + 8) * 8 + 2 * t + 1] = fd[3];
  for (int i = lane; i < n; i += 32) rounded[i] = tf32_round(x[i]);
}

}  // namespace

// Every pointer a device pointer: a (16, 8), b (8, 8), c and d (16, 8), x and rounded (n,).
extern "C" int ptx_probe(const void* a, const void* b, const void* c, void* d, const void* x, void* rounded, int n,
                         void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  ptx_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(f(a), f(b), f(c), static_cast<float*>(d), f(x),
                                                                    static_cast<float*>(rounded), n);
  return cudaGetLastError();
}
