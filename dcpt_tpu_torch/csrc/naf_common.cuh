// The NAFBlock passes that three CUDA sources share: K1 (naf_block.cu, the
// whole block), K4 (naf_prefix.cu, LN1 -> W1 -> depthwise 3x3 -> gate) and K5
// (naf_ffn.cu, LN2 -> W4 -> gate -> W5 -> residual).  Each runs its 1x1
// products on the tensor cores (tc_gemm.cuh, through token_bwd.cuh's
// product_epi) with these epilogues, and K1 and K4 their depthwise 3x3 and
// SimpleGate with naf_gate_kernel:
//
//   ExpandEpi   t = acc + b1 (W1, C -> 2C), fp32
//   GateEpi     W4 read as a paired operand (2j <- j, 2j + 1 <- C + j), so that
//               h[j] and h[C + j] are one column pair: hidden = h1 h2, fp32
//   OutEpi      o = acc + b5, z = y + gamma * o in the I/O type; y fp32 (K1's
//               own) or in the I/O type (K5's input)
//   gate        per (image row segment, 32 gate channels): the depthwise 3x3
//               of t on channels j and C + j, zero outside the image, with its
//               bias, then g = a b in the I/O type; with part, each segment's
//               channel sums of g (K1's SCA; K4 passes null)
//
// Every kernel is templated on Owner, the number of the kernel that launches
// it, as token_bwd.cuh's are, so a profile tells K1's, K4's and K5's launches
// apart.  Weights come in PyTorch's layout: every 1x1 as (out, in) row-major,
// the depthwise 3x3 as (2C, 3, 3).  Every C is taken: ragged channels, rows
// and segments are masked.
#pragma once

#include "common.cuh"
#include "tc_gemm.cuh"
#include "token_bwd.cuh"

namespace {

constexpr int kRowC = 32;  // gate: channels of a block (a warp's lanes)
constexpr int kSeg = 32;   // gate: pixels of an image row a thread walks

__host__ __device__ inline int num_segments(int W) { return (W + kSeg - 1) / kSeg; }

inline size_t round64(size_t floats) { return (floats + 63) / 64 * 64; }  // 256-byte aligned offsets

// Offsets of the stretches of a kernel's fp32 scratch, each 256-byte aligned;
// off ends as the floats the whole takes.
struct ScratchPlan {
  size_t off = 0;
  size_t take(size_t floats) {
    const size_t at = off;
    off += round64(floats);
    return at;
  }
};

// gate: one thread a gate channel j walks kSeg pixels of an image row
// (dw3x3_walk): a = dw(t)[j] + bdw[j], b = dw(t)[C + j] + bdw[C + j] (t zero
// outside the image), g = a b, and with part the segment's sum of g into part
// (B, H * segments, C).  A block: kRowC channels x kThreads / kRowC (row,
// segment) pairs; grid (pair tiles, channel tiles, B).
template <int Owner, typename T>
__global__ void __launch_bounds__(kThreads)
naf_gate_kernel(const float* __restrict__ t, const T* __restrict__ wdw, const T* __restrict__ bdw, T* __restrict__ g,
                float* __restrict__ part, int H, int W, int C, int nseg) {
  const int j = blockIdx.y * kRowC + threadIdx.x % kRowC;
  const int rs = blockIdx.x * (kThreads / kRowC) + threadIdx.x / kRowC;
  if (j >= C || rs >= H * nseg) return;
  const int y = rs / nseg, x0 = (rs % nseg) * kSeg;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int ch[2] = {j, C + j};
  const float bias[2] = {ld(bdw[j]), ld(bdw[C + j])};
  float psum = 0.f;
  dw3x3_walk<2>(t, wdw, ch, bias, img, y, x0, min(W, x0 + kSeg), H, W, 2 * C, [&](int x, const float (&s)[2]) {
    const float gv = s[0] * s[1];
    psum += gv;
    g[(img + (size_t)y * W + x) * C + j] = st<T>(gv);
  });
  if (part) part[((size_t)blockIdx.z * H * nseg + rs) * C + j] = psum;
}

// The gate over t (B, H, W, 2C) fp32 into g (B, H, W, C) on ``stream``; part,
// the segment sums (B, H * num_segments(W), C), may be null.
template <int Owner, typename T>
cudaError_t naf_gate(const float* t, const T* wdw, const T* bdw, T* g, float* part, int B, int H, int W, int C,
                     cudaStream_t stream) {
  const int nseg = num_segments(W), per = kThreads / kRowC;
  naf_gate_kernel<Owner, T><<<dim3((H * nseg + per - 1) / per, (C + kRowC - 1) / kRowC, B), kThreads, 0, stream>>>(
      t, wdw, bdw, g, part, H, W, C, nseg);
  return cudaGetLastError();
}

// t = acc + b1: W1's epilogue
template <typename T>
struct ExpandEpi {
  const T* b1;
  float* t;
  int N;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    store_pair(t + (size_t)r * N + n, v0 + ld(b1[n]), v1 + ld(b1[n + 1]), true);  // N = 2C: even
  }
};

// W4's epilogue on the paired rows: column pair (2j, 2j + 1) is h1 = h[j] and
// h2 = h[C + j] less their biases; hidden = h1 h2 (and h_out in the layout [h1 | h2])
template <typename T>
struct GateEpi {
  const T* b4;
  float *hidden, *h_out;
  int C;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    const int j = n / 2;
    const float h1 = v0 + ld(b4[j]), h2 = v1 + ld(b4[C + j]);
    hidden[(size_t)r * C + j] = h1 * h2;
    if (h_out) {
      h_out[(size_t)r * 2 * C + j] = h1;
      h_out[(size_t)r * 2 * C + C + j] = h2;
    }
  }
};

// o = acc + b5, z = y + gamma * o in the I/O type T (and o_out): W5's
// epilogue; y in TY, fp32 or T; column n + 1 masked at C
template <typename T, typename TY>
struct OutEpi {
  const TY* y;
  const T *b5, *gamma;
  T* z;
  float* o_out;
  int C;
  __device__ __forceinline__ void operator()(int, int r, int n, float v0, float v1) const {
    const size_t q = (size_t)r * C + n;
    const bool two = n + 1 < C;
    const float o0 = v0 + ld(b5[n]), o1 = two ? v1 + ld(b5[n + 1]) : 0.f;
    z[q] = st<T>(ld(y[q]) + ld(gamma[n]) * o0);
    if (two) z[q + 1] = st<T>(ld(y[q + 1]) + ld(gamma[n + 1]) * o1);
    if (o_out) store_pair(o_out + q, o0, o1, two);
  }
};

}  // namespace
