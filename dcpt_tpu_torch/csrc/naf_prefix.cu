// NAFBlock attention-branch prefix on Hopper (sm_90a): SIMT fp32 math, fp32 or bf16 I/O.
//
// Replaces the TPU kernel dcpt_tpu/ops/naf_prefix.py::naf_prefix (_kernel): on a
// (B, H, W, C) channels-last map, LN (fp32 statistics, biased variance) ->
// 1x1 C->DW (+b1) -> depthwise 3x3 with zero padding (+bdw) -> SimpleGate,
// giving (B, H, W, DW/2), DW = 2C.  dcpt_tpu runs it at every c = 512 NAFBlock
// under DCPT_TPU_PALLAS=1 when the whole-block kernel is not taken.
//
// It is naf_common.cuh::naf_p1_kernel without the SCA tile sums: per (batch,
// 6x14 output tile with a 1-pixel halo, 64 gate channels) one block
// normalises the halo pixels, expands them to its 2 x 64 channels of t
// in shared memory, zeroes t outside the image (the dwconv's padding), runs the
// stencil and the gate, and writes the tile's gated channels.  The TPU kernel
// holds the whole (H, W, 2C) map in VMEM and so runs only where it fits
// (prefix_fits, a 10 MB budget); tiles with a halo need no such guard: any
// H x W is taken, ragged tiles masked.
//
// What bounds it on this card: the expand's 2 C^2 multiply-adds per pixel
// (plus the 3x3 stencil's 18 C), i.e. arithmetic, on the SIMT fp32 pipes from
// shared memory (gemm.cuh's product); the halo recomputes the expand on
// 128 / 84 = 1.5x the pixels it writes.  x is read and g written once in the
// I/O type; t never reaches device memory.  wgmma/TMA tiles come later.

#include "naf_common.cuh"

// Plain C entry points (loaded with ctypes).  Device pointers: x (B, H, W, C),
// n1w, n1b (C), w1 (2C, C) (PyTorch's (out, in)), b1 (2C), wdw (2C, 3, 3),
// bdw (2C), g (B, H, W, C) out, all in the I/O type; C a multiple of 64.
// Returns cudaGetLastError().
#define NAF_PREFIX_ARGS                                                                                       \
  const void *x, const void *n1w, const void *n1b, const void *w1, const void *b1, const void *wdw,         \
      const void *bdw, void *g, int B, int H, int W, int C, float eps, void *stream
#define NAF_PREFIX_PASS(T)                                                                                    \
  static_cast<const T*>(x), static_cast<const T*>(n1w), static_cast<const T*>(n1b), static_cast<const T*>(w1), \
      static_cast<const T*>(b1), static_cast<const T*>(wdw), static_cast<const T*>(bdw), static_cast<T*>(g),  \
      nullptr, nullptr, B, H, W, C, eps, static_cast<cudaStream_t>(stream)

extern "C" int naf_prefix_f32(NAF_PREFIX_ARGS) { return launch_p1<float>(NAF_PREFIX_PASS(float)); }
extern "C" int naf_prefix_bf16(NAF_PREFIX_ARGS) { return launch_p1<__nv_bfloat16>(NAF_PREFIX_PASS(__nv_bfloat16)); }
