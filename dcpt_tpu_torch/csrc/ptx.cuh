// The PTX that the port's tensor-core kernels use, each instruction behind one
// small device function: the m16n8k8 TF32 mma.sync, and cp.async with its
// commit and wait; beside them the TF32 rounding they split fp32 operands
// with.  The CPU emulation (tools/cuda_emu/include/ptx.cuh) supplies the same
// functions, warp-collective where the instruction is, so a kernel built on
// them runs under g++ too.
//
// mma_tf32's fragments are the PTX ISA's for mma.m16n8k8 with .tf32 operands.
// With g = lane / 4 and t = lane % 4:
//   a[0] = A(g, t)      a[1] = A(g + 8, t)      a[2] = A(g, t + 4)      a[3] = A(g + 8, t + 4)
//   b[0] = B(t, g)      b[1] = B(t + 4, g)
//   d[0] = D(g, 2t)     d[1] = D(g, 2t + 1)     d[2] = D(g + 8, 2t)     d[3] = D(g + 8, 2t + 1)
// A is 16 x 8 (rows x depth), B 8 x 8 (depth x columns), D 16 x 8.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to TF32 (to nearest, ties away from zero, on the 13 low mantissa
// bits), as an fp32 value whose 13 low bits are zero: for finite x the bits of
// cvt.rna.tf32.f32, in two integer operations, which cost the kernels less
// than the conversion instruction.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// d += a . b on one warp's fragments of a 16 x 8 x 8 TF32 product, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// Copy kBytes (16, 8 or 4) from global src to shared dst without the registers:
// the first src_bytes of them from src, the rest zeros (src_bytes 0 reads
// nothing).  Both addresses aligned to kBytes.  Visible to this thread after
// cp_async_wait, to the block after a barrier that follows it.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4, "cp.async copies 16, 8 or 4 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// Close the group of this thread's cp_async calls since the last commit.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `pending` of this thread's committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace
