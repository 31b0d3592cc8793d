// Helpers shared by the tensor-core kernels for Hopper (sm_90a): the 3xTF32
// split of a float32 operand, mma.sync m16n8k8 on TF32 operands, and
// cp.async.  Used by conv3x3_tile.cuh (the 3x3 convolutions) and
// filterbank.cu (the orientation filter bank).
//
// 3xTF32.  TF32 keeps 10 mantissa bits; one pass would keep about three
// digits.  Each operand x is split as big = tf32(x), small = x - big, and
// each product is accumulated as small*big + big*small + big*big in float32:
// the dropped small*small term is ~2^-22 of the product, the error of a
// float32 FMA.  The tensor cores add with truncation, not rounding, so a
// caller sums a bounded run of products into fresh registers (mma_tf32_first
// starts the run) and adds the run to its running sums with ordinary rounded
// float32 adds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// (big, small) with x = big + small: big is x rounded to TF32 (to nearest,
// ties away: the integer form of cvt.rna.tf32.f32, which runs faster than
// the conversion instruction), small the exact float32 rest, handed to the
// tensor cores as it is: they read an operand's TF32 bits.  Rounding small
// to TF32 first (two more integer instructions) measured the same error
// against float64 and 5-6% more time (tools/tile_variants.py).
__device__ __forceinline__ uint2 split_tf32(float x) {
  const unsigned big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return make_uint2(big, __float_as_uint(x - __uint_as_float(big)));
}

// d += a * b on one m16n8k8 TF32 tile, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b on one m16n8k8 TF32 tile: the first product of a fresh chain.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}

}  // namespace tf32x3
