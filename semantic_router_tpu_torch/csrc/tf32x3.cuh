// Device helpers shared by the port's tensor-core kernels (sm_90a):
// float32 products on the TF32 tensor cores at float32 accuracy (3xTF32),
// asynchronous global -> shared copies, and dtype conversions.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each float32 operand x splits
// into big = x rounded to TF32 (10 explicit mantissa bits) and small =
// x - big; a product is then big*big + big*small + small*big, three
// m16n8k8 TF32 MMAs into one float32 accumulator.  The dropped small*small
// term and small's truncation to TF32 leave ~2^-21 relative error per
// product, float32's order, where one TF32 pass leaves ~2^-11.  A bfloat16
// value is exact in TF32 (8 mantissa bits), so bf16 operands take one
// pass.
//
// mma.sync.m16n8k8.tf32 fragments (PTX ISA; g = lane / 4, c = lane % 4):
//   A 16x8 row-major: a0 (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4)
//   B 8x8 (k x n):    b0 (k=c, n=g), b1 (k=c+4, n=g)
//   C/D 16x8:         d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1)
// Fragments are read from shared memory, so either operand may be stored
// K-major or N-major; each kernel pads its shared-memory rows so that a
// warp's 32 fragment reads fall in 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements of T in one 16-byte vector load / cp.async chunk
template <typename T> __host__ __device__ constexpr int vec_elems() {
  return 16 / sizeof(T);
}

// float32 operands need the 3-pass split; bfloat16 ones are exact in TF32
template <typename T> __host__ __device__ constexpr bool needs_split() {
  return sizeof(T) == 4;
}

// The MMA reads a .tf32 operand's top 19 bits (sign, exponent, 10
// mantissa bits) and ignores the low 13, so no cvt instruction is needed:
// big = x rounded to nearest (ties away from zero, cvt.rna's rounding) by
// adding half a TF32 ulp to the bit pattern and clearing the low bits;
// small = x - big, exact in float32, which the MMA truncates to its top
// bits.  Three full-rate integer/float ops per operand where two cvt.rna
// would run on the slower conversion pipe.  Without SPLIT (bfloat16
// inputs, exact in TF32) big is x's own bits and small is unused.
template <bool SPLIT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  if (SPLIT) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
  }
}

// d += a * b on the tensor cores, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A * B with A = ab + as, B = bb + bs (3xTF32), or ab * bb alone
// when the operands were exact in TF32.  The small terms go first so they
// are not absorbed by the larger partial sum.
template <bool SPLIT>
__device__ __forceinline__ void mma_f32(float (&d)[4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const uint32_t (&bb)[2],
                                        const uint32_t (&bs)[2]) {
  if (SPLIT) {
    mma_tf32(d, as, bb);
    mma_tf32(d, ab, bs);
  }
  mma_tf32(d, ab, bb);
}

// 16-byte global -> shared copy that bypasses the registers; with
// valid == false it writes 16 zero bytes and reads nothing (gmem must
// still be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace srt
