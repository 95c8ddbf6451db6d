// 3xTF32 on the tensor cores, for K13 (flash_attention.cu) and K14
// (ssd_chunk.cu): an f32 product as three TF32 products on
// ``mma.sync.m16n8k8``.  Each f32 operand x splits into big =
// cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big); the f32 accumulator
// takes small.big, big.small, then big.big (small.small, about 2^-22 of
// the product, is dropped).
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A holds rows g and
// g + 8 at k-slots t and t + 4 (a[0] (g, t), a[1] (g + 8, t), a[2]
// (g, t + 4), a[3] (g + 8, t + 4)); B holds k-slots t and t + 4 of column
// g; the accumulator holds columns 2t, 2t + 1 of rows g (c[0], c[1]) and
// g + 8 (c[2], c[3]).  A dot product takes its k order from the caller:
// any order serves, as long as A and B agree on it.
#pragma once

#include <cuda_runtime.h>

namespace {

// cvt.rna.tf32.f32 for finite x (a quiet NaN stays NaN): half a TF32
// ulp added to the magnitude, the 13 low bits cleared.  Two integer
// operations; the PTX cvt compiles to a longer sequence on sm_90
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 2^x; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = big + small, each a TF32 value in an f32 container
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// an A fragment (rows g, g + 8 at k-slot t, then at t + 4) split once
// for all the products it takes part in
struct AFrag {
  unsigned big[4], small[4];
  __device__ __forceinline__ explicit AFrag(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
  }
};

// c += a . b in 3xTF32 with b already split (bb its big parts at k-slots
// t and t + 4, bs its small parts); the small products first
__device__ __forceinline__ void mma3s(float (&c)[4], const AFrag& a,
                                      const unsigned (&bb)[2],
                                      const unsigned (&bs)[2]) {
  mma(c, a.small, bb);
  mma(c, a.big, bs);
  mma(c, a.big, bb);
}

// c += a . b in 3xTF32, b the f32 values at k-slots t and t + 4
__device__ __forceinline__ void mma3(float (&c)[4], const AFrag& a, float b0,
                                     float b1) {
  unsigned bb[2], bs[2];
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
  mma3s(c, a, bb, bs);
}

}  // namespace
