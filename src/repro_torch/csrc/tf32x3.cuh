// 3xTF32 products on Hopper's tensor cores: f32 at f32-class accuracy.
//
// Each f32 operand x is split as hi = tf32(x) and lo = tf32(x − hi), and a
// product a·b is summed as a_lo·b_hi + a_hi·b_lo, then a_hi·b_hi, into f32
// accumulators by mma.sync.m16n8k8 TF32 (the lo·lo term, ~2^-22 relative,
// is dropped).  Shared by flash_attention.cu (#8) and ssd_chunk.cu (#9).
// Compile with -fmad=false so that x − hi stays a plain subtraction.
#pragma once

#include <stdint.h>

namespace {

// The operands of the split, as the tensor cores read them: hi = tf32(x),
// lo = tf32(x − hi), with tf32 rounding to 10 mantissa bits to nearest, ties
// away from zero (cvt.rna.tf32.f32).  A TF32 operand's 13 low bits are
// ignored by the tensor cores, so adding half a TF32 ulp (1 << 12) to the
// bits is that rounding (CUTLASS's round_half_ulp_truncate, which its 3xTF32
// products use, rests on the same); the bits are cleared only where hi
// enters x − hi.  Four integer and float ops.  EXACT (x already a TF32
// value, as bf16 inputs are): hi = x, lo unused.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
  } else {
    hi = __float_as_uint(x) + 0x1000u;
    lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
  }
}

// d += a·b: one m16n8k8 TF32 product, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: a_lo·b_hi, a_hi·b_lo, then a_hi·b_hi; an EXACT
// operand has no lo part and its term is left out
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  if (!EXACT_A) mma(d, al, bh0, bh1);
  if (!EXACT_B) mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

}  // namespace
