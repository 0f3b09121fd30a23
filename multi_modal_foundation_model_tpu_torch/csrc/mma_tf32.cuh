// The TF32 split of the f32 attention kernels' 3xTF32 products, for Hopper
// (sm_90a): K1 (attention_fwd_f32.cuh, attention_fwd_f32_d128.cuh) and K2
// (attention_bwd_f32.cuh, attention_bwd_f32_d128.cuh) on TF32 wgmma
// (wgmma_tf32.cuh).
//
// f32 products at about f32 accuracy on the TF32 tensor cores: each f32 operand
// x splits into hi = tf32(x) and lo = tf32(x - hi) (rounded to nearest, ties
// away: tf32_rna below), and each k-step of 8 of a . b is three TF32 products,
// the small terms first: al . bh, ah . bl, then ah . bh (al . bl, ~2^-22 of the
// product, is dropped), summed from zero and added to the f32 running sum
// (wgmma_tf32.cuh mma3_ss / mma3_rs). The tensor cores truncate the f32 sums of
// a product (round toward zero), so chaining every term into the running sum
// biases it by up to an ulp a term: with 3 terms x 25 k-steps over 200 queries,
// dk missed the 1e-5 gate on the H100 (Tq = 200, Tk = 17). Summed from zero, a
// k-step's truncation is relative to its own 8 products, and the running sum is
// rounded to nearest. One-term TF32 keeps ~3 decimal digits; the three terms
// keep the f32 contract of the attention forward and backward (1e-5 against the
// f32 plain versions; emulated on the CPU by tests/tf32_emulation.py, held by
// tests/test_torch_attention_fwd_f32.py and
// tests/test_torch_attention_bwd_f32.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mmfm {

// tf32(x) rounded to nearest, ties away from zero, as f32 bits with the
// low 13 mantissa bits 0: half an ulp of tf32 added to the magnitude's bits,
// the low 13 cleared. The bits of cvt.rna.tf32.f32 for every finite f32 and
// infinity (a finite x that rounds past the largest tf32 becomes an
// infinity, as there). Not a NaN's: its bits plus half an ulp may carry into
// the exponent or the sign (0x7FFFFFFF becomes -0); split_tf32 keeps a NaN.
// Integer ops, where cvt.rna takes the conversion unit (with cvt.rna the f32
// K1 at head width 32 took 8-10% longer, scripts/torch_k1_variants.py
// cvt_split).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both tf32, the bits of cvt.rna's split for every finite f32
// and infinity. lo rounds x - hi, an arithmetic result: for a NaN or an
// infinite x it is the card's canonical NaN 0x7FFFFFFF, which the signed
// min keeps a NaN (0x7FFFE000, where tf32_rna would make it -0); every
// finite or infinite x - hi lies below the min's bound. So a NaN or an
// infinite operand gives NaN products, whatever hi holds, as with cvt.rna
// (all 2^32 patterns checked on the card by scripts/torch_tf32_rna_check.py).
// One integer op more than tf32_rna of lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  const int r = __float_as_int(x - __uint_as_float(hi));
  lo = ((uint32_t)min(r, 0x7FFFDFFF) + 0x1000u) & 0xFFFFE000u;
}

}  // namespace mmfm
