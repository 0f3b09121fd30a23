// Counter-based dropout bits shared by K1 (attention_fwd.cu,
// attention_fwd_bf16.cuh) and K2 (attention_bwd.cu, attention_bwd_bf16.cuh).
//
// Philox4x32-10 (Salmon et al., SC'11), keyed by the attention call's seed.
// The keep decision for score (b, h, q, k) is a pure function of those four
// indices and the seed: word (k & 3) of philox(counter = (k >> 2, q, h, b),
// key = (seed, 0)). Nothing depends on the tiling, so the backward replays
// the forward's mask at any block shape. ``ops/attention.py::philox_keep``
// draws the same bits with torch integer operations.
//
// The keep test is the JAX package's (multi_modal_foundation_model_tpu/
// ops/attention.py:129-133): keep iff bits > uint32(rate * (2^32 - 1)),
// with the threshold computed on the host.

#pragma once

#include <stdint.h>

namespace mmfm {

struct Philox4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return Philox4{c0, c1, c2, c3};
}

// Keep bits of the 4 keys [4 k4, 4 k4 + 4) of row (b, h, q), bit j = key
// 4 k4 + j: one Philox call.
__device__ __forceinline__ uint32_t keep_bits4(uint32_t seed,
                                               uint32_t threshold, int b,
                                               int h, int q, int k4) {
  const Philox4 r = philox4x32_10((uint32_t)k4, (uint32_t)q, (uint32_t)h,
                                  (uint32_t)b, seed, 0u);
  return (uint32_t)(r.x > threshold) | (uint32_t)(r.y > threshold) << 1 |
         (uint32_t)(r.z > threshold) << 2 | (uint32_t)(r.w > threshold) << 3;
}

// The keep bytes of queries [4 qw, 4 qw + 4) (none at or past Tq) of row
// (b, h), keys [8 kb, 8 kb + 8), as one word: byte u holds query 4 qw + u,
// bit i key 8 kb + i. The layout mask[b][h][kb][q] that the bf16 K1 and K2
// on wgmma draw into once (attn_fwd_keep_kernel, attn_bwd_keep_kernel) and
// read by TMA: 8 Philox calls.
__device__ __forceinline__ uint32_t keep_word(uint32_t seed,
                                              uint32_t threshold, int b,
                                              int h, int qw, int kb, int Tq) {
  uint32_t word = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int q = 4 * qw + u;
    if (q >= Tq) break;
    // two calls a byte, keys past Tk in the last one drawn and never read
    // (skipping them, a branch a call, took the K2 keep kernel 21% longer
    // on the H100: scripts/torch_k2_variants.py, keep_below_tk)
    const uint32_t lo = keep_bits4(seed, threshold, b, h, q, 2 * kb);
    const uint32_t hi = keep_bits4(seed, threshold, b, h, q, 2 * kb + 1);
    word |= (lo | hi << 4) << (8 * u);
  }
  return word;
}

}  // namespace mmfm
