// Counter-based dropout bits shared by K1 (attention_fwd.cu) and K2
// (attention_bwd.cu).
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

}  // namespace mmfm
