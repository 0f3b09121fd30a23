// What the operand type changes in the tensor-core attention forward K1's
// mma.sync kernel (attention_fwd.cu: f32 at head widths 16-64, bf16 at
// 128), one kernel body for f32 (3xTF32, mma_tf32.cuh) and bf16
// (mma_bf16.cuh): the shared tiles of the streamed side, the A fragments
// held in registers, the two products, how a landed chunk is readied and
// the stores, at head width D (16, 32, 64 or 128: each compiled in its own
// translation unit, attention_fwd*.cu). K1 readies its k/v chunks with
// kScale = false.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace mmfm {

template <typename T, int D>
struct Tc;

template <int D>
struct Tc<bf16, D> {
  static_assert(D % 16 == 0 && D <= 128, "bf16 head width");
  static constexpr int kChunks = D / 8;        // 16-byte copies a row
  static constexpr int kPitch = ld_bf16(D);    // shared row pitch, elements
  static constexpr int kElems = kTcRows * kPitch;  // one buffered tile
  // K1's k/v tile buffers: two, so that the next tile's copy overlaps this
  // one's products (one buffer cost the bf16 training K1 ~3% on the H100)
  static constexpr int kFwdBufs = 2;
  struct Frags {
    uint32_t f[D / 16][4];
  };
  template <bool kScale>
  static __device__ __forceinline__ void load(Frags& a, const bf16* base,
                                              long long st, int row0, int T,
                                              int lane, float mul) {
    load_a_frags<D, kScale>(a.f, base, st, row0, T, lane, mul);
  }
  static __device__ __forceinline__ void rows(float (&acc)[8][4],
                                              const Frags& a,
                                              const bf16* tile, int lane,
                                              int n_valid) {
    mma_rows<D>(acc, a.f, tile, lane, n_valid);
  }
  static __device__ __forceinline__ void cols(float (&out)[D / 8][4],
                                              const float (&acc)[8][4],
                                              const bf16* tile, int lane,
                                              int n_valid) {
    mma_cols<D>(out, acc, tile, lane, n_valid);
  }
  // k and v tiles are used as they land
  template <bool kScale>
  static __device__ __forceinline__ void land(bf16*, float) {
    static_assert(!kScale, "bf16 K1 tiles are not scaled");
  }
  static __device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  }
};

template <int D>
struct Tc<float, D> {
  static_assert(D % 16 == 0 && D <= 128, "f32 head width");
  static constexpr int kChunks = D / 4;
  static constexpr int kPitch = ld_f32(D);
  static constexpr int kElems = 2 * plane_f32(D);  // the hi plane, then lo
  // K1's k/v tile buffers: one. Its ~45 KB of shared memory a block leave
  // the registers (127) to allow 4 blocks an SM, where two buffers' ~81 KB
  // allowed 2: 14-17% faster on the H100, though no copy overlaps a product
  static constexpr int kFwdBufs = 1;
  struct Frags {
    uint32_t hi[D / 8][4], lo[D / 8][4];
  };
  template <bool kScale>
  static __device__ __forceinline__ void load(Frags& a, const float* base,
                                              long long st, int row0, int T,
                                              int lane, float mul) {
    load_a_tf32<D, kScale>(a.hi, a.lo, base, st, row0, T, lane, mul);
  }
  static __device__ __forceinline__ void rows(float (&acc)[8][4],
                                              const Frags& a,
                                              const float* tile, int lane,
                                              int n_valid) {
    mma_rows_3x<D>(acc, a.hi, a.lo, tile, lane, n_valid);
  }
  static __device__ __forceinline__ void cols(float (&out)[D / 8][4],
                                              const float (&acc)[8][4],
                                              const float* tile, int lane,
                                              int n_valid) {
    mma_cols_3x<D>(out, acc, tile, lane, n_valid);
  }
  // every tile split into hi and lo planes (q times scale first)
  template <bool kScale>
  static __device__ __forceinline__ void land(float* p, float mul) {
    land_split<D, kScale>(p, mul);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

}  // namespace mmfm
