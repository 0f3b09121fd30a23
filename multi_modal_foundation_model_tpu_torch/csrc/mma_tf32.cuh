// 3xTF32 tensor-core building blocks of the f32 attention kernels K1
// (attention_fwd.cu) and K2 (attention_bwd.cu), for Hopper (sm_90a).
//
// f32 products at about f32 accuracy on the TF32 tensor cores: each f32
// operand x splits into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round
// to nearest, ties away), and each k-step of 8 of a . b is three
// mma.sync.m16n8k8 TF32 products, the small terms first: al . bh, ah . bl,
// then ah . bh (al . bl, ~2^-22 of the product, is dropped), summed from
// zero and added to the f32 accumulator (mma_3xtf32). One-term TF32 keeps
// ~3 decimal digits; the three terms keep the f32 contract of the attention
// forward and backward (1e-5 against the f32 plain versions; emulated on
// the CPU by tests/tf32_emulation.py, held by
// tests/test_torch_attention_fwd_f32.py and
// tests/test_torch_attention_bwd_f32.py).
//
// Fragments of m16n8k8 (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32),
// gid = lane / 4, tig = lane % 4:
//   A (16 x 8, row): a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
//                    a3 (gid + 8, tig + 4)
//   B (8 x 8, col):  b0 (k = tig, n = gid), b1 (k = tig + 4, n = gid)
//   C (16 x 8, f32): c0, c1 (gid, 2 tig + {0, 1}), c2, c3 (gid + 8, ...)
// An accumulator holds columns (2 tig, 2 tig + 1) where an A fragment holds
// (tig, tig + 4), so a 16 x 8 accumulator becomes the A fragment of the
// next product (k = its 8 columns) with the k index permuted: A slot tig
// takes column 2 tig, slot tig + 4 column 2 tig + 1, and the B rows are
// read from shared memory in the same order (mma_cols_3x).
//
// The streamed side lives in shared memory as two planes of a (64,
// ld_f32(D)) f32 tile, hi then lo, split once when the tile lands
// (land_split). With a pitch of D + 4 floats (36 at D = 32), the B reads of
// both products -- tile[n0 + gid][k0 + tig] (mma_rows_3x) and tile[k0 +
// 2 tig (+1)][n0 + gid] (mma_cols_3x) -- fall on 32 distinct banks at every
// D a multiple of 8 up to 128 (the row pitch is 4 or 20 banks mod 32). ldmatrix
// moves 16-bit 8x8 matrices, so the f32 B fragments are plain 32-bit shared
// loads. The head width D is a template parameter, as in mma_bf16.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mmfm {

// shared row pitch in floats, and one (64, pitch) f32 plane, at width D
__host__ __device__ constexpr int ld_f32(int D) { return D + 4; }
__host__ __device__ constexpr int plane_f32(int D) {
  return kTcRows * ld_f32(D);
}

// tf32(x) rounded to nearest (ties away), as f32 bits with the low 13
// mantissa bits 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a . b: a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (ah + al) . (bh + bl) to about f32 accuracy: the three products of
// one k-step summed from zero, small terms first, then added to c by an f32
// add. The tensor cores truncate the f32 sums of an mma (round toward
// zero), so chaining every term into the running sum c biases it by up to
// an ulp of c a term: with 3 terms x 25 k-steps over 200 queries, dk missed
// the 1e-5 gate on the H100 (Tq = 200, Tk = 17). Summed from zero, a
// k-step's truncation is relative to its own 8 products, and c is rounded
// to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, al, bh0, bh1);
  mma_tf32(p, ah, bl0, bl1);
  mma_tf32(p, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

// The A fragments of rows [row0, row0 + 16) x D of an f32 matrix with row
// stride st (rows past T read as 0), times mul (f32 rounding) and split:
// hi/lo[ks][i] hold row gid + 8 (i & 1), column 8 ks + tig + 4 (i >> 1).
template <int D, bool kScale>
__device__ __forceinline__ void load_a_tf32(uint32_t (&hi)[D / 8][4],
                                            uint32_t (&lo)[D / 8][4],
                                            const float* base, long long st,
                                            int row0, int T, int lane,
                                            float mul) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + gid + (i & 1) * 8;
      const int col = ks * 8 + tig + (i >> 1) * 4;
      float x = 0.f;
      if (row < T) x = base[(long long)row * st + col];
      split_tf32(kScale ? x * mul : x, hi[ks][i], lo[ks][i]);
    }
}

// acc[n][.] += a . tile^T: a the (16, D) split A fragments, tile rows
// [0, n_valid) of a shared (64, ld_f32(D)) hi plane (lo plane after it) as
// the 8 n-tiles of B (n-tiles past n_valid are skipped: their rows are zero
// and masked)
template <int D>
__device__ __forceinline__ void mma_rows_3x(float (&acc)[8][4],
                                            const uint32_t (&ah)[D / 8][4],
                                            const uint32_t (&al)[D / 8][4],
                                            const float* tile, int lane,
                                            int n_valid) {
  constexpr int kLdF = ld_f32(D), kPlaneF = plane_f32(D);
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t* t = reinterpret_cast<const uint32_t*>(tile) + gid * kLdF +
                      tig;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= n_valid) break;
    const uint32_t* r = t + nt * 8 * kLdF;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      mma_3xtf32(acc[nt], ah[ks], al[ks], r[ks * 8], r[ks * 8 + 4],
                 r[kPlaneF + ks * 8], r[kPlaneF + ks * 8 + 4]);
  }
}

// out[d-tile][.] += p . tile: p the (16, 64) accumulator fragments acc (in
// registers, split here), tile a shared (64, ld_f32(D)) hi plane (lo after
// it) as B, its rows read in the permuted k order; k-steps past n_valid
// (p = 0 there) skipped
template <int D>
__device__ __forceinline__ void mma_cols_3x(float (&out)[D / 8][4],
                                            const float (&acc)[8][4],
                                            const float* tile, int lane,
                                            int n_valid) {
  constexpr int kLdF = ld_f32(D), kPlaneF = plane_f32(D);
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t* t = reinterpret_cast<const uint32_t*>(tile) +
                      2 * tig * kLdF + gid;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= n_valid) break;
    uint32_t ah[4], al[4];
    // slot tig = column 2 tig (c0 / c2), slot tig + 4 = 2 tig + 1 (c1 / c3)
    split_tf32(acc[nt][0], ah[0], al[0]);
    split_tf32(acc[nt][2], ah[1], al[1]);
    split_tf32(acc[nt][1], ah[2], al[2]);
    split_tf32(acc[nt][3], ah[3], al[3]);
    const uint32_t* r = t + nt * 8 * kLdF;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      mma_3xtf32(out[dt], ah, al, r[dt * 8], r[kLdF + dt * 8],
                 r[kPlaneF + dt * 8], r[kPlaneF + kLdF + dt * 8]);
  }
}

// A landed 16-byte chunk (4 floats) at p of a hi plane, times mul with
// kScale, split in place: hi stays at p, lo goes to p + plane_f32(D)
template <int D, bool kScale>
__device__ __forceinline__ void land_split(float* p, float mul) {
  constexpr int kPlaneF = plane_f32(D);
  float4 x = *reinterpret_cast<const float4*>(p);
  if (kScale) {
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
  }
  uint4 hi, lo;
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(p) = hi;
  *reinterpret_cast<uint4*>(p + kPlaneF) = lo;
}

}  // namespace mmfm
