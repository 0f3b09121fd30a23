// Tensor-core building blocks of the mma.sync attention forward K1
// (attention_fwd.cu: bf16 at head width 128; the f32 K1 at 16-64, 3xTF32 in
// mma_tf32.cuh, shares its copies, mask and keep-bit staging and launch
// helpers), for Hopper (sm_90a); the wgmma kernels take the small helpers
// (smem_u32, pack_bf16, scale_bf16x2, fast_exp2, allow_smem, the
// constants).
//
// Four warps a block, each owning 16 rows of its side as mma.sync m16n8k16
// A fragments in registers; the other side streams through shared memory
// in 64-row tiles of (64, ld_bf16(D)) bf16 by cp.async (16 B a copy,
// double-buffered, tail rows zero-filled) and is read by ldmatrix (.trans
// for the second product's B operand). The f32 accumulators of the first
// product turn, two n-tiles at a time, into the bf16 A fragments of the
// second (mma_cols), never touching memory. The attend bits of the
// (Tq, Tk) int32 static mask OR the (B, Tk) key pad, and the Philox keep
// bits, are staged one byte per (row, 4 keys): keep in the low nibble,
// attend in the high one. Everything that depends on the head width D is a
// template on it: D a multiple of 16 (a k-step of m16n8k16) up to 128, the
// widths the kernel is compiled at (attention_fwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace mmfm {

constexpr float kNegInf = -1e30f;   // ops/attention.py NEG_INF
constexpr float kLseFloor = -1e6f;  // ops/attention.py _LSE_FLOOR

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;      // 4 warps, 16 rows each
constexpr int kTcRows = 64;          // rows per block, and per streamed tile
// shared row pitch in bf16 at head width D: 80 bytes at D = 32; at every D
// a multiple of 16 up to 128 the 8 rows of an ldmatrix hit 8 bank groups
__host__ __device__ constexpr int ld_bf16(int D) { return D + 8; }
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// two 8x8 bf16 matrices; lanes 0-15 give the rows' addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float mul) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16(f.x * mul, f.y * mul);
}

// The mma A fragments of rows [row0, row0 + 16) x D of a bf16 matrix with
// row stride st (rows past T read as 0): f[k][i] holds row gid + 8 (i & 1),
// columns 16 k + 2 tig + 8 (i >> 1) and one more. With kScale the values
// are f32(x) * mul rounded to bf16.
template <int D, bool kScale>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const bf16* base, long long st,
                                             int row0, int T, int lane,
                                             float mul) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + gid + (i & 1) * 8;
      const int col = kk * 16 + tig * 2 + (i >> 1) * 8;
      uint32_t w = 0;
      if (row < T)
        w = *reinterpret_cast<const uint32_t*>(base + (long long)row * st +
                                               col);
      f[kk][i] = kScale ? scale_bf16x2(w, mul) : w;
    }
}

// acc[n][.] += a . tile^T: a (16, D) A fragments, tile rows [0, n_valid)
// of a shared (64, ld_bf16(D)) tile as the 8 n-tiles of B (n-tiles past
// n_valid are skipped: their rows are zero and masked). One ldmatrix.x4
// feeds two k-steps (32 columns); an odd last k-step takes an x2
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4],
                                         const uint32_t (&a)[D / 16][4],
                                         const bf16* tile, int lane,
                                         int n_valid) {
  constexpr int kLd = ld_bf16(D);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= n_valid) break;
    const bf16* row = tile + (nt * 8 + (lane & 7)) * kLd;
#pragma unroll
    for (int k2 = 0; k2 < D / 32; ++k2) {
      uint32_t r[4];
      ldsm_x4(r, smem_u32(row + k2 * 32 + (lane >> 3) * 8));
      mma_bf16(acc[nt], a[2 * k2], r[0], r[1]);
      mma_bf16(acc[nt], a[2 * k2 + 1], r[2], r[3]);
    }
    if (D % 32 != 0) {
      uint32_t r[2];
      ldsm_x2(r, smem_u32(row + D - 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(acc[nt], a[D / 16 - 1], r[0], r[1]);
    }
  }
}

// out[d-tile][.] += p . tile: p the (16, 64) bf16 A fragments built from the
// 16x64 accumulator fragments acc (in registers), tile a shared (64,
// ld_bf16(D)) tile read transposed as B; k-steps past n_valid (p = 0 there)
// skipped
template <int D>
__device__ __forceinline__ void mma_cols(float (&out)[D / 8][4],
                                         const float (&acc)[8][4],
                                         const bf16* tile, int lane,
                                         int n_valid) {
  constexpr int kLd = ld_bf16(D);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (16 * j >= n_valid) break;
    const uint32_t a[4] = {pack_bf16(acc[2 * j][0], acc[2 * j][1]),
                           pack_bf16(acc[2 * j][2], acc[2 * j][3]),
                           pack_bf16(acc[2 * j + 1][0], acc[2 * j + 1][1]),
                           pack_bf16(acc[2 * j + 1][2], acc[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t r[4];
      ldsm_x4_t(r, smem_u32(tile +
                            (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                            16 * dp + (lane >> 4) * 8));
      mma_bf16(out[2 * dp], a, r[0], r[1]);
      mma_bf16(out[2 * dp + 1], a, r[2], r[3]);
    }
  }
}

// 2^x on the MUFU (flushes results below 2^-126 to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The attend bits of 4 positions of the other side, p0 = k0 (bit 4 + i =
// static(q, k0 + i) | key_pad(k0 + i)), 0 past the ends. With vec (Tk % 4
// == 0 and 16-byte aligned masks) one 16-byte load of each mask.
__device__ __forceinline__ unsigned attend_nibble(
    const int* __restrict__ static_mask, const int* __restrict__ pad, int Tq,
    int Tk, int qrow, int k0, bool vec) {
  if (qrow >= Tq || k0 >= Tk) return 0u;
  const int* srow = static_mask + (long long)qrow * Tk;
  if (vec) {
    const int4 s4 = __ldg(reinterpret_cast<const int4*>(srow + k0));
    const int4 p4 = __ldg(reinterpret_cast<const int4*>(pad + k0));
    return (unsigned)((s4.x | p4.x) != 0) << 4 |
           (unsigned)((s4.y | p4.y) != 0) << 5 |
           (unsigned)((s4.z | p4.z) != 0) << 6 |
           (unsigned)((s4.w | p4.w) != 0) << 7;
  }
  unsigned byte = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + i;
    if (key < Tk && ((__ldg(srow + key) != 0) | (__ldg(pad + key) != 0)))
      byte |= 0x10u << i;
  }
  return byte;
}

// The keep bits (low nibble) of keys [k0, k0 + 4) of query qrow in head h:
// one Philox call; all kept without dropout.
template <bool kDropout>
__device__ __forceinline__ unsigned keep_nibble(uint32_t seed,
                                                uint32_t threshold, int b,
                                                int h, int qrow, int k0) {
  return kDropout ? keep_bits4(seed, threshold, b, h, qrow, k0 >> 2)
                  : 0xFu;
}

// Heads a block walks through: the attend bits come from the (Tq, Tk)
// int32 static mask, read from L2 once per block and shared by its heads
// (read per (b, h) block, it was the kernel's largest cost at the training
// step's shape); fewer heads a block where the grid would
// otherwise leave the card's 132 SMs short of two waves.
inline int heads_per_block(int B, int n_tiles, int H) {
  int hpb = H;
  while (hpb % 2 == 0 && (long long)B * n_tiles * (H / hpb) < 1024) hpb /= 2;
  return hpb;
}

// Dynamic shared memory above the default 48 KB needs an opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mmfm
