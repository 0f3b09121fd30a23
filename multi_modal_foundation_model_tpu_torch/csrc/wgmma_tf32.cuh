// Hopper building blocks of the f32 attention kernels on wgmma (K1:
// attention_fwd_f32.cuh, attention_fwd_f32_d128.cuh at head width 128; K2:
// attention_bwd_f32.cuh, attention_bwd_f32_d128.cuh): TF32 wgmma, for
// sm_90a, and the f32 tensor maps.
// The mbarriers, TMA loads, fences and descriptors are those of the bf16
// kernels (wgmma_bf16.cuh).
//
// - wgmma.mma_async .tf32: a warpgroup multiplies a 64-row A by a B of N
//   columns over a k-step of 8, f32 accumulated in registers. PTX allows
//   no transposed operand for 32-bit types: A (shared memory or registers)
//   and B (shared memory) are both K-major, the k index contiguous.
// - A from registers holds each warp's 16 rows as the mma.sync m16n8k8
//   TF32 A fragment: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
//   (g + 8, t + 4) for lane = 4 g + t. An accumulator holds columns 2 t
//   and 2 t + 1 of each n8 block, so an accumulator turns into the next
//   product's A with the k order of each block of 8 permuted (slot t takes
//   column 2 t, slot t + 4 column 2 t + 1): to_frags_tf32, and the B plane
//   written in the same order (attention_bwd_f32.cuh, split).
// - f32 tiles in shared memory are rows of at most 32 floats (128 bytes,
//   one 128-byte swizzle atom; 64 bytes and the 64-byte swizzle at D = 16);
//   a D = 64 tile is two such column blocks, a D = 128 tile four.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace mmfm {
namespace wgtf {

// d (64 x 104, f32) = or += A . B^T: A (64 x 8) and B (104 x 8) tf32,
// both K-major in shared memory (descriptors da, db)
__device__ __forceinline__ void mma_ss_n104(float (&d)[52], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "%52, %53, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 56, f32) = or += A . B^T: A (64 x 8) and B (56 x 8) tf32,
// both K-major in shared memory (descriptors da, db)
__device__ __forceinline__ void mma_ss_n56(float (&d)[28], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "%28, %29, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 40, f32) = or += A . B^T: A (64 x 8) and B (40 x 8) tf32,
// both K-major in shared memory (descriptors da, db)
__device__ __forceinline__ void mma_ss_n40(float (&d)[20], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 24, f32) = or += A . B^T: A (64 x 8) and B (24 x 8) tf32,
// both K-major in shared memory (descriptors da, db)
__device__ __forceinline__ void mma_ss_n24(float (&d)[12], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16, f32) = or += A . B: A (64 x 8) tf32 in registers (each
// warp's 16 rows as the mma.sync m16n8k8 A fragment), B (8 x 16) tf32
// K-major in shared memory (descriptor db)
__device__ __forceinline__ void mma_rs_n16(float (&d)[8],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 32, f32) = or += A . B: A (64 x 8) tf32 in registers (each
// warp's 16 rows as the mma.sync m16n8k8 A fragment), B (8 x 32) tf32
// K-major in shared memory (descriptor db)
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 48, f32) = or += A . B: A (64 x 8) tf32 in registers (each
// warp's 16 rows as the mma.sync m16n8k8 A fragment), B (8 x 48) tf32
// K-major in shared memory (descriptor db)
__device__ __forceinline__ void mma_rs_n48(float (&d)[24],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 64, f32) = or += A . B: A (64 x 8) tf32 in registers (each
// warp's 16 rows as the mma.sync m16n8k8 A fragment), B (8 x 64) tf32
// K-major in shared memory (descriptor db)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// the products at the N of the accumulator d
__device__ __forceinline__ void mma_ss(float (&d)[52], uint64_t da,
                                       uint64_t db, int accumulate) {
  mma_ss_n104(d, da, db, accumulate);
}
__device__ __forceinline__ void mma_ss(float (&d)[28], uint64_t da,
                                       uint64_t db, int accumulate) {
  mma_ss_n56(d, da, db, accumulate);
}
__device__ __forceinline__ void mma_ss(float (&d)[20], uint64_t da,
                                       uint64_t db, int accumulate) {
  mma_ss_n40(d, da, db, accumulate);
}
__device__ __forceinline__ void mma_ss(float (&d)[12], uint64_t da,
                                       uint64_t db, int accumulate) {
  mma_ss_n24(d, da, db, accumulate);
}
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  mma_rs_n16(d, a, db, accumulate);
}
__device__ __forceinline__ void mma_rs(float (&d)[16],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  mma_rs_n32(d, a, db, accumulate);
}
__device__ __forceinline__ void mma_rs(float (&d)[24],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  mma_rs_n48(d, a, db, accumulate);
}
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  mma_rs_n64(d, a, db, accumulate);
}

// d = (ah + al) . (bh + bl) over one k-step, from zero, small terms first
// (al . bh, ah . bl, then ah . bh; al . bl dropped): the caller adds d to
// its running sum in f32 (the tensor cores truncate their sums, so nothing
// is chained into a running sum). Operands in shared memory (descriptors of
// the hi and lo planes).
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N], uint64_t ah,
                                        uint64_t al, uint64_t bh,
                                        uint64_t bl) {
  mma_ss(d, al, bh, 0);
  mma_ss(d, ah, bl, 1);
  mma_ss(d, ah, bh, 1);
}

// two independent k-steps of mma3_ss, d and e (each from zero, each the
// same three terms in the same order), their terms issued alternately
template <int N>
__device__ __forceinline__ void mma3_ss2(float (&d)[N], uint64_t ah,
                                         uint64_t al, uint64_t bh,
                                         uint64_t bl, float (&e)[N],
                                         uint64_t ch, uint64_t cl,
                                         uint64_t fh, uint64_t fl) {
  mma_ss(d, al, bh, 0);
  mma_ss(e, cl, fh, 0);
  mma_ss(d, ah, bl, 1);
  mma_ss(e, ch, fl, 1);
  mma_ss(d, ah, bh, 1);
  mma_ss(e, ch, fh, 1);
}

// the same with A in registers (hi and lo fragments)
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint64_t bh,
                                        uint64_t bl) {
  mma_rs(d, al, bh, 0);
  mma_rs(d, ah, bl, 1);
  mma_rs(d, ah, bh, 1);
}

// two independent k-steps of mma3_rs, d and e (each from zero, each the
// same three terms in the same order), their terms issued alternately: a
// term of one waits on its own last term while the other's runs
template <int N, int M>
__device__ __forceinline__ void mma3_rs2(
    float (&d)[N], const uint32_t (&ah)[4], const uint32_t (&al)[4],
    uint64_t bh, uint64_t bl, float (&e)[M], const uint32_t (&ch)[4],
    const uint32_t (&cl)[4], uint64_t fh, uint64_t fl) {
  mma_rs(d, al, bh, 0);
  mma_rs(e, cl, fh, 0);
  mma_rs(d, ah, bl, 1);
  mma_rs(e, ch, fl, 1);
  mma_rs(d, ah, bh, 1);
  mma_rs(e, ch, fh, 1);
}

// G independent k-steps of mma3_rs, d[j] from A fragments ah[j] / al[j]
// and B descriptors bh[j] / bl[j] (each from zero, each the same three
// terms in the same order), their terms issued round-robin: a term of one
// waits on its own last term while the others' run
template <int G, int N>
__device__ __forceinline__ void mma3_rs_g(float (&d)[G][N],
                                          const uint32_t (&ah)[G][4],
                                          const uint32_t (&al)[G][4],
                                          const uint64_t (&bh)[G],
                                          const uint64_t (&bl)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j) mma_rs(d[j], al[j], bh[j], 0);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_rs(d[j], ah[j], bl[j], 1);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_rs(d[j], ah[j], bh[j], 1);
}

// ties A fragment registers of an asynchronous wgmma to this point (see
// wg::hold)
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[j])::"memory");
}

// The hi and lo A fragments of k-step kk of a 64 x N f32 accumulator x (n8
// block kk): slot t of the fragment takes column 2 t, slot t + 4 column
// 2 t + 1 (the permuted k order); split by mma_tf32.cuh split_tf32
template <int N>
__device__ __forceinline__ void to_frags_tf32(const float (&x)[N], int kk,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_tf32(x[4 * kk], hi[0], lo[0]);
  split_tf32(x[4 * kk + 2], hi[1], lo[1]);
  split_tf32(x[4 * kk + 1], hi[2], lo[2]);
  split_tf32(x[4 * kk + 3], hi[3], lo[3]);
}

// The k position of column j of a block of 8 in the permuted k order:
// column 2 t at t, column 2 t + 1 at t + 4
__host__ __device__ constexpr int perm_k(int j) {
  return (j & 1) * 4 + (j >> 1);
}

// A tensor map of the f32 (B, T, hidden) tensor at ptr, batch and row
// strides sb and st in elements, boxes of (rows, min(D, 32)) with the
// swizzle of that row (64 bytes at D = 16, else 128; a D = 64 tile takes
// two boxes). False when the encoder refuses it.
inline bool tensor_map_f32(CUtensorMap* map, const void* ptr, int hidden,
                           int T, int B, long long st, long long sb, int D,
                           int rows) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  const int w = D < 32 ? D : 32;
  const cuuint64_t dims[3] = {(cuuint64_t)hidden, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)st * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            w == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgtf
}  // namespace mmfm
