// Hopper building blocks of the bf16 attention kernels on wgmma, the
// forward K1 (attention_fwd_bf16.cuh) and the backward K2
// (attention_bwd_bf16.cuh; attention_bwd_bf16_d128.cuh at head width 128):
// wgmma, TMA and mbarriers, for sm_90a, and the whole-key-row tiling they
// share.
//
// - wgmma.mma_async: a warpgroup (four warps, 128 threads) multiplies a
//   64-row A by a B of N columns, bf16 in, f32 accumulated in registers,
//   asynchronously: issue, then commit_group and wait_group. A comes from
//   shared memory (K-major, a descriptor) or from registers (each warp's 16
//   rows as the mma.sync m16n8k16 A fragment, so an f32 accumulator turns
//   into the next product's A in registers); B from shared memory, K-major
//   or, transposed, MN-major.
// - The shared tiles are row-major bf16 with a row of 2 D bytes (D = 16,
//   32 or 64: 32, 64 or 128 bytes) and the swizzle of that width, which TMA
//   writes (CU_TENSOR_MAP_SWIZZLE_32B/64B/128B) and wgmma reads. A row that
//   is exactly one swizzle atom wide is both the K-major layout of a
//   (rows, D) operand and the MN-major layout of a (D, rows) one, so one
//   tile of k serves s = q . k^T (K-major B) and dq = ds . k (MN-major B).
//   Buffers start at 1024-byte boundaries, where both sides' swizzle
//   patterns agree. A 128-wide row (256 bytes) is two atoms: the D = 128
//   kernel lands each tile as two boxes of 64 columns and reads each as
//   the D = 64 kernels read theirs.
// - TMA (cp.async.bulk.tensor): one thread asks for a (rows, D) box of a
//   (B, T, H * D) tensor (any batch and row strides, 16-byte multiples);
//   rows past T land as zeros; completion is counted in bytes on an
//   mbarrier in shared memory, which the readers wait on by phase parity.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mmfm {
namespace wg {

// The shared-memory matrix descriptor of a tile at shared address addr,
// rows of kRowBytes (32, 64 or 128) in the swizzle of that width. The
// stride between 8-row groups goes in both offset fields: it is the
// K-major layout's group stride and the MN-major layout's stride along K;
// the other field (between atoms along K, or along MN) is not read, since
// a k-step of 16 elements, and the N = D of an MN-major operand, lie
// within one atom.
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128,
                "a row is one swizzle atom");
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  constexpr uint64_t kGroup = (8 * kRowBytes) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | kGroup << 16 | kGroup << 32 |
         kLayout << 62;
}

// a descriptor moved by `bytes` (a multiple of 16) in shared memory
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// before the first wgmma that reads registers or shared memory written by
// other instructions
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Ties registers of an asynchronous wgmma to this point of the program, so
// that the compiler moves no read of an accumulator before its
// wait_group, and no write of it or of an A fragment before its issue.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// shared-memory writes of the threads (generic proxy) made visible to
// wgmma and TMA (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// waits for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the (rows, D) box at column c0, row c1, batch c2 of `map` into shared
// address dst, counted on mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// d (64 x 104, f32) = or += A . B^T: A (64 x 16) and B (104 x 16) bf16,
// both K-major in shared memory (descriptors da, db)
__device__ __forceinline__ void mma_ss_n104(float (&d)[52], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "%52, %53, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 16, f32) = or += A . B: A (64 x 16) bf16 in registers (each
// warp's 16 rows as the mma.sync m16n8k16 A fragment), B (16 x 16) bf16
// MN-major in shared memory (descriptor db; transposed: rows of 16
// contiguous)
__device__ __forceinline__ void mma_rs_n16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 32, f32) = or += A . B: A (64 x 16) bf16 in registers (each
// warp's 16 rows as the mma.sync m16n8k16 A fragment), B (16 x 32) bf16
// MN-major in shared memory (descriptor db; transposed: rows of 32
// contiguous)
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 64, f32) = or += A . B: A (64 x 16) bf16 in registers (each
// warp's 16 rows as the mma.sync m16n8k16 A fragment), B (16 x 64) bf16
// MN-major in shared memory (descriptor db; transposed: rows of 64
// contiguous)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// d (64 x 64, f32) = or += A . B: A (64 x 16) bf16 K-major in shared
// memory (descriptor da), B (16 x 64) bf16 MN-major in shared memory
// (descriptor db; transposed: rows of 64 contiguous)
__device__ __forceinline__ void mma_ss_n64_t(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the output products at N = D
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  mma_rs_n16(d, a, db, accumulate);
}
__device__ __forceinline__ void mma_rs(float (&d)[16],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  mma_rs_n32(d, a, db, accumulate);
}
__device__ __forceinline__ void mma_rs(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  mma_rs_n64(d, a, db, accumulate);
}

// ---------------------------------------------------------------------------
// the whole-key-row tiling of K1 and K2: a block's 64 rows against a chunk
// of 208 columns, 104 a warpgroup
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;              // two warpgroups
constexpr int kRows = 64;                  // rows a block
constexpr int kCols = 104;                 // columns a warpgroup
constexpr int kChunk = 2 * kCols;          // columns a block takes at once
constexpr int kBRows = kChunk + 8;         // + 8 zero rows: the last k-step
constexpr int kSteps = (kCols + 15) / 16;  // k-steps of an output product
constexpr int kAcc = kCols / 2;            // f32 a thread of a 64 x 104 sum
constexpr int kBits = kCols / 4;           // elements a thread and row

__host__ __device__ constexpr int align1k(int x) {
  return (x + 1023) / 1024 * 1024;
}

// A stage's keep bytes (mask[b][h][k / 8][q], bit k % 8): a query-row
// pass's 64 queries x 26 bytes of keys (K1, K2's pass A), K2 pass B's 208
// queries x 8 bytes (its 64 keys)
constexpr int kKeepBytes = kRows * (kChunk / 8);
static_assert(kKeepBytes == kChunk * (kRows / 8), "one box size");
constexpr int kKeepBuf = (kKeepBytes + 127) / 128 * 128;

// The A fragments (kSteps k-steps of 16 columns) of the bf16 rounding of a
// 64 x 104 f32 accumulator x: element (row hh, n8 block j, column e) is
// x[4 j + 2 hh + e]; the columns past 104 are zero.
__device__ __forceinline__ void to_frags(uint32_t (&f)[kSteps][4],
                                         const float (&x)[kAcc]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 2 * kk + (r >> 1), i = 4 * j + 2 * (r & 1);
      f[kk][r] = j < kCols / 8 ? pack_bf16(x[i], x[i + 1]) : 0u;
    }
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry
// point lookup (the library does not link libcuda), or null. A driver call
// needs a current context, which the runtime binds to a thread at its
// first runtime call there: a thread whose first CUDA work is this launch
// (autograd's device thread running K2 first) has none, so each thread
// binds the current device's primary context once (cudaSetDevice).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  thread_local bool bound = [] {
    int dev = 0;
    return cudaGetDevice(&dev) == cudaSuccess &&
           cudaSetDevice(dev) == cudaSuccess;
  }();
  return bound ? fn : nullptr;
}

// A tensor map of the bf16 (B, T, hidden) tensor at ptr, batch and row
// strides sb and st in elements, boxes of (rows, D) with D's swizzle (a row
// of 2 D bytes: 32, 64 or 128). False when the encoder refuses it.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int hidden, int T,
                       int B, long long st, long long sb, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hidden, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of the bytes (n, rows, cols) at ptr, a row of `cols` bytes
// (a multiple of 16), boxes of (1, box_rows, box_cols), no swizzle. False
// when the encoder refuses it.
inline bool byte_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                     int n, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols,
                                 (cuuint64_t)cols * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The keep bytes' rows: Tq rounded up to 16 (a TMA stride)
inline int keep_row(int Tq) { return (Tq + 15) / 16 * 16; }

// Heads a block walks through, a divisor of H: per_sm blocks run on an SM
// at a time, and a block's set-up (barriers, the attend bits, its first
// copies) takes about 1.3 heads' time, so the fewest waves of blocks times
// (1.3 + heads a block). K2 at the training step's B = 256 (one block an
// SM): all 8 heads (1,024 blocks); at B = 16, 4 (128 blocks: one wave on
// the H100's 132 SMs).
inline int walk_heads(int B, int n_tiles, int H, int per_sm = 1) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  int best = 1;
  double best_cost = 1e30;
  for (int hpb = 1; hpb <= H; ++hpb) {
    if (H % hpb != 0) continue;
    const long long blocks = (long long)B * n_tiles * (H / hpb);
    const double cost = (double)((blocks + slots - 1) / slots) * (1.3 + hpb);
    if (cost < best_cost) {
      best_cost = cost;
      best = hpb;
    }
  }
  return best;
}

}  // namespace wg
}  // namespace mmfm
