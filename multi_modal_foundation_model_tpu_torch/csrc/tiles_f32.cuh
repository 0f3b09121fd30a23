// The f32 attention kernels' tiles at head widths 16, 32 and 64 for Hopper
// (sm_90a), shared by the f32 K2's pass A (attention_bwd_f32.cuh,
// attn_bwd_dq_tf_kernel) and the f32 K1 (attention_fwd_f32.cuh,
// attn_fwd_tf_kernel): how a landed f32 tile is split into TF32 planes, the
// wgmma descriptors of those planes, and one k-step of a score product.
// K1 summarises s = (q * scale) . k^T into lse and K2 recomputes s against
// it, so both take s from these functions: the same split of q * scale and
// of k, the same three terms a k-step in the same order, and k-step 0 into
// s, each further one summed from zero and added in f32, in k order.
//
// - A tile lands by TMA as rows of D floats in column blocks of kW = min(D,
//   32) floats (128 bytes and the 128-byte swizzle, 64 bytes and the 64-byte
//   swizzle at D = 16), `half` bytes apart.
// - Natural planes: hi = tf32(x) in place, lo = tf32(x - hi) lo_off bytes
//   further (mma_tf32.cuh split_tf32), the layout TMA wrote: the K-major
//   operand of a product over D.
// - Transposed planes, [32-row group][d][32 rows], 128-byte swizzled, the
//   rows' order within each 8 permuted (wgtf::perm_k): the K-major B
//   operand of a product over the tile's rows (dq = ds . k, o = pd . v),
//   whose A (ds, pd) comes from the accumulators as register fragments with
//   no shuffle (wgtf::to_frags_tf32).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace mmfm {
namespace f32t {

// A tile's rows at head width D: kW floats a column block, kHalves column
// blocks, kRowB bytes a column block's row
template <int D>
struct Rows {
  static constexpr int kW = D < 32 ? D : 32;
  static constexpr int kHalves = D / kW;
  static constexpr int kRowB = 4 * kW;
};

// A landed tile of R rows at hi, times mul where kScaled, split by the
// block's kThreads threads (tid): with kNat the natural planes (hi in
// place, lo lo_off bytes further), with kTrans the transposed planes at th
// (hi) and th + t_lo (lo): row d, the tile's row r at k position 8 (r / 8)
// + perm_k(r % 8). A thread takes 4 floats of a row, a warp 32 rows of the
// same 4 columns: the 16-byte accesses of 8 rows and the transposed stores
// of 32 k positions of a row d fall on distinct banks. kU chunks a thread
// at a time: their loads in flight together (a load cannot pass the
// stores of the chunk before it). kThreads: the block's threads.
template <int D, int R, bool kScaled, bool kNat, bool kTrans,
          int kThreads = wg::kThreads>
__device__ __forceinline__ void split(unsigned char* hi, int half,
                                      int lo_off, unsigned char* th,
                                      int t_lo, float mul, int tid) {
  constexpr int kW = Rows<D>::kW, kRowB = Rows<D>::kRowB, kCh = kW / 4;
  constexpr int kN = Rows<D>::kHalves * R * kCh, kU = 4;
  for (int i0 = tid; i0 < kN; i0 += kU * kThreads) {
    float4 x[kU];
    int off[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      const int hf = i / (R * kCh), rem = i % (R * kCh);
      const int r = rem % R, lc = rem / R;
      // the physical chunk of logical chunk lc: 128-byte swizzle (lc ^
      // row % 8), or 64-byte (lc ^ (row / 2) % 4)
      const int pc = lc ^ (kW == 32 ? (r & 7) : ((r >> 1) & 3));
      off[u] = hf * half + r * kRowB + pc * 16;
      if (i < kN) x[u] = *reinterpret_cast<const float4*>(hi + off[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kN) break;
      if (kScaled) {
        x[u].x *= mul;
        x[u].y *= mul;
        x[u].z *= mul;
        x[u].w *= mul;
      }
      uint32_t h4[4], l4[4];
      split_tf32(x[u].x, h4[0], l4[0]);
      split_tf32(x[u].y, h4[1], l4[1]);
      split_tf32(x[u].z, h4[2], l4[2]);
      split_tf32(x[u].w, h4[3], l4[3]);
      if (kNat) {
        *reinterpret_cast<uint4*>(hi + off[u]) =
            make_uint4(h4[0], h4[1], h4[2], h4[3]);
        *reinterpret_cast<uint4*>(hi + lo_off + off[u]) =
            make_uint4(l4[0], l4[1], l4[2], l4[3]);
      }
      if (kTrans) {
        const int rem = i % (R * kCh), r = rem % R;
        const int d0 = kW * (i / (R * kCh)) + 4 * (rem / R);
        const int k = (r & ~7) | wgtf::perm_k(r & 7);
        unsigned char* tb = th + (k >> 5) * (D * 128) + (k & 3) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + j;
          const int o = d * 128 + ((((k & 31) >> 2) ^ (d & 7)) << 4);
          *reinterpret_cast<uint32_t*>(tb + o) = h4[j];
          *reinterpret_cast<uint32_t*>(tb + t_lo + o) = l4[j];
        }
      }
    }
  }
}

// The descriptor of k-step kk (8 of D) of a natural plane, from byte `row`
// of its first column block
template <int D>
__device__ __forceinline__ uint64_t nat(uint32_t plane, int half, int row,
                                        int kk) {
  constexpr int kKs = Rows<D>::kW / 8;     // k-steps a column block
  return wg::desc<Rows<D>::kRowB>(plane + (kk / kKs) * half + row +
                                  32 * (kk % kKs));
}

// The descriptor of k-step ks (8 of the rows) of a transposed plane
template <int D>
__device__ __forceinline__ uint64_t tr(uint32_t plane, int ks) {
  return wg::desc<128>(plane + (ks >> 2) * (D * 128) + (ks & 3) * 32);
}

// d = A . B^T over k-step kk of D, from zero (wgtf::mma3_ss: al . bh, ah .
// bl, then ah . bh): A the 64 rows of the natural planes at a (lo a_lo
// further), B the rows from byte b_row of those at b (lo b_lo further). A
// product over D is k-step 0 into its accumulator, then each further k-step
// into a temporary added in f32, in k order.
template <int D, int N>
__device__ __forceinline__ void step3(float (&d)[N], uint32_t a, int a_half,
                                      int a_lo, uint32_t b, int b_half,
                                      int b_lo, int b_row, int kk) {
  wgtf::mma3_ss(d, nat<D>(a, a_half, 0, kk), nat<D>(a + a_lo, a_half, 0, kk),
                nat<D>(b, b_half, b_row, kk),
                nat<D>(b + b_lo, b_half, b_row, kk));
}

// step3 over k-steps kk into d and kk + 1 into e, their terms issued
// alternately (wgtf::mma3_ss2)
template <int D, int N>
__device__ __forceinline__ void step3x2(float (&d)[N], float (&e)[N],
                                        uint32_t a, int a_half, int a_lo,
                                        uint32_t b, int b_half, int b_lo,
                                        int b_row, int kk) {
  wgtf::mma3_ss2(d, nat<D>(a, a_half, 0, kk), nat<D>(a + a_lo, a_half, 0, kk),
                 nat<D>(b, b_half, b_row, kk),
                 nat<D>(b + b_lo, b_half, b_row, kk), e,
                 nat<D>(a, a_half, 0, kk + 1),
                 nat<D>(a + a_lo, a_half, 0, kk + 1),
                 nat<D>(b, b_half, b_row, kk + 1),
                 nat<D>(b + b_lo, b_half, b_row, kk + 1));
}

}  // namespace f32t
}  // namespace mmfm
