// K2 in f32 at head width 128 for Hopper (sm_90a): 3xTF32 on wgmma, tiles
// fed by TMA, the keep bits drawn apart, and the output products taken
// transposed so that no operand needs a transposed copy. Included by
// attention_bwd.cu, which launches it for f32 at head width 128 (and the
// widths 65-127 the wrapper pads to it); 16-64 run attention_bwd_f32.cuh.
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel` with f32 dots
// (multi_modal_foundation_model_tpu/ops/attention.py:221, :439) under the f32
// contract of attention_bwd_f32.cuh: q * scale stays f32, nothing is rounded to
// bf16; every product is 3xTF32, hi = tf32(x) and lo = tf32(x - hi)
// (mma_tf32.cuh split_tf32); every k-step's three terms (al . bh, ah . bl, ah .
// bh) are summed from zero and then added in f32; the keep bits are K1's Philox
// draws (counter (k/4, q, h + h_off, b + b_off)), drawn first by
// attn_bwd_keep_kernel (attention_bwd_bf16.cuh); no atomics, and a launch is
// bit-equal to the next. Two passes:
//   Pass A (attn_bwd_dq_tf128_kernel), a block per (batch, 64 query rows)
//     and group of heads: s = qs . k^T and dP = g . v^T over chunks of 64
//     keys, rowsum = sum_k dpn pn (a first sweep), ds = pn (dpn - rowsum)
//     and dq^T = k^T . ds^T (a second sweep; one sweep where Tk <= 64).
//   Pass B (attn_bwd_dkdv_tf128_kernel), a block per (batch, 64 key rows)
//     and group of heads: s^T = k . qs^T and dP^T = v . g^T over chunks of
//     48 queries, pd = pn ms, ds = pn (dpn - rowsum), dk^T = qs^T . ds and
//     dv^T = g^T . pd.
//
// What bounds it on the H100 at the width row's shape (B = 16, 2 heads,
// Tq = Tk = 200): the five products at three TF32 terms each, 0.0099 ms at
// 495 TFLOP/s; the bytes (q, k, v, g, dq, dk, dv, lse: 0.0024 ms) are a
// quarter of that. The grid is 128 blocks (one wave on 132 SMs), so a
// block's serial chain -- a tile's loads, its split, the k-steps of s and
// dP, the exp and masks, the output k-steps -- sets the time.
//
// The design, and what 128 columns change from attention_bwd_f32.cuh:
// - A 64-row f32 tile of 128 columns is 32 KB; split into hi and lo planes,
//   64 KB. The kernel of 16-64 keeps every operand as such planes, plus
//   transposed ones for the output products (TF32 wgmma reads both
//   operands K-major and takes no transpose bit): at 128 that does not fit
//   227 KB. So here
//   * the A operands of s and dP (q and g in pass A, k and v in pass B)
//     stay the f32 tiles TMA landed, read a k-step at a time into
//     registers (the m16n8k8 A fragment; q times scale first) and split
//     there (wgmma's A comes from registers);
//   * the output products are taken transposed: dq^T = k^T . ds^T, dk^T =
//     qs^T . ds, dv^T = g^T . pd. Their B operands are ds and pd as the s
//     and dP accumulators hold them (rows of the pass's rows, K the
//     chunk's columns), which the threads write as hi and lo planes; their
//     A operands are read from the natural hi and lo planes of the chunk
//     (made for s and dP) with the indices exchanged. No tile is
//     transposed, and no plane exists twice.
//   Pass A holds q, g (64 KB), k and v of 64 keys as hi and lo (128 KB)
//   and ds of 64 x 64 as hi and lo (32 KB); pass B k, v, qs and g of 48
//   queries (96 KB) and ds and pd of 64 x 48 (64 KB): Layout<kPassB>,
//   232,448 bytes at most.
// - Two warpgroups a block (256 threads, one block an SM). Warpgroup 0
//   computes s and warpgroup 1 dP, each over the whole chunk (m64n64k8 in
//   pass A, m64n48k8 in pass B; with each warpgroup taking half of both
//   products' columns, m64n32k8 / m64n24k8, the kernel read 19% slower at
//   B = 16 on the H100: scripts/torch_k2_variants.py); each then hands
//   the other its values of the other's half of the columns through
//   shared memory (the ds lo plane, before ds is written there) and works
//   the exp and masks of its own half. In the output products each owns
//   half of D (M = 64 of the 128 columns of dq, dk, dv: m64n64k8 over the
//   pass's 64 rows) over the whole chunk, so dq, dk and dv are 32
//   registers a thread each and need no exchange at the end.
// - Sums: each output element is one running f32 sum of k-steps of 8 keys
//   (dq) or queries (dk, dv), in order, chunk after chunk, each k-step's
//   three terms from zero (wgmma_tf32.cuh mma3_ss / mma3_rs;
//   tests/tf32_emulation.py, dot_3xtf32). s and dP likewise over D.
// - A k-step's three terms depend on each other; a group holds two
//   independent k-steps (two of s or of dP, dq's two, or dk's and dv's),
//   each into its own from-zero temporary, their terms alternating
//   (wgmma_tf32.cuh, mma3_rs2), and the next group's A fragments are read
//   while it runs.
// - One stage: the tiles (natural f32, rows past the end as zeros) and the
//   keep bytes arrive by TMA on an mbarrier; the row tiles once a head. The
//   next tile's loads are issued once the last readers of the planes are
//   done: after s and dP in pass A's first sweep, after the output
//   products otherwise.
// - The output products stop at a chunk's last k-step holding a column
//   before the end (the rest would add exact zeros).
// - The attend bits (the static mask OR the key pad) are read once a block
//   for every chunk up to 4 (pass A, 256 keys) or 5 (pass B, 240 queries)
//   and kept in registers for every head the block walks.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_bwd_bf16.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace mmfm {
namespace k2t128 {

using wg::align1k;
using wg::kRows;
using wg::kThreads;

constexpr int kD = 128;        // the head width
constexpr int kBlk = 32;       // floats a plane row: one 128-byte atom

// The dynamic shared memory of a block of pass A (kPassB false) or B, in
// bytes: the row tiles (A1, A2: 64 rows, raw f32), the column planes (B1
// hi, lo, B2 hi, lo: a chunk's rows), the product planes (pass A: ds hi,
// lo; pass B: ds hi, lo, pd hi, lo: 64 rows of a chunk's columns), the keep
// bytes, the row sums' exchange, pass B's column statistics and the
// mbarrier. Every plane is blocks of 32 columns, 128-byte swizzled.
template <bool kPassB>
struct Layout {
  static constexpr int kCols = kPassB ? 24 : 32;   // half a chunk
  static constexpr int kChunk = 2 * kCols;
  static constexpr int kAcc = kCols / 2;   // f32 a thread of a 64 x kCols sum
  static constexpr int kN8 = kCols / 8;    // n8 blocks of half a chunk
  static constexpr int kSteps = kChunk / 8;   // k-steps of an output product
  static constexpr int kA = kD / kBlk * align1k(kRows * 128);   // a row tile
  static constexpr int kBlkB = align1k(kChunk * 128);   // a column block
  static constexpr int kB = kD / kBlk * kBlkB;          // a column plane
  static constexpr int kBlkP = align1k(kRows * 128);    // a product block
  static constexpr int kP = (kChunk + kBlk - 1) / kBlk * kBlkP;
  static constexpr int kNP = kPassB ? 2 : 1;            // product operands
  static constexpr int kPlanesB = 2 * kA;
  static constexpr int kPlanesP = kPlanesB + 4 * kB;
  static constexpr int kKeep = kPlanesP + 2 * kNP * kP;
  static constexpr int kKeepBytes = kRows * (kChunk / 8);
  static constexpr int kRed = kKeep + (kKeepBytes + 127) / 128 * 128;
  static constexpr int kStat = kRed + 2 * kRows * 4;    // f32 [2][64]
  static constexpr int kBar = kStat + 2 * kChunk * 4;   // f32 [2][kChunk]
  static constexpr int kBytes = kBar + 8 + 1024;        // + the alignment
  // the attend bits of a chunk (bits 2 j + e of a row), and the chunks a
  // block holds in one 32-bit word a row
  static constexpr int kChBits = 2 * kN8;
  static constexpr int kHeld = 32 / kChBits;
  static_assert(kBytes <= 232448, "a block's shared memory on the H100");
  static_assert(kCols % 8 == 0 && kChunk % 16 == 0, "k-steps, TMA boxes");
};

struct Args {
  const float* lse;
  float* rowsum;
  float* out1;            // dq (pass A), dk (pass B)
  float* out2;            // dv (pass B)
  const int* key_pad;
  const int* static_mask;
  int Tq, Tk, H, hpb;
  float scale, keep_scale;
};

// Pass A (kPassB false): rows are queries, columns keys; A1 = q (times
// scale as it is split), A2 = g, B1 = k, B2 = v. Pass B: rows are keys,
// columns queries; A1 = k, A2 = v, B1 = q (times scale), B2 = g.
template <bool kPassB, bool kDropout>
__device__ __forceinline__ void bwd_body(const CUtensorMap* mA1,
                                         const CUtensorMap* mA2,
                                         const CUtensorMap* mB1,
                                         const CUtensorMap* mB2,
                                         const CUtensorMap* mKeep,
                                         const Args& a) {
  using L = Layout<kPassB>;
  constexpr int kCols = L::kCols, kChunk = L::kChunk, kAcc = L::kAcc;
  constexpr int kN8 = L::kN8, kSteps = L::kSteps;
  constexpr int kRowBlk = align1k(kRows * 128);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const red = reinterpret_cast<float*>(sm + L::kRed);
  float* const stat = reinterpret_cast<float*>(sm + L::kStat);
  const uint32_t bar = base + L::kBar;

  const int Tr = kPassB ? a.Tk : a.Tq, Tc = kPassB ? a.Tq : a.Tk;
  const int n_rt = (Tr + kRows - 1) / kRows;
  const int b = blockIdx.x / n_rt;
  const int r0 = (blockIdx.x % n_rt) * kRows;
  const int h0 = blockIdx.y * a.hpb;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int w = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int row0 = r0 + 16 * w + g;        // this thread's rows: + 0, + 8
  const bool live = r0 + 16 * w < Tr;      // the warp has rows to compute
  const int n_ch = (Tc + kChunk - 1) / kChunk;
  const int sweeps = !kPassB && n_ch > 1 ? 2 : 1;
  const int per_head = sweeps * n_ch;
  const int n_tiles = a.hpb * per_head;

  if (tid == 0) {
    wg::mbar_init(bar, 1);
    wg::fence_mbar_init();
  }
  __syncthreads();

  // tile t = (head, sweep, chunk) of the block's walk, raw f32 into the row
  // tiles (with a head's first tile) and the hi column planes, the keep
  // bytes into their buffer
  auto issue = [&](int t) {
    const int h = h0 + t / per_head, ch = t % per_head % n_ch;
    const bool rows = t % per_head == 0;
    wg::mbar_expect(bar, ((rows ? 2 * kRows : 0) + 2 * kChunk) * kD * 4 +
                             (kDropout ? L::kKeepBytes : 0));
    if (kDropout)
      wg::tma_load(base + L::kKeep, mKeep, bar, kPassB ? ch * kChunk : r0,
                   kPassB ? r0 / 8 : ch * (kChunk / 8), b * a.H + h);
#pragma unroll
    for (int hf = 0; hf < kD / kBlk; ++hf) {
      const int c0 = h * kD + kBlk * hf;
      if (rows) {
        wg::tma_load(base + hf * kRowBlk, mA1, bar, c0, r0, b);
        wg::tma_load(base + L::kA + hf * kRowBlk, mA2, bar, c0, r0, b);
      }
      wg::tma_load(base + L::kPlanesB + hf * L::kBlkB, mB1, bar, c0,
                   ch * kChunk, b);
      wg::tma_load(base + L::kPlanesB + 2 * L::kB + hf * L::kBlkB, mB2, bar,
                   c0, ch * kChunk, b);
    }
  };
  if (tid == 0) issue(0);

  // A landed column plane at hi (4 blocks of kChunk rows x 32 floats,
  // 128-byte swizzled), times scale with kScale, split in place: hi stays,
  // lo goes L::kB further. A thread takes 4 floats of a row, a warp 32 rows
  // of the same 4 columns (the 16-byte accesses of 8 rows fall on distinct
  // banks); the loads of kU chunks are in flight together.
  auto split = [&](unsigned char* hi, auto scaled) {
    constexpr int kCh = kBlk / 4, kN = kD / kBlk * kChunk * kCh, kU = 4;
    for (int i0 = tid; i0 < kN; i0 += kU * kThreads) {
      float4 x[kU];
      int off[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        const int hf = i / (kChunk * kCh), rem = i % (kChunk * kCh);
        const int r = rem % kChunk, lc = rem / kChunk;
        off[u] = hf * L::kBlkB + r * 128 + ((lc ^ (r & 7)) << 4);
        if (i < kN) x[u] = *reinterpret_cast<const float4*>(hi + off[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (i0 + u * kThreads >= kN) break;
        if constexpr (decltype(scaled)::value) {
          x[u].x *= a.scale;
          x[u].y *= a.scale;
          x[u].z *= a.scale;
          x[u].w *= a.scale;
        }
        uint32_t h4[4], l4[4];
        split_tf32(x[u].x, h4[0], l4[0]);
        split_tf32(x[u].y, h4[1], l4[1]);
        split_tf32(x[u].z, h4[2], l4[2]);
        split_tf32(x[u].w, h4[3], l4[3]);
        *reinterpret_cast<uint4*>(hi + off[u]) =
            make_uint4(h4[0], h4[1], h4[2], h4[3]);
        *reinterpret_cast<uint4*>(hi + L::kB + off[u]) =
            make_uint4(l4[0], l4[1], l4[2], l4[3]);
      }
    }
  };

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]. Every load is issued
  // (indices clamped into the masks), so that they are in flight together.
  auto attend = [&](int ch, uint32_t (&m)[2]) {
    m[0] = m[1] = 0u;
    const int cb = ch * kChunk + wgi * kCols + 2 * c;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = cb + 8 * j + e, row = row0 + 8 * hh;
          const int q = kPassB ? col : row, k = kPassB ? row : col;
          const int qc = min(q, a.Tq - 1), kc = min(k, a.Tk - 1);
          const int on = __ldg(a.static_mask + (long long)qc * a.Tk + kc) |
                         __ldg(a.key_pad + (long long)b * a.Tk + kc);
          if (q < a.Tq && k < a.Tk && on != 0) m[hh] |= 1u << (2 * j + e);
        }
  };

  // the keep bits of this thread's elements, in attend's order, from the
  // keep bytes mk: pass A's [kChunk / 8 key bytes][64 queries], pass B's
  // [8 key bytes][kChunk queries]
  auto load_keep = [&](const unsigned char* mk, uint32_t (&keep)[2]) {
    keep[0] = keep[1] = 0u;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!kPassB) {
          const uint32_t byte =
              mk[(kN8 * wgi + j) * kRows + 16 * w + g + 8 * hh];
          keep[hh] |= (byte >> (2 * c) & 3u) << (2 * j);
        } else {
          const uint32_t two = *reinterpret_cast<const uint16_t*>(
              mk + (2 * w + hh) * kChunk + wgi * kCols + 8 * j + 2 * c);
          keep[hh] |= (two >> g & 1u) << (2 * j) |
                      (two >> (8 + g) & 1u) << (2 * j + 1);
        }
      }
  };

  // the lse and rowsum of tile t's columns, a column a thread (pass B), or
  // the lse of its head's rows, two a thread (pass A), loaded a tile ahead
  auto stats_of = [&](int t, float (&x)[2]) {
    const int h = h0 + t / per_head, ch = t % per_head % n_ch;
    const long long at = ((long long)b * a.H + h) * a.Tq;
    if (kPassB) {
      const int q = ch * kChunk + tid;
      x[0] = tid < kChunk && q < a.Tq ? __ldg(a.lse + at + q) : 0.f;
      x[1] = tid < kChunk && q < a.Tq ? __ldg(a.rowsum + at + q) : 0.f;
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        x[hh] = row0 + 8 * hh < a.Tq ? __ldg(a.lse + at + row0 + 8 * hh)
                                     : 0.f;
    }
  };
  float next[2];
  stats_of(0, next);

  // B descriptor of k-step kk (8 columns of the head) of a column plane,
  // and of k-step ks (8 of the chunk's columns) of a product plane
  auto col_desc = [&](uint32_t plane, int kk) {
    return wg::desc<128>(plane + (kk >> 2) * L::kBlkB + 32 * (kk & 3));
  };
  auto prod_desc = [&](uint32_t plane, int ks) {
    return wg::desc<128>(plane + (ks >> 2) * L::kBlkP + 32 * (ks & 3));
  };
  // The raw A elements of k-step kk of a row tile: rows 16 w + g (+ 8),
  // columns 8 kk + c (+ 4), in the m16n8k8 A fragment's order
  auto row_a = [&](const unsigned char* tile, int kk, float (&x)[4]) {
    const unsigned char* p = tile + (kk >> 2) * kRowBlk + (16 * w + g) * 128 +
                             c * 4;
    const int lc = 2 * (kk & 3);
    x[0] = *reinterpret_cast<const float*>(p + ((lc ^ g) << 4));
    x[1] = *reinterpret_cast<const float*>(p + 1024 + ((lc ^ g) << 4));
    x[2] = *reinterpret_cast<const float*>(p + (((lc + 1) ^ g) << 4));
    x[3] = *reinterpret_cast<const float*>(p + 1024 + (((lc + 1) ^ g) << 4));
  };
  auto cut = [&](const float (&x)[4], float mul, uint32_t (&hi)[4],
                 uint32_t (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i] * mul, hi[i], lo[i]);
  };
  // The A fragment (hi, lo) of k-step ks of an output product: rows d =
  // 64 wgi + 16 w + g (+ 8) of D, k = the chunk's columns 8 ks + c (+ 4),
  // read from a natural column plane at (row k, column d)
  const int d_blk = (2 * wgi + (w >> 1)) * L::kBlkB;
  const int d_lc = 4 * (w & 1) + (g >> 2);
  auto col_a = [&](const unsigned char* plane, int ks, uint32_t (&hi)[4],
                   uint32_t (&lo)[4]) {
    const unsigned char* p = plane + d_blk + (8 * ks + c) * 128 + (g & 3) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lc = d_lc + 2 * (i & 1), k4 = 4 * (i >> 1);
      const int o = k4 * 128 + ((lc ^ (c + k4)) << 4);
      hi[i] = *reinterpret_cast<const uint32_t*>(p + o);
      lo[i] = *reinterpret_cast<const uint32_t*>(p + L::kB + o);
    }
  };
  // the float of a product plane that holds this thread's element (row
  // 16 w + g + 8 hh, column col of the chunk)
  auto slot = [&](int col, int hh) {
    const int r = 16 * w + g + 8 * hh;
    return ((col >> 5) * L::kBlkP + r * 128 +
            ((((col & 31) >> 2) ^ (r & 7)) << 4) + (col & 3) * 4) / 4;
  };
  // ds (and pd) of this thread's elements into a product plane, hi and lo
  auto put = [&](uint32_t plane, const float (&x)[kAcc]) {
    float* p = reinterpret_cast<float*>(sm + (plane - base));
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = slot(wgi * kCols + 8 * j + 2 * c, hh);
        uint32_t h0_, l0_, h1_, l1_;
        split_tf32(x[4 * j + 2 * hh], h0_, l0_);
        split_tf32(x[4 * j + 2 * hh + 1], h1_, l1_);
        *reinterpret_cast<uint2*>(p + o) = make_uint2(h0_, h1_);
        *reinterpret_cast<uint2*>(p + L::kP / 4 + o) = make_uint2(l0_, l1_);
      }
  };

  // the attend bits of every chunk, read once a block where they fit a
  // word a row (chunk ch at bits [kChBits ch, kChBits (ch + 1)))
  uint32_t att_all[2] = {0u, 0u};
  const bool held = n_ch <= L::kHeld;
  if (held)
    for (int ch = 0; ch < n_ch; ++ch) {
      uint32_t m[2];
      attend(ch, m);
      att_all[0] |= m[0] << (L::kChBits * ch);
      att_all[1] |= m[1] << (L::kChBits * ch);
    }
  float lse[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};
  float o1[kD / 4], o2[kPassB ? kD / 4 : 1];
  const uint32_t b1 = base + L::kPlanesB, b2 = b1 + 2 * L::kB;
  const uint32_t p1 = base + L::kPlanesP, p2 = p1 + 2 * L::kP;
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / per_head, r = t % per_head;
    const int sweep = r / n_ch, ch = r % n_ch;
    const bool fin = sweep == sweeps - 1, last = ch == n_ch - 1;
    // the tile's output products, and the k-steps that hold columns
    const bool out = fin;
    const int n_ks = min(kSteps, (Tc - ch * kChunk + 7) / 8);
    if (kPassB) {
      if (tid < kChunk) {
        stat[tid] = next[0];
        stat[kChunk + tid] = next[1];
      }
      if (t + 1 < n_tiles) stats_of(t + 1, next);
    }
    uint32_t att[2];
    if (held) {
      const uint32_t mask = (1u << L::kChBits) - 1u;
      att[0] = att_all[0] >> (L::kChBits * ch) & mask;
      att[1] = att_all[1] >> (L::kChBits * ch) & mask;
    } else {
      attend(ch, att);
    }
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < kD / 4; ++i) o1[i] = 0.f;
      if (kPassB) {
#pragma unroll
        for (int i = 0; i < kD / 4; ++i) o2[i] = 0.f;
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          lse[hh] = next[hh];
          rs[hh] = 0.f;
        }
        if (t + per_head < n_tiles) stats_of(t + per_head, next);
      }
    }

    // the tile landed; its column planes made, then visible to the tensor
    // cores
    wg::mbar_wait(bar, t & 1);
    split(sm + L::kPlanesB, std::integral_constant<bool, kPassB>{});
    split(sm + L::kPlanesB + 2 * L::kB, std::false_type{});
    wg::fence_async_shared();
    __syncthreads();

    // Warpgroup 0 takes s = A1 . B1^T, warpgroup 1 dP = A2 . B2^T, each over
    // the chunk's kChunk columns (one m64nNk8 wgmma a term, N = kChunk), a
    // k-step of 8 of D at a time: two k-steps a group, each from zero (the
    // first into acc, the others into tmp[0], tmp[1]), their terms
    // alternating (mma3_rs2), added in f32 in order; the next pair's A
    // elements read while a group runs
    const float mul1 = kPassB || wgi ? 1.f : a.scale;
    const unsigned char* tile = sm + wgi * L::kA;
    const uint32_t bp = wgi ? b2 : b1;
    float acc[2 * kAcc];
    uint32_t keep[2] = {~0u, ~0u};
    {
      float tmp[2][2 * kAcc], x[2][4];
      uint32_t fh[2][4], fl[2][4];
      row_a(tile, 0, x[0]);
      row_a(tile, 1, x[1]);
      cut(x[0], mul1, fh[0], fl[0]);
      cut(x[1], mul1, fh[1], fl[1]);
      wg::fence();
      wgtf::mma3_rs2(acc, fh[0], fl[0], col_desc(bp, 0),
                     col_desc(bp + L::kB, 0), tmp[1], fh[1], fl[1],
                     col_desc(bp, 1), col_desc(bp + L::kB, 1));
      wg::commit();
      // the keep bits while the products run
      if (kDropout) load_keep(sm + L::kKeep, keep);
#pragma unroll
      for (int kk = 2; kk < kD / 8; kk += 2) {
        row_a(tile, kk, x[0]);
        row_a(tile, kk + 1, x[1]);
        wg::wait<0>();                     // k-steps kk - 2, kk - 1 done
        wg::hold(acc);
        wg::hold(tmp[1]);
        wgtf::hold(fh[0]);
        wgtf::hold(fl[0]);
        wgtf::hold(fh[1]);
        wgtf::hold(fl[1]);
        if (kk > 2) {
          wg::hold(tmp[0]);
#pragma unroll
          for (int i = 0; i < 2 * kAcc; ++i) acc[i] += tmp[0][i];
        }
#pragma unroll
        for (int i = 0; i < 2 * kAcc; ++i) acc[i] += tmp[1][i];
        cut(x[0], mul1, fh[0], fl[0]);
        cut(x[1], mul1, fh[1], fl[1]);
        wg::fence();
        wgtf::mma3_rs2(tmp[0], fh[0], fl[0], col_desc(bp, kk),
                       col_desc(bp + L::kB, kk), tmp[1], fh[1], fl[1],
                       col_desc(bp, kk + 1), col_desc(bp + L::kB, kk + 1));
        wg::commit();
      }
      wg::wait<0>();
      wg::hold(tmp[0]);
      wg::hold(tmp[1]);
      wgtf::hold(fh[0]);
      wgtf::hold(fl[0]);
      wgtf::hold(fh[1]);
      wgtf::hold(fl[1]);
#pragma unroll
      for (int i = 0; i < 2 * kAcc; ++i) acc[i] += tmp[0][i];
#pragma unroll
      for (int i = 0; i < 2 * kAcc; ++i) acc[i] += tmp[1][i];
    }
    // Each warpgroup then works kCols of the columns (warpgroup 0 the first,
    // 1 the rest, as load_keep and attend take them), for which it needs the
    // other's product: each hands the other its values of the other's
    // columns through the ds lo plane, at the slots where the taker later
    // writes its own ds lo (a thread reads a slot before it writes it)
    float* const xch = reinterpret_cast<float*>(sm + L::kPlanesP + L::kP);
    float s[kAcc], p[kAcc];
    if (wgi == 0) {
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = kAcc + 4 * j + 2 * hh;
          *reinterpret_cast<float2*>(xch + slot(kCols + 8 * j + 2 * c, hh)) =
              make_float2(acc[i], acc[i + 1]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh;
          *reinterpret_cast<float2*>(xch + slot(8 * j + 2 * c, hh)) =
              make_float2(acc[i], acc[i + 1]);
        }
    }
    __syncthreads();
    if (!out) {
      // pass A's first sweep: the planes and the keep bytes are read; the
      // next tile's copies land while the row sums are taken
      if (tid == 0 && t + 1 < n_tiles) issue(t + 1);
    }
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh;
        const float2 x = *reinterpret_cast<const float2*>(
            xch + slot(wgi * kCols + 8 * j + 2 * c, hh));
        if (wgi == 0) {
          s[i] = acc[i];
          s[i + 1] = acc[i + 1];
          p[i] = x.x;
          p[i + 1] = x.y;
        } else {
          s[i] = x.x;
          s[i + 1] = x.y;
          p[i] = acc[kAcc + i];
          p[i + 1] = acc[kAcc + i + 1];
        }
      }

    // A warp whose 16 rows lie past the end skips the exp and mask work:
    // its rows of the tiles landed as zeros, so s and dP are zero there,
    // and so are the ds and pd they stand in for.
    if (!kPassB) {
      // pn = exp(s - lse) where attended, dpn = dP ms
      if (live) {
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e, bit = 2 * j + e;
              const float pn = att[hh] >> bit & 1u
                                   ? fast_exp2((s[i] - lse[hh]) * kLog2e)
                                   : 0.f;
              float dpn = p[i];
              if (kDropout)
                dpn = keep[hh] >> bit & 1u ? dpn * a.keep_scale : 0.f;
              rs[hh] = fmaf(dpn, pn, rs[hh]);   // read after sweep 0 only
              s[i] = pn;
              p[i] = dpn;
            }
      }
      if (sweep == 0 && last) {
        // the row's sum: the quad's, then warpgroup 0's plus 1's
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
          if (c == 0) red[wgi * kRows + 16 * w + g + 8 * hh] = rs[hh];
        }
        __syncthreads();
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int lr = 16 * w + g + 8 * hh;
          rsum[hh] = red[lr] + red[kRows + lr];
          if (wgi == 0 && c == 0 && r0 + lr < a.Tq)
            a.rowsum[((long long)b * a.H + h) * a.Tq + r0 + lr] = rsum[hh];
        }
      }
      if (out) {
        // ds = pn (dpn - rowsum) into the ds planes
#pragma unroll
        for (int i = 0; i < kAcc; ++i) s[i] *= p[i] - rsum[(i >> 1) & 1];
        put(p1, s);
      }
    } else {
      // pd = pn ms and ds = pn (dP ms - rowsum), the columns' lse and
      // rowsum from shared memory
      if (live) {
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wgi * kCols + 8 * j + 2 * c + e;
            const float l = stat[col], sum = stat[kChunk + col];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int i = 4 * j + 2 * hh + e, bit = 2 * j + e;
              const float pn = att[hh] >> bit & 1u
                                   ? fast_exp2((s[i] - l) * kLog2e)
                                   : 0.f;
              float ms = 1.f;
              if (kDropout) ms = keep[hh] >> bit & 1u ? a.keep_scale : 0.f;
              s[i] = pn * ms;
              p[i] = pn * (p[i] * ms - sum);
            }
          }
      }
      put(p1, p);   // ds
      put(p2, s);   // pd
    }

    if (out) {
      // the product planes visible to the tensor cores
      wg::fence_async_shared();
      __syncthreads();
      if (!kPassB) {
        // dq^T += k^T . ds^T over the chunk's keys: two k-steps of 8 a
        // group, each from zero into its temporary, their terms
        // alternating (mma3_rs2), then added in f32 in order; the next
        // pair's A fragments read while the group runs
        float to[2][kD / 4];
        uint32_t fh[2][4], fl[2][4];
        col_a(sm + L::kPlanesB, 0, fh[0], fl[0]);
        if (n_ks > 1) col_a(sm + L::kPlanesB, 1, fh[1], fl[1]);
#pragma unroll
        for (int ks = 0; ks < kSteps; ks += 2) {
          if (ks >= n_ks) break;
          const bool pair = ks + 1 < n_ks;
          wg::fence();
          if (pair)
            wgtf::mma3_rs2(to[0], fh[0], fl[0], prod_desc(p1, ks),
                           prod_desc(p1 + L::kP, ks), to[1], fh[1], fl[1],
                           prod_desc(p1, ks + 1),
                           prod_desc(p1 + L::kP, ks + 1));
          else
            wgtf::mma3_rs(to[0], fh[0], fl[0], prod_desc(p1, ks),
                          prod_desc(p1 + L::kP, ks));
          wg::commit();
          wg::wait<0>();
          wg::hold(to[0]);
          wg::hold(to[1]);
          wgtf::hold(fh[0]);
          wgtf::hold(fl[0]);
          wgtf::hold(fh[1]);
          wgtf::hold(fl[1]);
          if (ks + 2 < n_ks) col_a(sm + L::kPlanesB, ks + 2, fh[0], fl[0]);
          if (ks + 3 < n_ks) col_a(sm + L::kPlanesB, ks + 3, fh[1], fl[1]);
#pragma unroll
          for (int i = 0; i < kD / 4; ++i) o1[i] += to[0][i];
          if (pair) {
#pragma unroll
            for (int i = 0; i < kD / 4; ++i) o1[i] += to[1][i];
          }
        }
      } else {
        // dk^T += qs^T . ds and dv^T += g^T . pd over the chunk's queries,
        // a k-step of 8 a group, each product from zero into its
        // temporary, their terms alternating (mma3_rs2), then added in
        // f32; the next k-step's A fragments read while the group runs
        float tk[kD / 4], tv[kD / 4];
        uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
        col_a(sm + L::kPlanesB, 0, kh[0], kl[0]);
        col_a(sm + L::kPlanesB + 2 * L::kB, 0, vh[0], vl[0]);
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (ks >= n_ks) break;
          const int u = ks & 1;
          wg::fence();
          wgtf::mma3_rs2(tk, kh[u], kl[u], prod_desc(p1, ks),
                         prod_desc(p1 + L::kP, ks), tv, vh[u], vl[u],
                         prod_desc(p2, ks), prod_desc(p2 + L::kP, ks));
          wg::commit();
          if (ks + 1 < n_ks) {
            col_a(sm + L::kPlanesB, ks + 1, kh[u ^ 1], kl[u ^ 1]);
            col_a(sm + L::kPlanesB + 2 * L::kB, ks + 1, vh[u ^ 1],
                  vl[u ^ 1]);
          }
          wg::wait<0>();
          wg::hold(tk);
          wg::hold(tv);
          wgtf::hold(kh[u]);
          wgtf::hold(kl[u]);
          wgtf::hold(vh[u]);
          wgtf::hold(vl[u]);
#pragma unroll
          for (int i = 0; i < kD / 4; ++i) {
            o1[i] += tk[i];
            o2[i] += tv[i];
          }
        }
      }
      // every plane is read: the next tile's copies may land
      __syncthreads();
      if (tid == 0 && t + 1 < n_tiles) issue(t + 1);

      if (last) {
        // this warpgroup's half of D of the head's dq (times scale), or dk
        // and dv: element (d row hh, n8 block j, column e) of the
        // transposed sum is o[4 j + 2 hh + e], d = 64 wgi + 16 w + g +
        // 8 hh, row 8 j + 2 c + e of the block's 64
        const float mul = kPassB ? 1.f : a.scale;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r0 + 8 * j + 2 * c + e;
            if (row >= Tr) continue;
            const long long o = ((long long)b * Tr + row) * a.H * kD +
                                h * kD + 64 * wgi + 16 * w + g;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              a.out1[o + 8 * hh] = o1[4 * j + 2 * hh + e] * mul;
              if (kPassB) a.out2[o + 8 * hh] = o2[4 * j + 2 * hh + e];
            }
          }
      }
    }
  }
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_tf128_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap g_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap keep_map,
                             const Args a) {
  bwd_body<false, kDropout>(&q_map, &g_map, &k_map, &v_map, &keep_map, a);
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_tf128_kernel(const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap g_map,
                               const __grid_constant__ CUtensorMap keep_map,
                               const Args a) {
  bwd_body<true, kDropout>(&k_map, &v_map, &q_map, &g_map, &keep_map, a);
}

// The keep draws and both passes on the stream: operands as
// mmfm_attention_bwd takes them (attention_bwd.cu) at head width 128; the
// scratch holds rowsum (B, H, Tq) f32, then, 16-byte aligned, the keep
// bytes (B, H, ceil(Tk / 8), keep_row(Tq)), as the other wgmma kernels'
// (ops/attention.py::_k2_scratch_floats).
template <bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const int* key_pad, const int* static_mask,
                   const float* lse, float* rowsum, void* dq, void* dk,
                   void* dv, int B, int Tq, int Tk, int H, long long q_sb,
                   long long q_st, long long k_sb, long long k_st,
                   long long v_sb, long long v_st, long long g_sb,
                   long long g_st, float scale, const long long* seed,
                   unsigned threshold, float keep_scale, int b_off,
                   int h_off, cudaStream_t stream) {
  using LA = Layout<false>;
  using LB = Layout<true>;
  const int hidden = H * kD;
  const int kb_n = (Tk + 7) / 8, tq16 = wg::keep_row(Tq);
  const uintptr_t tail =
      reinterpret_cast<uintptr_t>(rowsum + (size_t)B * H * Tq);
  uint32_t* keep = reinterpret_cast<uint32_t*>((tail + 15) & ~uintptr_t(15));
  CUtensorMap q_rows, g_rows, k_cols, v_cols, k_rows, v_rows, q_cols, g_cols;
  CUtensorMap keep_a, keep_b;
  using wgtf::tensor_map_f32;
  if (!tensor_map_f32(&q_rows, q, hidden, Tq, B, q_st, q_sb, kD, kRows) ||
      !tensor_map_f32(&g_rows, g, hidden, Tq, B, g_st, g_sb, kD, kRows) ||
      !tensor_map_f32(&k_cols, k, hidden, Tk, B, k_st, k_sb, kD, LA::kChunk) ||
      !tensor_map_f32(&v_cols, v, hidden, Tk, B, v_st, v_sb, kD, LA::kChunk) ||
      !tensor_map_f32(&k_rows, k, hidden, Tk, B, k_st, k_sb, kD, kRows) ||
      !tensor_map_f32(&v_rows, v, hidden, Tk, B, v_st, v_sb, kD, kRows) ||
      !tensor_map_f32(&q_cols, q, hidden, Tq, B, q_st, q_sb, kD, LB::kChunk) ||
      !tensor_map_f32(&g_cols, g, hidden, Tq, B, g_st, g_sb, kD, LB::kChunk) ||
      !wg::byte_map(&keep_a, keep, tq16, kb_n, B * H, kRows,
                    LA::kChunk / 8) ||
      !wg::byte_map(&keep_b, keep, tq16, kb_n, B * H, LB::kChunk,
                    kRows / 8))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kDropout) {
    const long long n = (long long)B * H * kb_n * (tq16 / 4);
    k2wg::attn_bwd_keep_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                 stream>>>(keep, seed, threshold, H, Tq, Tk,
                                           kb_n, tq16, b_off, h_off, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  Args args{lse,         rowsum, static_cast<float*>(dq), nullptr, key_pad,
            static_mask, Tq,     Tk,                      H,       1,
            scale,       keep_scale};
  err = allow_smem(attn_bwd_dq_tf128_kernel<kDropout>, LA::kBytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkdv_tf128_kernel<kDropout>, LB::kBytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kRows - 1) / kRows, n_kt = (Tk + kRows - 1) / kRows;
  args.hpb = wg::walk_heads(B, n_qt, H);
  attn_bwd_dq_tf128_kernel<kDropout>
      <<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, LA::kBytes,
         stream>>>(q_rows, g_rows, k_cols, v_cols, keep_a, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  args.out1 = static_cast<float*>(dk);
  args.out2 = static_cast<float*>(dv);
  args.hpb = wg::walk_heads(B, n_kt, H);
  attn_bwd_dkdv_tf128_kernel<kDropout>
      <<<dim3((unsigned)B * n_kt, H / args.hpb), kThreads, LB::kBytes,
         stream>>>(k_rows, v_rows, q_cols, g_cols, keep_b, args);
  return cudaGetLastError();
}

}  // namespace k2t128
}  // namespace mmfm
