// K2 in bf16 at head width 128 for Hopper (sm_90a): wgmma over the whole
// key row, 256-byte rows landed by TMA as two 128-byte swizzle atoms, the
// keep bits drawn apart. Included by attention_bwd.cu, which launches it
// for bf16 at head width 128 (and the widths 65-127 the wrapper pads to
// it); 16-64 run attention_bwd_bf16.cuh.
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel` with dots_dtype = bf16
// (multi_modal_foundation_model_tpu/ops/attention.py:221, :431) under the
// bf16 contract of attention_bwd_bf16.cuh: qs = bf16(f32(q) * scale); k, v
// and g in bf16; the five products take bf16 operands and accumulate in
// f32; pn = exp(s - lse) as ex2.approx of (s - lse) log2 e (fast_exp2);
// ds and pd rounded to bf16 before the dq, dk and dv products; the bias
// -1e30, so a fully masked query row gets zero gradient; the keep bits are
// K1's Philox draws (counter (k/4, q, h + h_off, b + b_off)), drawn first
// by attn_bwd_keep_kernel (attention_bwd_bf16.cuh) from the seed the seed
// table holds; no atomics, and a launch is bit-equal to the next. Two
// passes:
//   Pass A (attn_bwd_dq_wg128_kernel), a block per (batch, 64 query rows)
//     and group of heads: s = qs . k^T and dP = g . v^T over the whole key
//     row (208 keys a chunk, 104 a warpgroup), rowsum = sum_k dpn pn,
//     ds = pn (dpn - rowsum), dq = ds . k * scale; rowsum goes to the
//     scratch for pass B.
//   Pass B (attn_bwd_dkdv_wg128_kernel), a block per (batch, 64 key rows)
//     and group of heads: s^T = k . qs^T and dP^T = v . g^T over the whole
//     query row, pd = pn ms, ds = pn (dpn - rowsum), dk = ds^T . qs and
//     dv = pd^T . g.
// Seven products where the bound counts five (s and dP once in each
// pass); one sweep of the keys wherever the row fits one chunk (every
// model path: 200 x 200), two past it (pass A: rowsum, then ds and dq).
//
// What bounds it on the H100 at the width row's shape (B = 16, 2 heads,
// Tq = Tk = 200): bytes, 0.00348 ms (q, k, v, g read once, dq, dk, dv
// written once, 3.35 TB/s), where the five products need 0.0017 ms at
// 989 TFLOP/s. The grid is 128 blocks a pass (one wave on 132 SMs), so a
// block's serial chain -- its loads, the k-steps of s and dP, the exp and
// masks, the output k-steps, the stores -- sets the time.
//
// The design, and what 128 columns change from attention_bwd_bf16.cuh
// (whose tiles are rows of one swizzle atom, 2 D bytes up to 128):
// - Rows of two atoms. A 128-wide bf16 row is 256 bytes, two 128-byte
//   swizzle atoms. Every tile lands as two TMA boxes of 64 columns
//   (CU_TENSOR_MAP_SWIZZLE_128B, wg::tensor_map at a box width of 64), a
//   box a block of 1 KB-aligned memory. K-major operands (both of s and
//   dP) take their first four k-steps of 16 from the first box and the
//   last four from the second, each k-step 32 bytes into the atom, as the
//   D = 64 kernel does within its one atom. The MN-major operands (k in
//   dq = ds . k, qs in dk, g in dv) are read a box at a time: each output
//   product is two m64n64k16 wgmmas a k-step, one a box of 64 columns of
//   D, so every B operand of N = 64 lies in one atom and the descriptors
//   are the D = 64 kernel's (wg::desc<128>).
// - Registers. Pass A is the D = 64 kernel's: each warpgroup takes 104 of
//   the chunk's 208 keys, s and dP one m64n104k16 wgmma each a k-step (52
//   f32 registers each a thread); ds turns into A fragments in registers
//   (wg::to_frags) and dq = ds . k sums the warpgroup's keys over all of D
//   (64 registers, two n64 halves); warpgroup 1 hands its dq to warpgroup
//   0 through shared memory at a head's end, 0 adds it in that order and
//   stores. Pass B cannot hold dk and dv over all of D (128 registers)
//   beside s and dP (104): each warpgroup takes 104 of the 208 queries for
//   s and dP, writes its ds and pd, rounded to bf16, into shared planes
//   (64 key rows of the chunk's queries, K-major, blocks of 64 columns),
//   and after one barrier owns half of D in the output products, dk and
//   dv of its 64 columns over all 208 queries (32 registers each; A the
//   planes, B the column chunk's box of its half, MN-major). So every
//   score is worked once, no f32 exchange is needed, dk and dv need no
//   sum across warpgroups, and no wgmma is narrower than N = 64 (narrower
//   ones ran 19% slower in attention_bwd_f32_d128.cuh).
// - Shared memory (Layout<kPassB>). A 64-row tile is 16 KB, a chunk of
//   208 rows 52 KB (pass A's k with 8 zero rows a box, which the last
//   k-step of dq reads times zero ds: 54 KB). Pass A holds q, g, k, v (140
//   KB), the keep bytes and dq's exchange (32 KB): 179,336 bytes. Pass B
//   holds k, v, qs, g (136 KB), the ds and pd planes (64 KB), the keep
//   bytes and the chunk's lse and rowsum: 209,160 bytes. A second stage
//   does not fit either (232,448 bytes a block), so there is one stage
//   and the next tile's copies are issued in two parts as its buffers
//   free up: once s and dP are read (pass A: q, g, v, the keep bytes;
//   pass B: k, v and the keep bytes), and once the output products are
//   read (pass A: k; pass B: qs and g). One mbarrier, whose expected bytes
//   the first part sets. q is scaled to bf16(q * scale) in place once it
//   lands (pass A: a head's first tile; pass B: every chunk).
// - Dropout: attn_bwd_keep_kernel draws every keep bit once, at full
//   occupancy, into bytes mask[b][h][k / 8][q] in the scratch; each tile
//   brings its slice by TMA with the operands (the boxes of the D <= 64
//   kernel), so neither pass draws. The attend bits (the static mask OR
//   the key pad) are read once a block where the row is one chunk and kept
//   in registers for every head it walks; all of a thread's loads of them
//   are issued at once, their indices clamped into the masks.
// - Grid: wg::walk_heads sizes heads a block to whole waves (at B = 16 one
//   head a block, 128 blocks; at B = 256 two).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd_bf16.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace mmfm {
namespace k2b128 {

// the whole-key-row tiling of the D <= 64 kernels (kThreads, kRows, kCols,
// kChunk, kBRows, kAcc, kSteps, kBits, kKeepBytes, kKeepBuf, to_frags, ...)
using namespace wg;
using k2wg::Args;

constexpr int kD = 128;                           // the head width
constexpr int kBox = 64;                          // bf16 a box row: an atom
constexpr int kAtom = 128;                        // bytes a box row
constexpr int kRowBox = align1k(kRows * kAtom);   // a row tile's box

// The dynamic shared memory of a block of pass A (kPassB false) or B, in
// bytes: the row tiles (A1, A2: two boxes of 64 rows each), the column
// chunks (B1, B2: two boxes of a chunk's rows each, pass A's with 8 zero
// rows), pass B's product planes (ds, pd: 4 blocks of 64 rows x 64
// columns), the keep bytes, pass A's dq exchange (f32 [64][128]) and row
// sums (f32 [2][64]), pass B's column statistics (f32 [2][kChunk]) and the
// mbarrier.
template <bool kPassB>
struct Layout {
  static constexpr int kColRows = kPassB ? kChunk : kBRows;
  static constexpr int kColBox = align1k(kColRows * kAtom);
  static constexpr int kA = 2 * kRowBox;          // a row tile
  static constexpr int kB = 2 * kColBox;          // a column chunk
  static constexpr int kPlane = 4 * kRowBox;      // a product plane
  static constexpr int kProd = 2 * kA + 2 * kB;
  static constexpr int kKeep = kProd + (kPassB ? 2 * kPlane : 0);
  static constexpr int kXchg = kKeep + kKeepBuf;
  static constexpr int kRed = kXchg + (kPassB ? 0 : kRows * kD * 4);
  static constexpr int kStat = kRed + (kPassB ? 0 : 2 * kRows * 4);
  static constexpr int kBar = kStat + (kPassB ? 2 * kChunk * 4 : 0);
  static constexpr int kBytes = kBar + 8 + 1024;  // + the alignment
  static_assert(kBytes <= 232448, "a block's shared memory on the H100");
  static_assert(kBytes + 2 * kA + 2 * kB > 232448, "one stage only");
};

// Pass A (kPassB false): rows are queries, columns keys; A1 = q (scaled in
// place), A2 = g, B1 = k, B2 = v. Pass B: rows are keys, columns queries;
// A1 = k, A2 = v, B1 = q (scaled in place), B2 = g.
template <bool kPassB, bool kDropout>
__device__ __forceinline__ void bwd_body(const CUtensorMap* mA1,
                                         const CUtensorMap* mA2,
                                         const CUtensorMap* mB1,
                                         const CUtensorMap* mB2,
                                         const CUtensorMap* mKeep,
                                         const Args& a) {
  using L = Layout<kPassB>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const xchg = reinterpret_cast<float*>(sm + L::kXchg);
  float* const red = reinterpret_cast<float*>(sm + L::kRed);
  float* const stat = reinterpret_cast<float*>(sm + L::kStat);
  const uint32_t bar = base + L::kBar;
  const uint32_t A1 = base, A2 = base + L::kA;
  const uint32_t B1 = base + 2 * L::kA, B2 = B1 + L::kB;

  const int Tr = kPassB ? a.Tk : a.Tq, Tc = kPassB ? a.Tq : a.Tk;
  const int n_rt = (Tr + kRows - 1) / kRows;
  const int b = blockIdx.x / n_rt;
  const int r0 = (blockIdx.x % n_rt) * kRows;
  const int h0 = blockIdx.y * a.hpb;
  const int tid = threadIdx.x, wgi = tid >> 7, t128 = tid & 127;
  const int w = t128 >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
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
  if (!kPassB) {
    // the 8 rows past each of k's boxes, which the last k-step of dq reads
    // (times zero ds), zeroed once
    constexpr int kPad = 8 * kAtom / 16;   // 16-byte words of 8 rows
    for (int i = tid; i < 2 * kPad; i += kThreads) {
      const int off = 2 * L::kA + (i / kPad) * L::kColBox + kChunk * kAtom +
                      (i % kPad) * 16;
      *reinterpret_cast<uint4*>(sm + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    wg::fence_async_shared();
  }
  __syncthreads();

  // Tile t = (head, sweep, chunk) of the block's walk into the one stage.
  // Part 1 (parts & 1): the barrier's expected bytes, the keep bytes and
  // the copies whose buffers are free once s and dP are read (pass A: q
  // and g with a head's first tile, v; pass B: k and v with a head's
  // first tile); part 2 (parts & 2): the copies the output products read
  // (pass A: k; pass B: qs and g). Each operand lands as two boxes of 64
  // columns.
  auto issue = [&](int t, int parts) {
    const int h = h0 + t / per_head, ch = t % per_head % n_ch;
    const bool rows = t % per_head == 0;
    const int c1 = ch * kChunk;
    if (parts & 1) {
      wg::mbar_expect(bar, (rows ? 2 * kRows * 2 * kD : 0) +
                               2 * kChunk * 2 * kD +
                               (kDropout ? kKeepBytes : 0));
      if (kDropout)
        wg::tma_load(base + L::kKeep, mKeep, bar, kPassB ? c1 : r0,
                     kPassB ? r0 / 8 : ch * (kChunk / 8), b * a.H + h);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c0 = h * kD + kBox * hf;
        if (rows) {
          wg::tma_load(A1 + hf * kRowBox, mA1, bar, c0, r0, b);
          wg::tma_load(A2 + hf * kRowBox, mA2, bar, c0, r0, b);
        }
        if (!kPassB) wg::tma_load(B2 + hf * L::kColBox, mB2, bar, c0, c1, b);
      }
    }
    if (parts & 2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c0 = h * kD + kBox * hf;
        wg::tma_load(B1 + hf * L::kColBox, mB1, bar, c0, c1, b);
        if (kPassB) wg::tma_load(B2 + hf * L::kColBox, mB2, bar, c0, c1, b);
      }
    }
  };
  if (tid == 0) issue(0, 3);

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]. Every load is issued
  // (indices clamped into the masks), so that they are in flight together:
  // guarded by the bounds, the 104 loads a thread took a quarter of the
  // kernel's time (scripts/torch_k2_variants.py, attend_guarded).
  auto attend = [&](int ch, uint32_t (&m)[2]) {
    m[0] = m[1] = 0u;
    const int cb = ch * kChunk + wgi * kCols + 2 * c;
#pragma unroll
    for (int j = 0; j < kBits / 2; ++j)
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
  // stage's keep bytes mk: pass A's [26 key bytes][64 queries], pass B's
  // [8 key bytes][208 queries]
  auto load_keep = [&](const unsigned char* mk, uint32_t (&keep)[2]) {
    keep[0] = keep[1] = 0u;
#pragma unroll
    for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!kPassB) {
          const uint32_t byte =
              mk[((kCols / 8) * wgi + j) * kRows + 16 * w + g + 8 * hh];
          keep[hh] |= (byte >> (2 * c) & 3u) << (2 * j);
        } else {
          const uint32_t two = *reinterpret_cast<const uint16_t*>(
              mk + (2 * w + hh) * kChunk + wgi * kCols + 8 * j + 2 * c);
          keep[hh] |= (two >> g & 1u) << (2 * j) |
                      (two >> (8 + g) & 1u) << (2 * j + 1);
        }
      }
  };

  // the lse (times log2 e) and rowsum of tile t's columns, a column a
  // thread (pass B), and of its head's rows, two a thread (pass A),
  // loaded a tile ahead
  auto stats_of = [&](int t, float (&x)[2]) {
    const int h = h0 + t / per_head, ch = t % per_head % n_ch;
    const long long at = ((long long)b * a.H + h) * a.Tq;
    if (kPassB) {
      const int q = ch * kChunk + tid;
      x[0] = tid < kChunk && q < a.Tq ? __ldg(a.lse + at + q) * kLog2e : 0.f;
      x[1] = tid < kChunk && q < a.Tq ? __ldg(a.rowsum + at + q) : 0.f;
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        x[hh] = row0 + 8 * hh < a.Tq
                    ? __ldg(a.lse + at + row0 + 8 * hh) * kLog2e
                    : 0.f;
    }
  };

  // this thread's elements of x, rounded to bf16, into a product plane
  // (pass B's ds or pd) at byte offset plane of the stage: row 16 w + g
  // (+ 8) of the block's 64, column 104 wgi + 8 j + 2 c (+ 1) of the chunk,
  // in blocks of 64 columns, 128-byte swizzled (a K-major A operand)
  auto put = [&](int plane, const float (&x)[kAcc]) {
#pragma unroll
    for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * w + g + 8 * hh;
        const int col = wgi * kCols + 8 * j + 2 * c;
        const int off = plane + (col >> 6) * kRowBox + row * kAtom +
                        ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
        *reinterpret_cast<uint32_t*>(sm + off) =
            pack_bf16(x[4 * j + 2 * hh], x[4 * j + 2 * hh + 1]);
      }
  };

  float next[2];
  stats_of(0, next);
  uint32_t att[2] = {0u, 0u};
  if (n_ch == 1) attend(0, att);
  float lse2[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};
  // pass A: dq's columns [0, 64) and [64, 128); pass B: dk and dv of this
  // warpgroup's 64 columns of D
  float o1[32] = {}, o2[32] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / per_head, r = t % per_head;
    const int sweep = r / n_ch, ch = r % n_ch;
    const bool fin = sweep == sweeps - 1, last = ch == n_ch - 1;
    const bool more = t + 1 < n_tiles;
    if (n_ch > 1) attend(ch, att);
    if (kPassB) {
      // the chunk's lse and rowsum (their last readers passed the barrier
      // that ended the last tile)
      if (tid < kChunk) {
        stat[tid] = next[0];
        stat[kChunk + tid] = next[1];
      }
      if (more) stats_of(t + 1, next);
    } else if (r == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lse2[hh] = next[hh];
        rs[hh] = 0.f;
      }
      if (t + per_head < n_tiles) stats_of(t + per_head, next);
    }

    // the tile landed; q scaled to bf16(q * scale) in place (pass A's row
    // tile with a head's first tile, pass B's column chunk)
    wg::mbar_wait(bar, t & 1);
    if (kPassB || r == 0) {
      const int bytes = kPassB ? L::kB : L::kA;
      unsigned char* qt = sm + (kPassB ? B1 : A1) - base;
      for (int i = tid * 16; i < bytes; i += kThreads * 16) {
        uint4* pq = reinterpret_cast<uint4*>(qt + i);
        uint4 x = *pq;
        x.x = scale_bf16x2(x.x, a.scale);
        x.y = scale_bf16x2(x.y, a.scale);
        x.z = scale_bf16x2(x.z, a.scale);
        x.w = scale_bf16x2(x.w, a.scale);
        *pq = x;
      }
      wg::fence_async_shared();
      __syncthreads();
    }

    // s = A1 . B1^T and dP = A2 . B2^T over this warpgroup's 104 columns:
    // k-steps 0-3 of D in the first box of each operand, 4-7 in the second
    const uint32_t cw = wgi * kCols * kAtom;
    float s[kAcc] = {}, p[kAcc] = {};
    wg::hold(s);
    wg::hold(p);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wg::mma_ss_n104(
          s, wg::desc_add(wg::desc<kAtom>(A1 + (kk >> 2) * kRowBox),
                          32 * (kk & 3)),
          wg::desc_add(wg::desc<kAtom>(B1 + (kk >> 2) * L::kColBox + cw),
                       32 * (kk & 3)),
          kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wg::mma_ss_n104(
          p, wg::desc_add(wg::desc<kAtom>(A2 + (kk >> 2) * kRowBox),
                          32 * (kk & 3)),
          wg::desc_add(wg::desc<kAtom>(B2 + (kk >> 2) * L::kColBox + cw),
                       32 * (kk & 3)),
          kk);
    wg::commit();
    // the keep bits while the products run
    uint32_t keep[2] = {~0u, ~0u};
    if (kDropout) load_keep(sm + L::kKeep, keep);
    wg::wait<0>();
    wg::hold(s);
    wg::hold(p);

    // A warp whose 16 rows lie past the end (three of the four of the last
    // row tile at 200 rows) skips the exp and mask work: its rows of the
    // tiles landed as zeros, so s and dP are zero there, and so are the ds
    // and pd they stand in for.
    if (!kPassB) {
      // pn = exp(s - lse) where attended, dpn = dP ms
      if (live) {
#pragma unroll
        for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e, bit = 2 * j + e;
              const float pn = att[hh] >> bit & 1u
                                   ? fast_exp2(fmaf(s[i], kLog2e, -lse2[hh]))
                                   : 0.f;
              float dpn = p[i];
              if (kDropout)
                dpn = keep[hh] >> bit & 1u ? dpn * a.keep_scale : 0.f;
              rs[hh] = fmaf(dpn, pn, rs[hh]);   // read after sweep 0 only
              s[i] = pn;
              p[i] = dpn;
            }
      }
      const bool sums = sweep == 0 && last;
      if (sums) {
        // the row's sum: the quad's, then warpgroup 0's plus 1's
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
          if (c == 0) red[wgi * kRows + 16 * w + g + 8 * hh] = rs[hh];
        }
      }
      // both warpgroups' s and dP are done: q, g, v and the keep bytes are
      // read (and k, without output products in this sweep)
      __syncthreads();
      if (tid == 0 && more) issue(t + 1, fin ? 1 : 3);
      if (sums) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int lr = 16 * w + g + 8 * hh;
          rsum[hh] = red[lr] + red[kRows + lr];
          if (wgi == 0 && c == 0 && r0 + lr < a.Tq)
            a.rowsum[((long long)b * a.H + h) * a.Tq + r0 + lr] = rsum[hh];
        }
      }
      if (fin) {
        // ds = pn (dpn - rowsum), rounded to bf16; dq += ds . k, a box of
        // 64 columns of D at a time
        uint32_t f1[kSteps][4];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) s[i] *= p[i] - rsum[(i >> 1) & 1];
        to_frags(f1, s);
        wg::hold(f1);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint32_t kr = B1 + (wgi * kCols + 16 * kk) * kAtom;
          wg::mma_rs_n64(o1, f1[kk], wg::desc<kAtom>(kr), ch > 0 || kk > 0);
          wg::mma_rs_n64(o2, f1[kk], wg::desc<kAtom>(kr + L::kColBox),
                         ch > 0 || kk > 0);
        }
        wg::commit();
        wg::wait<0>();
        wg::hold(o1);
        wg::hold(o2);
        wg::hold(f1);
        if (last && wgi == 1) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            xchg[i * 128 + t128] = o1[i];
            xchg[(32 + i) * 128 + t128] = o2[i];
          }
        }
        // k is read, and warpgroup 1's dq handed over
        __syncthreads();
        if (tid == 0 && more) issue(t + 1, 2);
        if (last && wgi == 0) {
          // warpgroup 0's dq plus warpgroup 1's, times scale
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 8 * hh;
            if (row >= Tr) continue;
            bf16* op = a.out1 + ((long long)b * Tr + row) * a.H * kD + h * kD;
#pragma unroll
            for (int nt = 0; nt < kBox / 8; ++nt) {
              const int i = 4 * nt + 2 * hh;
              *reinterpret_cast<uint32_t*>(op + 8 * nt + 2 * c) = pack_bf16(
                  (o1[i] + xchg[i * 128 + t128]) * a.scale,
                  (o1[i + 1] + xchg[(i + 1) * 128 + t128]) * a.scale);
              *reinterpret_cast<uint32_t*>(op + kBox + 8 * nt + 2 * c) =
                  pack_bf16(
                      (o2[i] + xchg[(32 + i) * 128 + t128]) * a.scale,
                      (o2[i + 1] + xchg[(32 + i + 1) * 128 + t128]) * a.scale);
            }
          }
        }
      }
    } else {
      // pd = pn ms and ds = pn (dP ms - rowsum), the columns' lse and
      // rowsum from shared memory
      if (live) {
#pragma unroll
        for (int j = 0; j < kBits / 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wgi * kCols + 8 * j + 2 * c + e;
            const float l2 = stat[col], sum = stat[kChunk + col];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int i = 4 * j + 2 * hh + e, bit = 2 * j + e;
              const float pn = att[hh] >> bit & 1u
                                   ? fast_exp2(fmaf(s[i], kLog2e, -l2))
                                   : 0.f;
              float ms = 1.f;
              if (kDropout) ms = keep[hh] >> bit & 1u ? a.keep_scale : 0.f;
              s[i] = pn * ms;
              p[i] = pn * (p[i] * ms - sum);
            }
          }
      }
      put(L::kProd, p);              // ds
      put(L::kProd + L::kPlane, s);  // pd
      wg::fence_async_shared();
      // the planes are written; k, v and the keep bytes are read
      __syncthreads();
      if (tid == 0 && more) issue(t + 1, 1);

      // dk += ds . qs and dv += pd . g over the chunk's queries that hold
      // columns, this warpgroup's box of 64 columns of D
      const int n_ks = min(kChunk / 16, (Tc - ch * kChunk + 15) / 16);
      const uint32_t P1 = base + L::kProd, P2 = P1 + L::kPlane;
      const uint32_t q1 = B1 + wgi * L::kColBox, q2 = B2 + wgi * L::kColBox;
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        if (ks >= n_ks) break;
        const int pa = (ks >> 2) * kRowBox;
        wg::mma_ss_n64_t(
            o1, wg::desc_add(wg::desc<kAtom>(P1 + pa), 32 * (ks & 3)),
            wg::desc<kAtom>(q1 + 16 * ks * kAtom), ch > 0 || ks > 0);
        wg::mma_ss_n64_t(
            o2, wg::desc_add(wg::desc<kAtom>(P2 + pa), 32 * (ks & 3)),
            wg::desc<kAtom>(q2 + 16 * ks * kAtom), ch > 0 || ks > 0);
      }
      wg::commit();
      wg::wait<0>();
      wg::hold(o1);
      wg::hold(o2);
      // qs, g and the planes are read
      __syncthreads();
      if (tid == 0 && more) issue(t + 1, 2);

      if (last) {
        // this warpgroup's 64 columns of the head's dk and dv
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 8 * hh;
          if (row >= Tr) continue;
          const long long o =
              ((long long)b * Tr + row) * a.H * kD + h * kD + kBox * wgi;
#pragma unroll
          for (int nt = 0; nt < kBox / 8; ++nt) {
            const int i = 4 * nt + 2 * hh;
            *reinterpret_cast<uint32_t*>(a.out1 + o + 8 * nt + 2 * c) =
                pack_bf16(o1[i], o1[i + 1]);
            *reinterpret_cast<uint32_t*>(a.out2 + o + 8 * nt + 2 * c) =
                pack_bf16(o2[i], o2[i + 1]);
          }
        }
      }
    }
  }
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_wg128_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap g_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap keep_map,
                             const Args a) {
  bwd_body<false, kDropout>(&q_map, &g_map, &k_map, &v_map, &keep_map, a);
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_wg128_kernel(const __grid_constant__ CUtensorMap k_map,
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
  const int kb_n = (Tk + 7) / 8, tq16 = keep_row(Tq);
  const uintptr_t tail =
      reinterpret_cast<uintptr_t>(rowsum + (size_t)B * H * Tq);
  uint32_t* keep = reinterpret_cast<uint32_t*>((tail + 15) & ~uintptr_t(15));
  // boxes of 64 columns (one 128-byte swizzle atom) of the 128 of a head
  CUtensorMap q_rows, g_rows, k_cols, v_cols, k_rows, v_rows, q_cols, g_cols;
  CUtensorMap keep_a, keep_b;
  if (!tensor_map(&q_rows, q, hidden, Tq, B, q_st, q_sb, kBox, kRows) ||
      !tensor_map(&g_rows, g, hidden, Tq, B, g_st, g_sb, kBox, kRows) ||
      !tensor_map(&k_cols, k, hidden, Tk, B, k_st, k_sb, kBox, kChunk) ||
      !tensor_map(&v_cols, v, hidden, Tk, B, v_st, v_sb, kBox, kChunk) ||
      !tensor_map(&k_rows, k, hidden, Tk, B, k_st, k_sb, kBox, kRows) ||
      !tensor_map(&v_rows, v, hidden, Tk, B, v_st, v_sb, kBox, kRows) ||
      !tensor_map(&q_cols, q, hidden, Tq, B, q_st, q_sb, kBox, kChunk) ||
      !tensor_map(&g_cols, g, hidden, Tq, B, g_st, g_sb, kBox, kChunk) ||
      !byte_map(&keep_a, keep, tq16, kb_n, B * H, kRows, kChunk / 8) ||
      !byte_map(&keep_b, keep, tq16, kb_n, B * H, kChunk, kRows / 8))
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
  Args args{lse,         rowsum, static_cast<bf16*>(dq), nullptr, key_pad,
            static_mask, Tq,     Tk,                     H,       1,
            scale,       keep_scale};
  err = allow_smem(attn_bwd_dq_wg128_kernel<kDropout>, LA::kBytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkdv_wg128_kernel<kDropout>, LB::kBytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kRows - 1) / kRows, n_kt = (Tk + kRows - 1) / kRows;
  args.hpb = walk_heads(B, n_qt, H);
  attn_bwd_dq_wg128_kernel<kDropout>
      <<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, LA::kBytes,
         stream>>>(q_rows, g_rows, k_cols, v_cols, keep_a, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  args.out1 = static_cast<bf16*>(dk);
  args.out2 = static_cast<bf16*>(dv);
  args.hpb = walk_heads(B, n_kt, H);
  attn_bwd_dkdv_wg128_kernel<kDropout>
      <<<dim3((unsigned)B * n_kt, H / args.hpb), kThreads, LB::kBytes,
         stream>>>(k_rows, v_rows, q_cols, g_cols, keep_b, args);
  return cudaGetLastError();
}

}  // namespace k2b128
}  // namespace mmfm
