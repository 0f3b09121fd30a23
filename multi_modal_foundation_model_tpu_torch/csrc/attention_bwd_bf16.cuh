// K2 in bf16 for Hopper (sm_90a): wgmma over the whole key row, tiles fed
// by TMA, one sweep. Included by attention_bwd.cu, which launches it for
// bf16 at head widths 16, 32 and 64 (bf16 at 128 runs
// attention_bwd_bf16_d128.cuh, f32 attention_bwd_f32.cuh and
// attention_bwd_f32_d128.cuh).
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel` with dots_dtype = bf16
// (multi_modal_foundation_model_tpu/ops/attention.py:221, :431): the same
// arithmetic and rounding points as the mma.sync kernels it replaces (qs =
// bf16(f32(q) * scale); k, v, g in bf16; ds and pd rounded to bf16 before
// the dq, dk and dv products; f32 accumulation), the same dropout bits
// (K1's Philox counter (k/4, q, h + h_off, b + b_off), philox.cuh) and the
// same two passes with no atomics:
//   Pass A (attn_bwd_dq_wg_kernel), a block per (batch, 64 query rows) and
//     group of heads: s = qs . k^T and dP = g . v^T over the whole key row
//     at once, rowsum = sum_k dpn pn, ds = pn (dpn - rowsum), dq = ds . k
//     * scale; rowsum goes to the scratch for pass B.
//   Pass B (attn_bwd_dkdv_wg_kernel), a block per (batch, 64 key rows) and
//     group of heads: s^T = k . qs^T and dP^T = v . g^T over the whole query
//     row, pd = pn ms, ds = pn (dpn - rowsum), dk = ds^T . qs, dv = pd^T . g.
// With dropout a third kernel, before them, draws the keep bits.
// Seven products where the bound counts five (s and dP once in each pass);
// the mma.sync kernels took nine (pass A swept the keys twice, once for
// rowsum and once for ds).
//
// What bounds it on the H100 at the training step's shape (B = 256, Tq =
// Tk = 200, H = 8, D = 32, dropout 0.4): bytes, 0.0554 ms (q, g, k, v, lse
// and the masks read once, dq, dk, dv written once, 3.35 TB/s), where the
// five products need 0.047 ms at 989 TFLOP/s; in practice the CUDA cores'
// work per score (the exp, the masks, the Philox draws: 10,000 calls a
// (b, h), ten rounds of integer products each) and the SM's latency.
//
// The design, the two passes alike ("rows" are the block's 64 queries in
// pass A and its 64 keys in pass B, "columns" the other side):
// - Two warpgroups a block (256 threads, one block an SM). Both compute
//   the same 64 rows; warpgroup i takes columns [104 i, 104 i + 104) of a
//   chunk of 208, so s and dP are one m64n104k16 wgmma each a k-step, 52
//   f32 registers each a thread. A row's sum over its whole key row in
//   pass A is the two warpgroups' partial sums added in shared memory, in
//   that order; the outputs (dq, or dk and dv) likewise.
// - Copies: the block's two row tiles (64 x D: qs and g, or k and v) and
//   the two column chunks (208 x D) arrive by four TMA loads on one
//   mbarrier, a stage for each (head, chunk) the block walks; the next
//   stage's loads are in flight while this one is computed. Rows past the
//   end land as zeros. q is scaled to bf16(q * scale) in place once it
//   lands. s and dP read both operands from shared memory (K-major); the
//   output products take ds and pd as A fragments straight from the
//   accumulators (registers) and the column chunk as B, MN-major: the same
//   tile, read transposed.
// - Dropout: a first kernel (attn_bwd_keep_kernel) draws every keep bit
//   once, at full occupancy, into bytes mask[b][h][k / 8][q] (bit k % 8) in
//   the scratch; each pass's stage brings its slice by TMA with the
//   operands, so neither pass draws. (Drawn inside pass A between the
//   wgmma issue and its wait, at one block an SM, the Philox work stood in
//   pass A's way instead of filling the card.) The attend bits (the static
//   mask OR the key pad) are read once a block and kept in registers for
//   every head it walks.
// - Columns past 208 (no model path: every attention there is 200 x 200)
//   take several chunks: pass A then sweeps them twice (rowsum, then ds
//   and dq), pass B once, accumulating dk and dv.
// - Deterministic: every sum in a fixed order, no atomics; a launch is
//   bit-equal to the next.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "philox.cuh"
#include "wgmma_bf16.cuh"

namespace mmfm {
namespace k2wg {

// the tiling K1 and K2 share (kThreads, kRows, kCols, kChunk, to_frags,
// walk_heads, ...)
using namespace wg;

// the dynamic shared memory of a block at head width D, in bytes
template <int D>
struct Layout {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kA = align1k(kRows * kRowBytes);   // a row tile
  static constexpr int kB = align1k(kBRows * kRowBytes);  // a column chunk
  static constexpr int kStage = 2 * kA + 2 * kB;          // A1 A2 B1 B2
  static constexpr int kKeep = 2 * kStage;  // a stage's keep bytes, two
  static constexpr int kXchg = kKeep + 2 * kKeepBuf;  // f32 [2][D / 2][128]
  static constexpr int kRed = kXchg + 2 * (D / 2) * 128 * 4;  // f32 [2][64]
  static constexpr int kStat = kRed + 2 * kRows * 4;  // f32 [2][2][kChunk]
  static constexpr int kBar = kStat + 4 * kChunk * 4;  // two mbarriers
  static constexpr int kBytes = kBar + 16 + 1024;      // + the alignment
};

struct Args {
  const float* lse;
  float* rowsum;
  bf16* out1;             // dq (pass A), dk (pass B)
  bf16* out2;             // dv (pass B)
  const int* key_pad;
  const int* static_mask;
  int Tq, Tk, H, hpb;
  float scale, keep_scale;
};

// The keep bytes of K1's dropout, mask[b][h][kb][q] for kb < ceil(Tk / 8)
// and q < tq16 = Tq rounded up to 16 (0 past Tq): bit i of a byte is key
// 8 kb + i of query q, kept iff K1's Philox draw (counter (k / 4, q,
// h + h_off, b + b_off), philox.cuh) clears the threshold. A thread draws
// 4 queries' bytes (8 Philox calls, philox.cuh keep_word) and writes them
// as one word; the passes read the bytes by TMA.
__global__ void __launch_bounds__(256)
    attn_bwd_keep_kernel(uint32_t* __restrict__ mask,
                         const long long* __restrict__ seed_ptr,
                         unsigned threshold, int H, int Tq, int Tk, int kb_n,
                         int tq16, int b_off, int h_off, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned seed = (unsigned)__ldg(seed_ptr);
  const int words = tq16 / 4;
  const int qw = (int)(i % words);
  const long long rest = i / words;
  const int kb = (int)(rest % kb_n), bh = (int)(rest / kb_n);
  const int b = bh / H, h = bh % H;
  mask[i] = keep_word(seed, threshold, b + b_off, h + h_off, qw, kb, Tq);
}

// Pass A (kPassB false): rows are queries, columns keys; A1 = q (scaled in
// place), A2 = g, B1 = k, B2 = v. Pass B: rows are keys, columns queries;
// A1 = k, A2 = v, B1 = q (scaled in place), B2 = g.
template <bool kPassB, bool kDropout, int D>
__device__ __forceinline__ void bwd_body(const CUtensorMap* mA1,
                                         const CUtensorMap* mA2,
                                         const CUtensorMap* mB1,
                                         const CUtensorMap* mB2,
                                         const CUtensorMap* mKeep,
                                         const Args& a) {
  using L = Layout<D>;
  constexpr int kRB = L::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const xchg = reinterpret_cast<float*>(sm + L::kXchg);
  float* const red = reinterpret_cast<float*>(sm + L::kRed);
  float* const stat = reinterpret_cast<float*>(sm + L::kStat);
  const uint32_t bar0 = base + L::kBar;

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
    wg::mbar_init(bar0, 1);
    wg::mbar_init(bar0 + 8, 1);
    wg::fence_mbar_init();
  }
  // the 8 rows past each column chunk, which the last k-step of the output
  // products reads (times zero ds or pd), zeroed once
  constexpr int kPad = 8 * kRB / 16;       // 16-byte words of 8 rows
  for (int i = tid; i < 4 * kPad; i += kThreads) {
    const int buf = i / kPad;
    const int off = (buf >> 1) * L::kStage + 2 * L::kA + (buf & 1) * L::kB +
                    kChunk * kRB + (i % kPad) * 16;
    *reinterpret_cast<uint4*>(sm + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  wg::fence_async_shared();
  __syncthreads();

  // tile t = (head, sweep, chunk) of the block's walk, into stage t & 1
  auto issue = [&](int t) {
    const int h = h0 + t / per_head, ch = t % per_head % n_ch;
    const uint32_t st = base + (t & 1) * L::kStage;
    const uint32_t bar = bar0 + 8 * (t & 1);
    wg::mbar_expect(bar, 2 * kRows * kRB + 2 * kChunk * kRB +
                             (kDropout ? kKeepBytes : 0));
    if (kDropout)
      wg::tma_load(base + L::kKeep + (t & 1) * kKeepBuf, mKeep, bar,
                   kPassB ? ch * kChunk : r0,
                   kPassB ? r0 / 8 : ch * (kChunk / 8), b * a.H + h);
    wg::tma_load(st, mA1, bar, h * D, r0, b);
    wg::tma_load(st + L::kA, mA2, bar, h * D, r0, b);
    wg::tma_load(st + 2 * L::kA, mB1, bar, h * D, ch * kChunk, b);
    wg::tma_load(st + 2 * L::kA + L::kB, mB2, bar, h * D, ch * kChunk, b);
  };
  if (tid == 0) issue(0);

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]
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
          if (q < a.Tq && k < a.Tk &&
              (__ldg(a.static_mask + (long long)q * a.Tk + k) |
               __ldg(a.key_pad + (long long)b * a.Tk + k)) != 0)
            m[hh] |= 1u << (2 * j + e);
        }
  };

  // the keep bits of this thread's elements, in attend's order, from the
  // stage's keep bytes mk: pass A's [26 key bytes][64 queries] (keys
  // cb + 8 j + 2 c + e are bits 2 c + e of byte 13 wgi + j of its row),
  // pass B's [8 key bytes][208 queries] (keys row0 and row0 + 8 are bit g
  // of bytes 2 w and 2 w + 1 of each query)
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
  float next[2];
  stats_of(0, next);

  // tile t's stage made ready for its products, before the barrier that
  // starts the tile: its copies landed, q * scale rounded to bf16 in
  // place (pass A's row tile, pass B's column chunk), and in pass B its
  // columns' lse and rowsum in shared memory (two buffers, by t & 1)
  auto prepare = [&](int t) {
    if (kPassB) {
      float* sb = stat + (t & 1) * 2 * kChunk;
      if (tid < kChunk) {
        sb[tid] = next[0];
        sb[kChunk + tid] = next[1];
      }
      if (t + 1 < n_tiles) stats_of(t + 1, next);
    }
    wg::mbar_wait(bar0 + 8 * (t & 1), (t >> 1) & 1);
    const int bytes = (kPassB ? kChunk : kRows) * kRB;
    unsigned char* qt = sm + (t & 1) * L::kStage + (kPassB ? 2 * L::kA : 0);
    for (int i = tid * 16; i < bytes; i += kThreads * 16) {
      uint4* p = reinterpret_cast<uint4*>(qt + i);
      uint4 x = *p;
      x.x = scale_bf16x2(x.x, a.scale);
      x.y = scale_bf16x2(x.y, a.scale);
      x.z = scale_bf16x2(x.z, a.scale);
      x.w = scale_bf16x2(x.w, a.scale);
      *p = x;
    }
    wg::fence_async_shared();
  };

  uint32_t att[2] = {0u, 0u};
  if (n_ch == 1) attend(0, att);
  float lse2[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};
  float o1[D / 2] = {}, o2[D / 2] = {};
  prepare(0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / per_head, r = t % per_head;
    const int sweep = r / n_ch, ch = r % n_ch;
    const bool fin = sweep == sweeps - 1, last = ch == n_ch - 1;
    const uint32_t st = base + (t & 1) * L::kStage;
    // stage (t + 1) & 1 held tile t - 1, whose readers are done
    if (tid == 0 && t + 1 < n_tiles) issue(t + 1);
    if (n_ch > 1) attend(ch, att);
    if (!kPassB && r == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lse2[hh] = next[hh];
        rs[hh] = 0.f;
      }
      if (t + per_head < n_tiles) stats_of(t + per_head, next);
    }

    // s = A1 . B1^T and dP = A2 . B2^T over this warpgroup's 104 columns
    const uint32_t b1 = st + 2 * L::kA + wgi * kCols * kRB;
    const uint32_t b2 = b1 + L::kB;
    float s[kAcc] = {}, p[kAcc] = {};
    wg::hold(s);
    wg::hold(p);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n104(s, wg::desc_add(wg::desc<kRB>(st), 32 * kk),
                      wg::desc_add(wg::desc<kRB>(b1), 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n104(p, wg::desc_add(wg::desc<kRB>(st + L::kA), 32 * kk),
                      wg::desc_add(wg::desc<kRB>(b2), 32 * kk), kk);
    wg::commit();
    // the keep bits while the products run
    uint32_t keep[2] = {~0u, ~0u};
    if (kDropout) load_keep(sm + L::kKeep + (t & 1) * kKeepBuf, keep);
    wg::wait<0>();
    wg::hold(s);
    wg::hold(p);

    // A warp whose 16 rows lie past the end (three of the four of the last
    // row tile at 200 rows) skips the exp and mask work: its rows of the
    // tiles landed as zeros, so s and dP are zero there, and so are the ds
    // and pd they stand in for.
    uint32_t f1[kSteps][4];
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
      if (fin) {
        // ds = pn (dpn - rowsum), rounded to bf16; dq += ds . k
#pragma unroll
        for (int i = 0; i < kAcc; ++i) s[i] *= p[i] - rsum[(i >> 1) & 1];
        to_frags(f1, s);
        wg::hold(f1);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wg::mma_rs(o1, f1[kk],
                     wg::desc_add(wg::desc<kRB>(b1), kk * 16 * kRB),
                     ch > 0 || kk > 0);
        wg::commit();
        wg::wait<0>();
        wg::hold(o1);
        wg::hold(f1);
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
            const float* sb = stat + (t & 1) * 2 * kChunk;
            const float l2 = sb[col], sum = sb[kChunk + col];
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
      uint32_t f2[kSteps][4];
      to_frags(f1, p);   // ds
      to_frags(f2, s);   // pd
      wg::hold(f1);
      wg::hold(f2);
      wg::fence();
      // dk += ds . qs, dv += pd . g
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        wg::mma_rs(o1, f1[kk], wg::desc_add(wg::desc<kRB>(b1), kk * 16 * kRB),
                   ch > 0 || kk > 0);
        wg::mma_rs(o2, f2[kk], wg::desc_add(wg::desc<kRB>(b2), kk * 16 * kRB),
                   ch > 0 || kk > 0);
      }
      wg::commit();
      wg::wait<0>();
      wg::hold(o1);
      wg::hold(o2);
      wg::hold(f1);
      wg::hold(f2);
    }

    if (fin && last) {
      // warpgroup 0's outputs plus warpgroup 1's, stored by warpgroup 0
      if (wgi == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          xchg[i * 128 + t128] = o1[i];
          if (kPassB) xchg[(D / 2 + i) * 128 + t128] = o2[i];
        }
      }
      __syncthreads();
      if (wgi == 0) {
        const float mul = kPassB ? 1.f : a.scale;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 8 * hh;
          if (row >= Tr) continue;
          const long long o = ((long long)b * Tr + row) * a.H * D + h * D;
#pragma unroll
          for (int nt = 0; nt < D / 8; ++nt) {
            const int i = 4 * nt + 2 * hh;
            *reinterpret_cast<uint32_t*>(a.out1 + o + 8 * nt + 2 * c) =
                pack_bf16((o1[i] + xchg[i * 128 + t128]) * mul,
                          (o1[i + 1] + xchg[(i + 1) * 128 + t128]) * mul);
            if (kPassB)
              *reinterpret_cast<uint32_t*>(a.out2 + o + 8 * nt + 2 * c) =
                  pack_bf16(o2[i] + xchg[(D / 2 + i) * 128 + t128],
                            o2[i + 1] + xchg[(D / 2 + i + 1) * 128 + t128]);
          }
        }
      }
    }
    // the next tile's stage made ready; the barrier ends this tile (its
    // stage's readers are done) and starts the next
    if (t + 1 < n_tiles) prepare(t + 1);
    __syncthreads();
  }
}

template <bool kDropout, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap keep_map,
                          const Args a) {
  bwd_body<false, kDropout, D>(&q_map, &g_map, &k_map, &v_map, &keep_map, a);
}

template <bool kDropout, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap g_map,
                            const __grid_constant__ CUtensorMap keep_map,
                            const Args a) {
  bwd_body<true, kDropout, D>(&k_map, &v_map, &q_map, &g_map, &keep_map, a);
}

// The keep draws and both passes on the stream: operands as
// mmfm_attention_bwd takes them (attention_bwd.cu); the scratch holds
// rowsum (B, H, Tq) f32, then, 16-byte aligned, the keep bytes (B, H,
// ceil(Tk / 8), keep_row(Tq)) (ops/attention.py::_k2_scratch_floats).
template <bool kDropout, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const int* key_pad, const int* static_mask,
                   const float* lse, float* rowsum, void* dq, void* dk,
                   void* dv, int B, int Tq, int Tk, int H, long long q_sb,
                   long long q_st, long long k_sb, long long k_st,
                   long long v_sb, long long v_st, long long g_sb,
                   long long g_st, float scale, const long long* seed,
                   unsigned threshold, float keep_scale, int b_off,
                   int h_off, cudaStream_t stream) {
  const int hidden = H * D;
  const int kb_n = (Tk + 7) / 8, tq16 = keep_row(Tq);
  const uintptr_t tail =
      reinterpret_cast<uintptr_t>(rowsum + (size_t)B * H * Tq);
  uint32_t* keep = reinterpret_cast<uint32_t*>((tail + 15) & ~uintptr_t(15));
  CUtensorMap q_rows, g_rows, k_cols, v_cols, k_rows, v_rows, q_cols, g_cols;
  CUtensorMap keep_a, keep_b;
  if (!wg::tensor_map(&q_rows, q, hidden, Tq, B, q_st, q_sb, D, kRows) ||
      !wg::tensor_map(&g_rows, g, hidden, Tq, B, g_st, g_sb, D, kRows) ||
      !wg::tensor_map(&k_cols, k, hidden, Tk, B, k_st, k_sb, D, kChunk) ||
      !wg::tensor_map(&v_cols, v, hidden, Tk, B, v_st, v_sb, D, kChunk) ||
      !wg::tensor_map(&k_rows, k, hidden, Tk, B, k_st, k_sb, D, kRows) ||
      !wg::tensor_map(&v_rows, v, hidden, Tk, B, v_st, v_sb, D, kRows) ||
      !wg::tensor_map(&q_cols, q, hidden, Tq, B, q_st, q_sb, D, kChunk) ||
      !wg::tensor_map(&g_cols, g, hidden, Tq, B, g_st, g_sb, D, kChunk) ||
      !wg::byte_map(&keep_a, keep, tq16, kb_n, B * H, kRows, kChunk / 8) ||
      !wg::byte_map(&keep_b, keep, tq16, kb_n, B * H, kChunk, kRows / 8))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kDropout) {
    const long long n = (long long)B * H * kb_n * (tq16 / 4);
    attn_bwd_keep_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        keep, seed, threshold, H, Tq, Tk, kb_n, tq16, b_off, h_off, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  Args args{lse,         rowsum, static_cast<bf16*>(dq), nullptr, key_pad,
            static_mask, Tq,     Tk,                     H,       1,
            scale,       keep_scale};
  const size_t smem = Layout<D>::kBytes;
  err = allow_smem(attn_bwd_dq_wg_kernel<kDropout, D>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkdv_wg_kernel<kDropout, D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kRows - 1) / kRows, n_kt = (Tk + kRows - 1) / kRows;
  args.hpb = walk_heads(B, n_qt, H);
  attn_bwd_dq_wg_kernel<kDropout, D>
      <<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, smem, stream>>>(
          q_rows, g_rows, k_cols, v_cols, keep_a, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  args.out1 = static_cast<bf16*>(dk);
  args.out2 = static_cast<bf16*>(dv);
  args.hpb = walk_heads(B, n_kt, H);
  attn_bwd_dkdv_wg_kernel<kDropout, D>
      <<<dim3((unsigned)B * n_kt, H / args.hpb), kThreads, smem, stream>>>(
          k_rows, v_rows, q_cols, g_cols, keep_b, args);
  return cudaGetLastError();
}

}  // namespace k2wg
}  // namespace mmfm
