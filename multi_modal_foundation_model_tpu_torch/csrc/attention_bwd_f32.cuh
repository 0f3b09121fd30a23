// K2 in f32 for Hopper (sm_90a): 3xTF32 on wgmma over the whole key row,
// tiles fed by TMA, the keep bits drawn apart. Included by
// attention_bwd.cu, which launches it for f32 at head widths 16, 32 and 64
// (at 128, whose planes do not fit this layout, attention_bwd_f32_d128.cuh
// runs).
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel` with f32 dots
// (multi_modal_foundation_model_tpu/ops/attention.py:221, :439): the f32
// contract of the mma.sync kernels it replaces (q * scale stays f32, nothing is
// rounded to bf16; every product is 3xTF32, hi = tf32(x) and lo = tf32(x - hi)
// by mma_tf32.cuh split_tf32, f32 sums), the same dropout bits (K1's Philox
// counter (k/4, q, h + h_off, b + b_off), philox.cuh) and the same two passes
// with no atomics as the bf16 K2 on wgmma (attention_bwd_bf16.cuh):
//   Pass A (attn_bwd_dq_tf_kernel), a block per (batch, 64 query rows) and
//     group of heads: s = qs . k^T and dP = g . v^T over the whole key row,
//     rowsum = sum_k dpn pn, ds = pn (dpn - rowsum), dq = ds . k * scale.
//   Pass B (attn_bwd_dkdv_tf_kernel), a block per (batch, 64 key rows) and
//     group of heads: s^T = k . qs^T and dP^T = v . g^T over a chunk of
//     queries at a time, pd = pn ms, ds = pn (dpn - rowsum), dk = ds^T .
//     qs, dv = pd^T . g.
// With dropout attn_bwd_keep_kernel (attention_bwd_bf16.cuh) draws the keep
// bits first: they depend on the counter and the threshold, not the dtype.
// Seven products where the bound counts five, at Tk up to pass A's chunk
// (208 keys at D = 16 and 32); the mma.sync kernels took nine.
//
// What bounds it on the H100 at the training step's shape (B = 256, Tq =
// Tk = 200, H = 8, D = 32): the five products at three TF32 terms each,
// 0.159 ms at 495 TFLOP/s, against 0.110 ms of bytes.
//
// The design, and what f32 changes from the bf16 kernel:
// - Two warpgroups a block (256 threads, one block an SM), both on the same
//   64 rows, warpgroup i on columns [kCols i, kCols i + kCols) of a chunk
//   of 2 kCols (Layout<D, pass>::kCols: 104 where the planes fit, else 56,
//   40 or 24); pass A's row sums and both passes' outputs are the two
//   warpgroups' partial sums added in shared memory, in that order.
// - TF32 wgmma reads both operands K-major. s and dP read the tiles as they
//   land (rows of D floats); dq = ds . k, dk = ds^T . qs and dv = pd^T . g
//   need k, qs and g with the key or query index contiguous. So a landed
//   tile is split once, by the block's threads, into planes: hi in place
//   and lo beside it (natural), and for k (pass A), qs and g (pass B) also
//   transposed hi and lo planes, [32-column group][d][32 columns], 128-byte
//   swizzled, whose k order within each 8 is permuted (perm_k) so that ds
//   and pd go from the accumulators into A fragments in registers with no
//   shuffle. Pass A at D <= 32 holds 10 planes of a 208-key chunk (206 KB);
//   pass B's two transposed operands take 12 planes, so it takes chunks of
//   112 queries at D = 32; D = 64 takes chunks of 80 (pass A: two sweeps
//   at Tk = 200) and 48.
// - The tensor cores truncate their f32 sums, so every k-step's three terms
//   (al . bh, ah . bl, ah . bh) are summed from zero (scale-d = 0) into a
//   temporary and added to the running sum in f32 (emulated, with the
//   output products' split between the warpgroups, by
//   tests/tf32_emulation.py, dot_3xtf32_wg). The split and the k-steps of
//   s are tiles_f32.cuh's, which the f32 K1 at these widths takes too, so
//   pass A recomputes bit for bit the s that K1 summarised into lse; the
//   split, and ds's and pd's fragments, round to TF32 by mma_tf32.cuh
//   tf32_rna, as every f32 kernel does. On the H100 at the training step's
//   inputs (the three
//   mask cases, dropout 0 and 0.4) the kernel reads within 4.1e-6 of the
//   f32 plain version (the gate is 1e-5), 2.9e-6 of an f64 evaluation and
//   1.2e-6 of the emulation (scripts/torch_k2_f32_accuracy.py).
// - One stage: the tiles (q, g, k, v: natural f32, rows past the end as
//   zeros) and the keep bytes arrive by TMA on an mbarrier into the hi
//   planes; the next tile's loads are issued as soon as s and dP have read
//   them, so they land while this tile's elementwise work and output
//   products run. The row tiles come and are split once a head.
// - Columns past a chunk take several chunks (at D = 32 pass A's past 208
//   keys, pass B's past 112 queries): pass A then sweeps them twice
//   (rowsum, then ds and dq), pass B once, accumulating dk and dv; pass B
//   keeps two chunks' attend bits in registers for every head it walks.
// - Deterministic: every sum in a fixed order, no atomics; a launch is
//   bit-equal to the next.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd_bf16.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"
#include "tiles_f32.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace mmfm {
namespace k2tf {

using wg::align1k;
using wg::kRows;
using wg::kThreads;

// The dynamic shared memory of a block of pass A (kPassB false) or B at
// head width D, in bytes: the row planes (A1 hi, lo, A2 hi, lo: 64 rows),
// the column planes (B1 hi, lo, B2 hi, lo: a chunk's rows), the transposed
// planes (B1 hi, lo, and in pass B B2 hi, lo), the keep bytes, the
// exchange of the outputs and the row sums, pass B's column statistics and
// the mbarrier.
template <int D, bool kPassB>
struct Layout {
  static constexpr int kCols =
      !kPassB ? (D <= 32 ? 104 : 40) : (D <= 16 ? 104 : D <= 32 ? 56 : 24);
  static constexpr int kChunk = 2 * kCols;
  static constexpr int kAcc = kCols / 2;   // f32 a thread of a 64 x kCols sum
  static constexpr int kN8 = kCols / 8;    // n8 blocks = output k-steps
  static constexpr int kW = f32t::Rows<D>::kW;   // floats a plane row
  static constexpr int kHalves = f32t::Rows<D>::kHalves;  // column blocks
  static constexpr int kRowB = f32t::Rows<D>::kRowB;
  static constexpr int kHalfA = align1k(kRows * kRowB);
  static constexpr int kHalfB = align1k(kChunk * kRowB);
  static constexpr int kA = kHalves * kHalfA;   // a row plane
  static constexpr int kB = kHalves * kHalfB;   // a column plane
  static constexpr int kT = (kChunk + 31) / 32 * D * 128;  // transposed
  static constexpr int kNT = kPassB ? 2 : 1;   // transposed operands
  static constexpr int kPlanesB = 4 * kA;
  static constexpr int kPlanesT = kPlanesB + 4 * kB;
  static constexpr int kKeep = kPlanesT + 2 * kNT * kT;
  static constexpr int kKeepBytes = kRows * (kChunk / 8);
  static constexpr int kXchg = kKeep + (kKeepBytes + 127) / 128 * 128;
  static constexpr int kRed = kXchg + kNT * (D / 2) * 128 * 4;
  static constexpr int kStat = kRed + 2 * kRows * 4;   // f32 [2][64]
  static constexpr int kBar = kStat + 2 * kChunk * 4;  // f32 [2][kChunk]
  static constexpr int kBytes = kBar + 8 + 1024;       // + the alignment
  static_assert(kBytes <= 232448, "a block's shared memory on the H100");
  static_assert(kCols % 8 == 0 && kChunk <= 256, "k-steps of 8, a TMA box");
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
// scale), A2 = g, B1 = k (also transposed), B2 = v. Pass B: rows are keys,
// columns queries; A1 = k, A2 = v, B1 = q (times scale), B2 = g (both also
// transposed).
template <bool kPassB, bool kDropout, int D>
__device__ __forceinline__ void bwd_body(const CUtensorMap* mA1,
                                         const CUtensorMap* mA2,
                                         const CUtensorMap* mB1,
                                         const CUtensorMap* mB2,
                                         const CUtensorMap* mKeep,
                                         const Args& a) {
  using L = Layout<D, kPassB>;
  constexpr int kCols = L::kCols, kChunk = L::kChunk, kAcc = L::kAcc;
  constexpr int kN8 = L::kN8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const xchg = reinterpret_cast<float*>(sm + L::kXchg);
  float* const red = reinterpret_cast<float*>(sm + L::kRed);
  float* const stat = reinterpret_cast<float*>(sm + L::kStat);
  const uint32_t bar = base + L::kBar;

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
  __syncthreads();

  // tile t = (head, sweep, chunk) of the block's walk, raw f32 into the hi
  // planes, the keep bytes into their buffer; the row tiles (A1, A2) only
  // with a head's first tile: its other tiles read the planes made then
  auto issue = [&](int t) {
    const int h = h0 + t / per_head, ch = t % per_head % n_ch;
    const bool rows = t % per_head == 0;
    wg::mbar_expect(bar, ((rows ? 2 * kRows : 0) + 2 * kChunk) * D * 4 +
                             (kDropout ? L::kKeepBytes : 0));
    if (kDropout)
      wg::tma_load(base + L::kKeep, mKeep, bar, kPassB ? ch * kChunk : r0,
                   kPassB ? r0 / 8 : ch * (kChunk / 8), b * a.H + h);
#pragma unroll
    for (int hf = 0; hf < L::kHalves; ++hf) {
      const int c0 = h * D + L::kW * hf;
      if (rows) {
        wg::tma_load(base + hf * L::kHalfA, mA1, bar, c0, r0, b);
        wg::tma_load(base + 2 * L::kA + hf * L::kHalfA, mA2, bar, c0, r0, b);
      }
      wg::tma_load(base + L::kPlanesB + hf * L::kHalfB, mB1, bar, c0,
                   ch * kChunk, b);
      wg::tma_load(base + L::kPlanesB + 2 * L::kB + hf * L::kHalfB, mB2, bar,
                   c0, ch * kChunk, b);
    }
  };
  if (tid == 0) issue(0);

  // the attend bits of this thread's elements in chunk ch: element (row
  // hh, n8 block j, column e) is bit 2 j + e of m[hh]. Every load is
  // issued (indices clamped into the masks), so that they are in flight
  // together rather than one branch at a time.
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

  // the attend bits of the chunk: read once a block where there is one
  // chunk; pass B, which walks two chunks a head at Tq up to 2 kChunk
  // (the model's 200 queries at D = 32), keeps both chunks' for every head
  uint32_t att[2] = {0u, 0u}, att1[2] = {0u, 0u};
  const bool held = n_ch == 1 || (kPassB && n_ch == 2);
  if (held) attend(0, att);
  if (kPassB && n_ch == 2) attend(1, att1);
  uint32_t att0[2] = {att[0], att[1]};
  float lse[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f}, rsum[2] = {0.f, 0.f};
  float o1[D / 2], o2[D / 2];
  for (int t = 0; t < n_tiles; ++t) {
    const int h = h0 + t / per_head, r = t % per_head;
    const int sweep = r / n_ch, ch = r % n_ch;
    const bool fin = sweep == sweeps - 1, last = ch == n_ch - 1;
    if (kPassB) {
      if (tid < kChunk) {
        stat[tid] = next[0];
        stat[kChunk + tid] = next[1];
      }
      if (t + 1 < n_tiles) stats_of(t + 1, next);
    }
    if (!held) {
      attend(ch, att);
    } else if (kPassB && n_ch == 2) {
      att[0] = ch ? att1[0] : att0[0];
      att[1] = ch ? att1[1] : att0[1];
    }
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o1[i] = o2[i] = 0.f;
      if (!kPassB) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          lse[hh] = next[hh];
          rs[hh] = 0.f;
        }
        if (t + per_head < n_tiles) stats_of(t + per_head, next);
      }
    }

    // the tile landed; its planes made, then visible to the tensor cores
    wg::mbar_wait(bar, t & 1);
    if (r == 0) {
      f32t::split<D, kRows, !kPassB, true, false>(sm, L::kHalfA, L::kA,
                                                  nullptr, 0, a.scale, tid);
      f32t::split<D, kRows, false, true, false>(
          sm + 2 * L::kA, L::kHalfA, L::kA, nullptr, 0, a.scale, tid);
    }
    f32t::split<D, kChunk, kPassB, true, true>(
        sm + L::kPlanesB, L::kHalfB, L::kB, sm + L::kPlanesT, L::kT, a.scale,
        tid);
    f32t::split<D, kChunk, false, true, kPassB>(
        sm + L::kPlanesB + 2 * L::kB, L::kHalfB, L::kB,
        sm + L::kPlanesT + 2 * L::kT, L::kT, a.scale, tid);
    wg::fence_async_shared();
    __syncthreads();

    // s = A1 . B1^T and dP = A2 . B2^T over this warpgroup's kCols columns,
    // a k-step at a time: the first from zero into s and dP, each further
    // one from zero into tmp, then added in f32
    const uint32_t a1 = base, a2 = base + 2 * L::kA;
    const uint32_t b1 = base + L::kPlanesB, b2 = b1 + 2 * L::kB;
    const int cb = wgi * kCols * L::kRowB;
    float s[kAcc], p[kAcc];
    wg::fence();
    f32t::step3<D>(s, a1, L::kHalfA, L::kA, b1, L::kHalfB, L::kB, cb, 0);
    f32t::step3<D>(p, a2, L::kHalfA, L::kA, b2, L::kHalfB, L::kB, cb, 0);
    wg::commit();
    // the keep bits while the products run
    uint32_t keep[2] = {~0u, ~0u};
    if (kDropout) load_keep(sm + L::kKeep, keep);
#pragma unroll
    for (int kk = 1; kk < D / 8; ++kk) {
      float tmp[kAcc];
      wg::fence();
      f32t::step3<D>(tmp, a1, L::kHalfA, L::kA, b1, L::kHalfB, L::kB, cb,
                     kk);
      wg::commit();
      wg::wait<0>();
      wg::hold(s);
      wg::hold(p);
      wg::hold(tmp);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) s[i] += tmp[i];
      wg::fence();
      f32t::step3<D>(tmp, a2, L::kHalfA, L::kA, b2, L::kHalfB, L::kB, cb,
                     kk);
      wg::commit();
      wg::wait<0>();
      wg::hold(tmp);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) p[i] += tmp[i];
    }
    wg::wait<0>();
    wg::hold(s);
    wg::hold(p);
    // both warpgroups are done with the natural planes and the keep bytes:
    // the next tile's copies land there while this one finishes
    __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) issue(t + 1);

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
      if (fin) {
        // ds = pn (dpn - rowsum); dq += ds . k, a k-step at a time from
        // zero, then added in f32
#pragma unroll
        for (int i = 0; i < kAcc; ++i) s[i] *= p[i] - rsum[(i >> 1) & 1];
        const uint32_t t1 = base + L::kPlanesT;
#pragma unroll
        for (int kk = 0; kk < kN8; ++kk) {
          uint32_t fh[4], fl[4];
          wgtf::to_frags_tf32(s, kk, fh, fl);
          float o[D / 2];
          wg::fence();
          wgtf::mma3_rs(o, fh, fl, f32t::tr<D>(t1, wgi * kN8 + kk),
                        f32t::tr<D>(t1 + L::kT, wgi * kN8 + kk));
          wg::commit();
          wg::wait<0>();
          wg::hold(o);
          wgtf::hold(fh);
          wgtf::hold(fl);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o1[i] += o[i];
        }
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
      // dk += ds . qs, dv += pd . g, a k-step at a time from zero, then
      // added in f32
      const uint32_t t1 = base + L::kPlanesT, t2 = t1 + 2 * L::kT;
#pragma unroll
      for (int kk = 0; kk < kN8; ++kk) {
        uint32_t dh[4], dl[4], ph[4], pl[4];
        wgtf::to_frags_tf32(p, kk, dh, dl);
        wgtf::to_frags_tf32(s, kk, ph, pl);
        const int ks = wgi * kN8 + kk;
        float ok[D / 2], ov[D / 2];
        wg::fence();
        wgtf::mma3_rs(ok, dh, dl, f32t::tr<D>(t1, ks),
                      f32t::tr<D>(t1 + L::kT, ks));
        wgtf::mma3_rs(ov, ph, pl, f32t::tr<D>(t2, ks),
                      f32t::tr<D>(t2 + L::kT, ks));
        wg::commit();
        wg::wait<0>();
        wg::hold(ok);
        wg::hold(ov);
        wgtf::hold(dh);
        wgtf::hold(dl);
        wgtf::hold(ph);
        wgtf::hold(pl);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          o1[i] += ok[i];
          o2[i] += ov[i];
        }
      }
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
            *reinterpret_cast<float2*>(a.out1 + o + 8 * nt + 2 * c) =
                make_float2((o1[i] + xchg[i * 128 + t128]) * mul,
                            (o1[i + 1] + xchg[(i + 1) * 128 + t128]) * mul);
            if (kPassB)
              *reinterpret_cast<float2*>(a.out2 + o + 8 * nt + 2 * c) =
                  make_float2(o2[i] + xchg[(D / 2 + i) * 128 + t128],
                              o2[i + 1] + xchg[(D / 2 + i + 1) * 128 + t128]);
          }
        }
      }
    }
    // this tile's readers are done: the transposed planes, the statistics
    __syncthreads();
  }
}

template <bool kDropout, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_tf_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap keep_map,
                          const Args a) {
  bwd_body<false, kDropout, D>(&q_map, &g_map, &k_map, &v_map, &keep_map, a);
}

template <bool kDropout, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_tf_kernel(const __grid_constant__ CUtensorMap k_map,
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
// ceil(Tk / 8), keep_row(Tq)), as the bf16 kernel's
// (ops/attention.py::_k2_scratch_floats).
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
  using LA = Layout<D, false>;
  using LB = Layout<D, true>;
  const int hidden = H * D;
  const int kb_n = (Tk + 7) / 8, tq16 = wg::keep_row(Tq);
  const uintptr_t tail =
      reinterpret_cast<uintptr_t>(rowsum + (size_t)B * H * Tq);
  uint32_t* keep = reinterpret_cast<uint32_t*>((tail + 15) & ~uintptr_t(15));
  CUtensorMap q_rows, g_rows, k_cols, v_cols, k_rows, v_rows, q_cols, g_cols;
  CUtensorMap keep_a, keep_b;
  using wgtf::tensor_map_f32;
  if (!tensor_map_f32(&q_rows, q, hidden, Tq, B, q_st, q_sb, D, kRows) ||
      !tensor_map_f32(&g_rows, g, hidden, Tq, B, g_st, g_sb, D, kRows) ||
      !tensor_map_f32(&k_cols, k, hidden, Tk, B, k_st, k_sb, D, LA::kChunk) ||
      !tensor_map_f32(&v_cols, v, hidden, Tk, B, v_st, v_sb, D, LA::kChunk) ||
      !tensor_map_f32(&k_rows, k, hidden, Tk, B, k_st, k_sb, D, kRows) ||
      !tensor_map_f32(&v_rows, v, hidden, Tk, B, v_st, v_sb, D, kRows) ||
      !tensor_map_f32(&q_cols, q, hidden, Tq, B, q_st, q_sb, D, LB::kChunk) ||
      !tensor_map_f32(&g_cols, g, hidden, Tq, B, g_st, g_sb, D, LB::kChunk) ||
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
  err = allow_smem(attn_bwd_dq_tf_kernel<kDropout, D>, LA::kBytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkdv_tf_kernel<kDropout, D>, LB::kBytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + kRows - 1) / kRows, n_kt = (Tk + kRows - 1) / kRows;
  args.hpb = wg::walk_heads(B, n_qt, H);
  attn_bwd_dq_tf_kernel<kDropout, D>
      <<<dim3((unsigned)B * n_qt, H / args.hpb), kThreads, LA::kBytes,
         stream>>>(q_rows, g_rows, k_cols, v_cols, keep_a, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  args.out1 = static_cast<float*>(dk);
  args.out2 = static_cast<float*>(dv);
  args.hpb = wg::walk_heads(B, n_kt, H);
  attn_bwd_dkdv_tf_kernel<kDropout, D>
      <<<dim3((unsigned)B * n_kt, H / args.hpb), kThreads, LB::kBytes,
         stream>>>(k_rows, v_rows, q_cols, g_cols, keep_b, args);
  return cudaGetLastError();
}

}  // namespace k2tf
}  // namespace mmfm
