// K2: fused multi-head attention backward for Hopper (sm_90a), on the
// tensor cores in f32 (3xTF32) and bf16. mmfm_attention_bwd launches the
// wgmma kernels (TMA tiles, the keep bits drawn apart): at head widths 16,
// 32 and 64 bf16 of attention_bwd_bf16.cuh and f32 of
// attention_bwd_f32.cuh, at 128 f32 of attention_bwd_f32_d128.cuh (the
// output products taken transposed). This file's kernels, the mma.sync
// pair, run bf16 at 128, whose accumulators (dk and dv, 64 registers each
// a thread at N = 128) leave no room for s and dP of the whole row.
//
// Replaces the Pallas TPU kernel `_attn_bwd_kernel`
// (multi_modal_foundation_model_tpu/ops/attention.py:221, launched by
// `_flash_mha_bwd`, :418-453). Given K1's operands, the output gradient g
// and K1's row statistic lse = max(m, -1e6) + log(l), per (b, h):
//   s   = (q * scale) . k + bias              (bias as in K1: 0 or -1e30)
//   pn  = exp(s - lse)                        (the softmax probabilities)
//   ms  = keep / (1 - rate)                   (K1's Philox mask, replayed)
//   pd  = pn * ms,   dpn = (g . v) * ms
//   ds  = pn * (dpn - sum_k dpn * pn)
//   dq  = ds . k * scale,   dk = ds^T . (q * scale),   dv = pd^T . g
// A fully-masked query row (a padded trial under the decoder's pad-only
// mask) has lse = -1e6 + log(Tk) and scores of -1e30, so pn = 0 there and
// the row gets ZERO gradient, the contract of the JAX kernel (:57-63).
//
// The TPU kernel ran a whole batch block per sequential grid step with two
// (GB, H*Tq, Tk) VMEM scratch stacks; nothing like it fits an SM, and
// blocks run in no order, so K2 takes two passes with no atomics
// (bit-reproducible from run to run):
//   Pass A (attn_bwd_dq_tc_kernel), one block per (batch, 64-query tile)
//     and group of heads: a first sweep over the keys sums rowsum = sum_k
//     dpn * pn, a second computes ds and accumulates dq. rowsum goes to a
//     small (B, H, Tq) f32 buffer.
//   Pass B (attn_bwd_dkdv_tc_kernel), one block per (batch, 64-key tile)
//     and group of heads: dk and dv, with q * scale, g, lse and rowsum
//     streamed over the queries.
// Pass A recomputes s and g . v twice and pass B once more: 9 products
// where the bound counts 5.
//
// The pair is templated on the operand type as K1 is (Tc<T, D> in
// tc_traits.cuh holds what differs, shared with K1); it runs bf16 only.
// Four warps a block, each owning 16 rows of its side: its two operands
// (q * scale and g, or k and v) are mma A fragments in registers; the other
// side streams through shared memory in 64-row tiles by cp.async (16 B a
// copy, double-buffered, tail rows zero-filled), and each thread readies
// the chunks it copied once they land, before the tile's one barrier. The
// s and g . v accumulators turn into the A fragments of the next product
// in registers, never touching memory. Pass A draws the keep bits of its
// 64 query rows against every key into shared memory, one keep_bits4 call
// per (query, 4 keys) spread over its threads (the same Philox counter
// (k/4, q, h, b) as K1, philox.cuh, so the backward replays K1's dropout),
// next to the attend bits of the mask (one byte per (row, 4 keys): keep in
// the low nibble, attend in the high one), reads them in both sweeps, and
// writes each head's bytes out to the scratch after rowsum (B H Tq Tk / 4
// bytes, rows padded to 64 keys: 26 MB at the training step's shape);
// pass B streams its 16 bytes a query with the query tiles, and draws
// nothing and reads no mask. A block walks through up to all H heads of
// its (batch, row tile): pass A reads the (Tq, Tk) int32 static mask once
// for all of them (read per (b, h) block, it was the bf16 kernel's largest
// cost) and redraws only the keep bits per head, into a second buffer, a
// slice with each tile of the head before, so that the draws run beside
// the products.
//
// f32 (3xTF32): the f32 contract, the plain version's f32 math, with no
// bf16 rounding anywhere (q * scale stays f32). Every product is three
// TF32 wgmma products of operands split into hi = tf32(x) and lo = tf32(x
// - hi), each k-step's three summed from zero before an f32 add (the
// tensor cores truncate their sums; attention_bwd_f32.cuh notes the
// accuracy on the H100). pn = ex2.approx.ftz((s - lse) * log2(e))
// (fast_exp2: ~2 ulp; results below 2^-126 flush to 0, where exp(s - lse)
// adds nothing at the gate): the subtraction before the base-2 scale
// keeps the argument's rounding relative to s - lse, not to s.
//
// bf16 (mma_bf16.cuh): the arithmetic of JAX's K2 on its own hardware
// (dots_dtype = bf16, :431): qs = bf16(f32(q) * scale), k, v, g in bf16;
// the five products take bf16 operands and accumulate in f32
// (mma.sync.m16n8k16); ds and pd are rounded to bf16 before the dq, dk and
// dv products. Tiles are read by ldmatrix (.trans for the second product's
// B operand). What bounds it on the H100: bytes, 0.0554 ms at the training
// step's shape, where the products need 0.047 ms at 989 TFLOP/s bf16.
//
// The operands' data pointers and batch and row strides must be 16-byte
// aligned (cp.async), which the wrapper checks.
//
// Head width: the kernels are templates on D, and this file is compiled
// once a width, as its own library, at D = MMFM_HEAD_DIM (32 unless
// defined; attention_bwd_d{16,64,128}.cu define it and include this file),
// as K1's. The wrapper pads any other D up to 128 with zero columns per
// head. At D = 128, the one width this pair runs, the fragments of two
// operands and the dk and dv accumulators a warp take the registers of one
// block an SM (Tc<T, D>::kBlocksA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef MMFM_HEAD_DIM
#define MMFM_HEAD_DIM 32
#endif

#include "philox.cuh"
#include "tc_traits.cuh"
#if MMFM_HEAD_DIM <= 64
#include "attention_bwd_bf16.cuh"
#include "attention_bwd_f32.cuh"
#else
#include "attention_bwd_f32_d128.cuh"
#endif

namespace {

using namespace mmfm;

// Pass A: rowsum and dq for 64 query rows of one b and heads [h0, h0 +
// hpb); and each head's mask bytes (attend and keep bits) for pass B, in
// mask_out[b][h][q][n_kt * 16].
template <typename T, bool kDropout, int D>
__global__ void __launch_bounds__(kTcThreads, Tc<T, D>::kBlocksA)
attn_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const int* __restrict__ key_pad,
                      const int* __restrict__ static_mask,
                      const float* __restrict__ lse, T* __restrict__ dq,
                      float* __restrict__ rowsum,
                      uint32_t* __restrict__ mask_out, int Tq, int Tk, int H,
                      int hpb, long long q_sb, long long q_st, long long k_sb,
                      long long k_st, long long v_sb, long long v_st,
                      long long g_sb, long long g_st, float scale,
                      const long long* __restrict__ seed_ptr,
                      unsigned threshold, float keep_scale, int b_off,
                      int h_off, bool vec) {
  using Ops = Tc<T, D>;
  // the Philox key: the low 32 bits of the step's seed-table entry
  const unsigned seed = kDropout ? (unsigned)__ldg(seed_ptr) : 0u;
  constexpr int kPer = 16 / sizeof(T);             // elements a copy
  constexpr int kBufs = Ops::kBwdBufs;             // k/v tile buffers: 2
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);              // [kBufs][kElems]
  T* vs = ks + kBufs * Ops::kElems;                // [kBufs][kElems]
  // [2][64][bstride]: this head's bytes, and the next head's being drawn
  unsigned char* bits = smem + Ops::kSmem;

  const int n_qtiles = (Tq + kTcRows - 1) / kTcRows;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTcRows;
  const int h0 = blockIdx.y * hpb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_kt = (Tk + kTcRows - 1) / kTcRows;
  const int n_t = 2 * n_kt;      // tiles a head: sweep 1, then sweep 2
  // 16 groups of 4 keys a tile, + 4 bytes so that rows 8 apart in a warp's
  // byte reads fall on distinct banks
  const int bstride = n_kt * 16 + 4;
  const int n_items = kTcRows * bstride;
  const int chunk = (n_items + n_t - 1) / n_t;

  // tile idx = (head - h0) * n_t + t of the block's walk
  auto load_tile = [&](int idx, int buf) {
    const int h = h0 + idx / n_t;
    const int k0 = (idx % n_t % n_kt) * kTcRows;
    const T* kb = k + b * k_sb + h * D;
    const T* vb = v + b * v_sb + h * D;
    for (int c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int r = c / Ops::kChunks, ch = (c % Ops::kChunks) * kPer;
      const int key = k0 + r;
      const bool ok = key < Tk;
      const long long row = ok ? key : 0;
      const int at = buf * Ops::kElems + r * Ops::kPitch + ch;
      cp_async16(smem_u32(ks + at), kb + row * k_st + ch, ok);
      cp_async16(smem_u32(vs + at), vb + row * v_st + ch, ok);
    }
    cp_async_commit();
  };
  // the chunks this thread copied into buffer buf, readied in place
  auto land_tile = [&](int buf) {
    for (int c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int at = buf * Ops::kElems + (c / Ops::kChunks) * Ops::kPitch +
                     (c % Ops::kChunks) * kPer;
      Ops::template land<false>(ks + at, 1.f);
      Ops::template land<false>(vs + at, 1.f);
    }
  };
  load_tile(0, 0);

  const int* pad = key_pad + (long long)b * Tk;
  for (int i = tid; i < kTcRows * bstride; i += kTcThreads) {
    const int r = i / bstride, k0 = (i - r * bstride) * 4;
    const unsigned att =
        attend_nibble(static_mask, pad, Tq, Tk, q0 + r, k0, vec);
    bits[i] = (unsigned char)(att ? att | keep_nibble<kDropout>(
                                              seed, threshold, b + b_off,
                                              h0 + h_off, q0 + r, k0)
                                  : 0u);
  }

  const int row0 = q0 + warp * 16;
  const bool active = row0 < Tq;  // else the warp only helps with copies
  for (int h = h0; h < h0 + hpb; ++h) {
    const int cur = kDropout ? (h - h0) & 1 : 0;
    const unsigned char* brow =
        bits + cur * n_items + (warp * 16 + gid) * bstride;
    typename Ops::Frags qa, ga;
    float lse2[2], rs[2] = {0.f, 0.f};
    float dqa[D / 8][4] = {};
    if (active) {
      Ops::template load<true>(qa, q + b * q_sb + h * D, q_st, row0, Tq,
                               lane, scale);
      Ops::template load<false>(ga, g + b * g_sb + h * D, g_st, row0, Tq,
                                lane, 1.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + gid + 8 * hh;
        lse2[hh] = row < Tq
                       ? Ops::lse_arg(lse[((long long)b * H + h) * Tq + row])
                       : 0.f;
      }
    }

    for (int t = 0; t < n_t; ++t) {
      const int idx = (h - h0) * n_t + t, buf = idx & 1;
      cp_async_wait_all();
      land_tile(buf);
      __syncthreads();  // tile idx (and the bits) in; the last readers done
      if (idx + 1 < hpb * n_t) load_tile(idx + 1, buf ^ 1);
      if (t == 0) {
        // this head's bytes, complete since the barrier, out for pass B
        const int words = n_kt * 4;        // of a row
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(bits + cur * n_items);
        for (int i = tid; i < kTcRows * words; i += kTcThreads) {
          const int r = i / words, w = i - r * words;
          if (q0 + r < Tq)
            mask_out[(((long long)b * H + h) * Tq + q0 + r) * words + w] =
                src[r * (bstride / 4) + w];
        }
      }
      if (kDropout && h + 1 < h0 + hpb) {
        // a slice of the next head's keep bits, into the other buffer (its
        // readers finished with the last head), interleaved with this
        // head's tiles so the Philox draws overlap the products
        const unsigned char* src = bits + cur * n_items;
        unsigned char* dst = bits + (cur ^ 1) * n_items;
        const int end = min(n_items, (t + 1) * chunk);
        for (int i = t * chunk + tid; i < end; i += kTcThreads) {
          const unsigned att = src[i] & 0xF0u;
          const int r = i / bstride, k0 = (i - r * bstride) * 4;
          dst[i] = (unsigned char)(att ? att | keep_nibble<kDropout>(
                                                   seed, threshold, b + b_off,
                                                   h + 1 + h_off, q0 + r, k0)
                                       : 0u);
        }
      }
      if (!active) continue;
      const bool sweep2 = t >= n_kt;
      const int k0 = (t % n_kt) * kTcRows;
      const int n_valid = min(kTcRows, Tk - k0);
      const T* kt = ks + buf * Ops::kElems;
      const T* vt = vs + buf * Ops::kElems;

      float sacc[8][4] = {}, dacc[8][4] = {};
      Ops::rows(sacc, qa, kt, lane, n_valid);
      Ops::rows(dacc, ga, vt, lane, n_valid);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= n_valid) break;
        const int key = k0 + nt * 8 + tig * 2;   // and key + 1: one group
        const int sh = key & 3;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const unsigned byte = brow[hh * 8 * bstride + (key >> 2)];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = hh * 2 + e;
            const float pn = (byte >> (4 + sh + e)) & 1u
                                 ? Ops::prob(sacc[nt][i], lse2[hh])
                                 : 0.f;
            float dpn = dacc[nt][i];
            if (kDropout)
              dpn = (byte >> (sh + e)) & 1u ? dpn * keep_scale : 0.f;
            if (!sweep2)
              rs[hh] = fmaf(dpn, pn, rs[hh]);
            else
              sacc[nt][i] = pn * (dpn - rs[hh]);   // ds
          }
        }
      }
      if (t == n_kt - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {        // the quad holds one row
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
        }
      }
      if (sweep2) Ops::cols(dqa, sacc, kt, lane, n_valid);
    }

    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + gid + 8 * hh;
      if (row >= Tq) continue;
      T* op = dq + ((long long)b * Tq + row) * H * D + h * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        Ops::store2(op + dt * 8 + tig * 2, dqa[dt][2 * hh] * scale,
                    dqa[dt][2 * hh + 1] * scale);
      if (tig == 0) rowsum[((long long)b * H + h) * Tq + row] = rs[hh];
    }
  }
}

// Pass B: dk and dv for 64 key rows of one b and heads [h0, h0 + hpb).
// The attend and keep bits come from pass A (mask_in), 16 bytes a query
// for the block's 64 keys, streamed with the query tiles: no Philox draws
// and no mask reads here.
template <typename T, bool kDropout, int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const uint32_t* __restrict__ mask_in,
                        const float* __restrict__ lse,
                        const float* __restrict__ rowsum,
                        T* __restrict__ dk, T* __restrict__ dv, int Tq,
                        int Tk, int H, int hpb, long long q_sb, long long q_st,
                        long long k_sb, long long k_st, long long v_sb,
                        long long v_st, long long g_sb, long long g_st,
                        float scale, float keep_scale) {
  using Ops = Tc<T, D>;
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kBufs = Ops::kBwdBufs;             // q/g tile buffers: 2
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);              // [kBufs][kElems]
  T* gs = qs + kBufs * Ops::kElems;                // [kBufs][kElems]
  float* lse_s = reinterpret_cast<float*>(smem + Ops::kSmem);  // [2][64]
  float* sum_s = lse_s + 2 * kTcRows;                               // [2][64]
  // [2][64][4] words: one byte per (query, 4 of the block's keys)
  uint32_t* bits = reinterpret_cast<uint32_t*>(sum_s + 2 * kTcRows);

  const int n_ktiles = (Tk + kTcRows - 1) / kTcRows;
  const int b = blockIdx.x / n_ktiles;
  const int kt = blockIdx.x % n_ktiles;
  const int key0 = kt * kTcRows;
  const int h0 = blockIdx.y * hpb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_qt = (Tq + kTcRows - 1) / kTcRows;
  const int words = n_ktiles * 4;  // of a mask_in row

  // tile idx = (head - h0) * n_qt + t of the block's walk
  auto load_tile = [&](int idx, int buf) {
    const int h = h0 + idx / n_qt;
    const int q0 = (idx % n_qt) * kTcRows;
    const T* qb = q + b * q_sb + h * D;
    const T* gb = g + b * g_sb + h * D;
    for (int c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int r = c / Ops::kChunks, ch = (c % Ops::kChunks) * kPer;
      const int qrow = q0 + r;
      const bool ok = qrow < Tq;
      const long long row = ok ? qrow : 0;
      const int at = buf * Ops::kElems + r * Ops::kPitch + ch;
      cp_async16(smem_u32(qs + at), qb + row * q_st + ch, ok);
      cp_async16(smem_u32(gs + at), gb + row * g_st + ch, ok);
    }
    const int r = tid & (kTcRows - 1);
    const bool ok = q0 + r < Tq;
    const long long row = ((long long)b * H + h) * Tq + (ok ? q0 + r : 0);
    if (tid < kTcRows) {
      cp_async4(smem_u32(lse_s + buf * kTcRows + r), lse + row, ok);
      cp_async16(smem_u32(bits + (buf * kTcRows + r) * 4),
                 mask_in + row * words + kt * 4, ok);
    } else {
      cp_async4(smem_u32(sum_s + buf * kTcRows + r), rowsum + row, ok);
    }
    cp_async_commit();
  };
  // the chunks this thread copied into buffer buf, readied in place:
  // q * scale, and g
  auto land_tile = [&](int buf) {
    for (int c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int at = buf * Ops::kElems + (c / Ops::kChunks) * Ops::kPitch +
                     (c % Ops::kChunks) * kPer;
      Ops::template land<true>(qs + at, scale);
      Ops::template land<false>(gs + at, 1.f);
    }
  };
  load_tile(0, 0);

  const int kr0 = key0 + warp * 16;
  const bool active = kr0 < Tk;   // else the warp only helps with copies
  // the bit of keys gid, gid + 8 in this warp's 4 bytes of a query's 16
  const int sh0 = 8 * (gid >> 2) + (gid & 3);
  for (int h = h0; h < h0 + hpb; ++h) {
    typename Ops::Frags ka, va;
    float dka[D / 8][4] = {}, dva[D / 8][4] = {};
    if (active) {
      Ops::template load<false>(ka, k + b * k_sb + h * D, k_st, kr0, Tk,
                                lane, 1.f);
      Ops::template load<false>(va, v + b * v_sb + h * D, v_st, kr0, Tk,
                                lane, 1.f);
    }

    for (int t = 0; t < n_qt; ++t) {
      const int idx = (h - h0) * n_qt + t, buf = idx & 1;
      cp_async_wait_all();
      land_tile(buf);
      __syncthreads();  // tile idx in and readied; the last readers done
      if (idx + 1 < hpb * n_qt) load_tile(idx + 1, buf ^ 1);
      if (!active) continue;
      const T* qt = qs + buf * Ops::kElems;
      const T* gt = gs + buf * Ops::kElems;
      const uint32_t* bw = bits + buf * kTcRows * 4 + warp;
      const int n_valid = min(kTcRows, Tq - t * kTcRows);

      // s^T and (g . v)^T: rows the warp's 16 keys, columns the 64 queries
      float sacc[8][4] = {}, dacc[8][4] = {};
      Ops::rows(sacc, ka, qt, lane, n_valid);
      Ops::rows(dacc, va, gt, lane, n_valid);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt * 8 >= n_valid) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = nt * 8 + tig * 2 + e;
          const uint32_t word = bw[ql * 4];
          const float lse2 = Ops::lse_arg(lse_s[buf * kTcRows + ql]);
          const float rsum = sum_s[buf * kTcRows + ql];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = hh * 2 + e;
            const int sh = sh0 + 16 * hh;
            const float pn = (word >> (sh + 4)) & 1u
                                 ? Ops::prob(sacc[nt][i], lse2)
                                 : 0.f;
            float ms = 1.f;
            if (kDropout) ms = (word >> sh) & 1u ? keep_scale : 0.f;
            sacc[nt][i] = pn * ms;                              // pd
            dacc[nt][i] = pn * (dacc[nt][i] * ms - rsum);       // ds
          }
        }
      }
      Ops::cols(dva, sacc, gt, lane, n_valid);
      Ops::cols(dka, dacc, qt, lane, n_valid);
    }

    if (!active) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kr0 + gid + 8 * hh;
      if (key >= Tk) continue;
      const long long o = ((long long)b * Tk + key) * H * D + h * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int d = dt * 8 + tig * 2;
        Ops::store2(dk + o + d, dka[dt][2 * hh], dka[dt][2 * hh + 1]);
        Ops::store2(dv + o + d, dva[dt][2 * hh], dva[dt][2 * hh + 1]);
      }
    }
  }
}

template <typename T, bool kDropout, int D>
cudaError_t launch_tc(const void* q_, const void* k_, const void* v_,
                      const void* g_, const int* key_pad,
                      const int* static_mask, const float* lse, float* rowsum,
                      void* dq_, void* dk_, void* dv_, int B, int Tq, int Tk,
                      int H, long long q_sb, long long q_st, long long k_sb,
                      long long k_st, long long v_sb, long long v_st,
                      long long g_sb, long long g_st, float scale,
                      const long long* seed, unsigned threshold,
                      float keep_scale, int b_off, int h_off,
                      cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* g = static_cast<const T*>(g_);
  const int n_qt = (Tq + kTcRows - 1) / kTcRows;
  const int n_kt = (Tk + kTcRows - 1) / kTcRows;
  const size_t n_buf = kDropout ? 2 : 1;   // pass A's bit buffers
  const size_t smem_a =
      Tc<T, D>::kSmem + n_buf * kTcRows * (n_kt * 16 + 4);
  const size_t smem_b = Tc<T, D>::kSmem + 4 * kTcRows * sizeof(float) +
                        2 * kTcRows * 16;
  // pass A's mask bytes for pass B, (B, H, Tq, n_kt * 16), after rowsum in
  // the scratch, 16-byte aligned
  const uintptr_t tail =
      reinterpret_cast<uintptr_t>(rowsum + (size_t)B * H * Tq);
  uint32_t* mask = reinterpret_cast<uint32_t*>((tail + 15) & ~uintptr_t(15));
  cudaError_t err =
      allow_smem(attn_bwd_dq_tc_kernel<T, kDropout, D>, smem_a);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkdv_tc_kernel<T, kDropout, D>, smem_b);
  if (err != cudaSuccess) return err;
  const bool vec = Tk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(key_pad) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(static_mask) % 16 == 0;
  const int hpb_a = heads_per_block(B, n_qt, H);
  const dim3 grid_a((unsigned)B * n_qt, H / hpb_a);
  attn_bwd_dq_tc_kernel<T, kDropout, D>
      <<<grid_a, kTcThreads, smem_a, stream>>>(
      q, k, v, g, key_pad, static_mask, lse, static_cast<T*>(dq_), rowsum,
      mask, Tq, Tk, H, hpb_a, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st,
      scale, seed, threshold, keep_scale, b_off, h_off, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hpb_b = heads_per_block(B, n_kt, H);
  const dim3 grid_b((unsigned)B * n_kt, H / hpb_b);
  attn_bwd_dkdv_tc_kernel<T, kDropout, D>
      <<<grid_b, kTcThreads, smem_b, stream>>>(
          q, k, v, g, mask, lse, rowsum, static_cast<T*>(dk_),
          static_cast<T*>(dv_), Tq, Tk, H, hpb_b, q_sb, q_st, k_sb, k_st,
          v_sb, v_st, g_sb, g_st, scale, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (3xTF32), 1 = bfloat16, for q, k, v, g, dq, dk, dv;
// D must be this library's MMFM_HEAD_DIM; data pointers and batch and row
// strides of q, k, v, g
// 16-byte aligned. Strides in elements; dq (B, Tq, H*D), dk and dv
// (B, Tk, H*D) contiguous. The f32 scratch holds rowsum (B, H, Tq), written
// by pass A and read by pass B, then, 16-byte aligned, the mask bytes the
// passes read: the mma.sync pair's (bf16 at 128) B * H * Tq * ceil(Tk /
// 64) * 16 bytes, the wgmma kernels' B * H * ceil(Tk / 8) * keep_row(Tq)
// (ops/attention.py::_k2_scratch_floats, by k2_route). b_off and h_off
// offset the (b, h) of the dropout bits as K1's do.
// Returns the first launch error (0 = ok).
extern "C" int mmfm_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const int* key_pad, const int* static_mask, const float* lse,
    float* rowsum, void* dq, void* dk, void* dv, int B, int Tq, int Tk,
    int H, int D, long long q_sb, long long q_st, long long k_sb,
    long long k_st, long long v_sb, long long v_st, long long g_sb,
    long long g_st, float scale, const long long* seed, unsigned threshold,
    float keep_scale, int dropout, int b_off, int h_off, int dtype,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != MMFM_HEAD_DIM) return (int)cudaErrorInvalidValue;
#define MMFM_K2_LAUNCH(T, DROP)                                              \
  launch_tc<T, DROP, MMFM_HEAD_DIM>(                                         \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
#define MMFM_K2_WG(DROP)                                                     \
  mmfm::k2wg::launch<DROP, MMFM_HEAD_DIM>(                                   \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
#define MMFM_K2_TF(DROP)                                                     \
  mmfm::k2tf::launch<DROP, MMFM_HEAD_DIM>(                                   \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
#define MMFM_K2_T128(DROP)                                                   \
  mmfm::k2t128::launch<DROP>(                                                \
      q, k, v, g, key_pad, static_mask, lse, rowsum, dq, dk, dv, B, Tq, Tk,  \
      H, q_sb, q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, seed,        \
      threshold, keep_scale, b_off, h_off, s)
  cudaError_t err = cudaErrorInvalidValue;
#if MMFM_HEAD_DIM <= 64
  if (dtype == 0)
    err = dropout ? MMFM_K2_TF(true) : MMFM_K2_TF(false);
  else if (dtype == 1)
    err = dropout ? MMFM_K2_WG(true) : MMFM_K2_WG(false);
#else
  if (dtype == 0)
    err = dropout ? MMFM_K2_T128(true) : MMFM_K2_T128(false);
  else if (dtype == 1)
    err = dropout ? MMFM_K2_LAUNCH(bf16, true) : MMFM_K2_LAUNCH(bf16, false);
#endif
#undef MMFM_K2_T128
#undef MMFM_K2_TF
#undef MMFM_K2_WG
#undef MMFM_K2_LAUNCH
  return (int)err;
}
