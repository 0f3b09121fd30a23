#!/usr/bin/env python3
"""Design variants of the wgmma K2, bf16 or f32, timed beside the committed
kernel on one NVIDIA GPU.

    python3 scripts/torch_k2_variants.py [--dtype float32] [--head-dim 128] [--parent OTHER_CHECKOUT]

Builds the committed ``csrc/attention_bwd.cu`` (head width 32) and
variants of its bf16 kernel (string edits of
``csrc/attention_bwd_bf16.cuh``) or, with ``--dtype float32``, of its f32
kernel (edits of ``csrc/attention_bwd_f32.cuh`` and ``wgmma_tf32.cuh``),
or, with ``--head-dim 128``, ``csrc/attention_bwd_d128.cu`` and variants
of its bf16 kernel (edits of ``csrc/attention_bwd_bf16_d128.cuh``) or,
with ``--dtype float32 --head-dim 128``, of its f32 kernel (edits of
``csrc/attention_bwd_f32_d128.cuh``), into ``build/probe/k2_<name>/``,
each edit checked to apply exactly once, and, with ``--parent``, another
checkout's K2 of that width (say the parent commit's, unpacked by ``git
archive``: the mma.sync pair of bf16 at 128 before its redesign). Each
library in turn is swapped in for ``ops.attention._k2_lib`` (the parent's
with a scratch that holds either layout, ``parent_scratch_floats``),
checked with ``chip_smoke.k2_gates`` at the smoke
run's B = 256 training shape (the encoder mask, dropout 0 and 0.4; at
head width 128 two heads), and timed kernel by kernel by profiler device
time (``chip_smoke.device_ms_by_kernel``: the keep draws and each pass
apart) at B = 256 and B = 16, dropout 0.4 and 0, in the order of the list
and then reversed. Prints JSON lines: the card, each build's ``ptxas``
registers and spills per kernel and its SASS counts (``HGMMA``, ``HMMA``,
``UTMALDG`` TMA loads, ``STL`` / ``LDL`` local memory) per kernel, each
check, each timing.

The variants (``diag_*`` compute wrong results on purpose and are only
timed: what is left when a piece is taken out):

- ``base``: the committed kernel.
- ``diag_no_elementwise``: s and dP go into ds and pd as they are (no
  exp, masks, dropout or row sums).
- ``diag_exp_free``: the exponent's argument in place of its exp (the
  special-function unit left out).
- ``diag_no_score_products``: the s and dP wgmmas not issued.
- ``diag_no_output_products``: the dq, dk and dv wgmmas not issued.
- ``products_per_k_step``: each pass's output products (dq; dk and dv)
  issued a k-step at a time, each as soon as its 16 columns are worked
  and packed (so that they run beside the next columns' exp and masks),
  not after all 104.
- ``keep_below_tk``: the keep kernel draws a key group only below Tk
  (a branch a call).
- ``keep_wide_multiply``: the keep draws with each 32 x 32 -> 64-bit
  Philox product one wide multiply (``keep_bits8``) in place of
  ``philox.cuh``'s high and low words from two.
- ``heads_per_block_rule``: the mma.sync kernels' heads a block (a
  thousand blocks or more) in place of ``walk_heads``.

The f32 variants (``--dtype float32``):

- ``base``, ``diag_no_elementwise``, ``diag_no_output_products``: as
  above, on the f32 kernel.
- ``diag_no_score_products``: no s and dP wgmmas (``mma3_ss`` empty).
- ``diag_no_split``: the landed tiles not split into their hi, lo and
  transposed planes (the products read what is there).
- ``keep_in_kernel``: no keep kernel; each pass draws its threads' keep
  bits (``keep_bits4``, a Philox call per row and 4 keys; pass B's two
  queries apart) while its s and dP products run, as the mma.sync pass A
  drew them.
- ``pipelined_outputs``: the output products' k-steps alternate two
  from-zero temporaries, so a k-step's wgmmas run while the last one's sum
  is added (``wait_group 1``), in place of one temporary waited for at
  every k-step; the same sums in the same order.

The head-width-128 bf16 variants (``--head-dim 128``):

- ``base``, ``diag_no_elementwise``: as above, on the D = 128 kernel.
- ``diag_no_score_products``: no s and dP wgmmas.
- ``diag_no_output_products``: no dq, dk and dv wgmmas.
- ``diag_no_q_scale``: q not scaled in place (nor the barrier after it).
- ``issue_at_tile_end``: the next tile's copies issued in one part after
  the output products, in place of two parts as buffers free up.
- ``diag_no_attend``: every element attended, no mask read.
- ``diag_exp_free``: the exponent's argument in place of its exp.
- ``attend_guarded``: the attend bits' loads guarded by the bounds (the
  D <= 64 kernels' form), in place of all issued with their indices
  clamped into the masks.

One block an SM is the only shape the f32 kernel has: a pass A block at
D = 32 takes 207 KB of shared memory and 255 registers a thread.

The head-width-128 f32 variants (``--dtype float32 --head-dim 128``):

- ``base``, ``diag_no_split``, ``diag_no_elementwise``: as above, on the
  D = 128 kernel.
- ``diag_no_score_products``: no s and dP wgmmas (the ``mma3_rs`` calls of
  s, dP and their temporaries not issued).
- ``diag_no_output_products``: no dq, dk and dv wgmmas.
- ``terms_in_sequence``: each group's two k-steps (s and dP's, dq's two,
  dk and dv's) issued one after the other (three terms of one, then the
  other's) in place of alternating their terms (``mma3_rs2``); the same
  sums.
- ``descriptors_from_base``: each k-step's shared-memory descriptor as the
  plane's descriptor plus the k-step's offset (``wg::desc_add``), in place
  of encoding each address anew.
- ``score_loop_rolled``: the loop over s's and dP's k-step pairs not
  unrolled (fewer registers for addresses).
- ``pass_a_chunk_48``: pass A in chunks of 48 keys (24 a warpgroup) in
  place of 64.
- ``pass_b_chunk_32``: pass B in chunks of 32 queries (16 a warpgroup) in
  place of 48.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the smoke run's inputs, gates, timers)
from multi_modal_foundation_model_tpu_torch.ops import attention as att  # noqa: E402
from multi_modal_foundation_model_tpu_torch.ops import build  # noqa: E402

SRC = "attention_bwd_bf16.cuh"
# the keep draws of a byte (philox.cuh keep_word, which the keep kernel
# calls), and a function spliced in before it
KEEP_SRC = "philox.cuh"
KEEP_CALL = (
    "    const uint32_t lo = keep_bits4(seed, threshold, b, h, q, 2 * kb);\n"
    "    const uint32_t hi = keep_bits4(seed, threshold, b, h, q, 2 * kb + 1);"
    "\n    word |= (lo | hi << 4) << (8 * u);")
KEEP_ANCHOR = "// The keep bytes of queries [4 qw, 4 qw + 4)"
KEEP_WORD_CALL = ("  mask[i] = keep_word(seed, threshold, b + b_off, h + h_off, "
                  "qw, kb, Tq);")
KEEP_BITS8 = """\
// The keep bits of keys [8 kb, 8 kb + 8) of row (b, h, q): the two Philox
// calls of philox.cuh's keep_bits4 (counters (2 kb, q, h, b) and (2 kb + 1,
// q, h, b)) side by side, each 32 x 32 -> 64-bit product one wide multiply
// (philox4x32_10 takes its high and low words from two); bit i is key
// 8 kb + i, the same bits as two keep_bits4 calls.
__device__ __forceinline__ uint32_t keep_bits8(uint32_t seed,
                                               uint32_t threshold, int b,
                                               int h, int q, int kb) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t x[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    x[u][0] = (uint32_t)(2 * kb + u);
    x[u][1] = (uint32_t)q;
    x[u][2] = (uint32_t)h;
    x[u][3] = (uint32_t)b;
  }
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint64_t p0 = (uint64_t)kM0 * x[u][0];
      const uint64_t p1 = (uint64_t)kM1 * x[u][2];
      const uint32_t n0 = (uint32_t)(p1 >> 32) ^ x[u][1] ^ k0;
      const uint32_t n2 = (uint32_t)(p0 >> 32) ^ x[u][3] ^ k1;
      x[u][0] = n0;
      x[u][1] = (uint32_t)p1;
      x[u][2] = n2;
      x[u][3] = (uint32_t)p0;
    }
    k0 += kW0;
    k1 += kW1;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bits |= (uint32_t)(x[u][i] > threshold) << (4 * u + i);
  return bits;
}

"""
# the output products issued after all columns are packed (serial, the
# committed kernel) and a k-step at a time, each as soon as packed
# (pipelined, with its helpers spliced in before the pass body)
SERIAL_A = """\
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
"""
PIPELINED_A = """\
        // ds = pn (dpn - rowsum), rounded to bf16; dq += ds . k, each
        // k-step's product issued as soon as its 16 columns are packed
        for_steps<kSteps>([&](auto step) {
          constexpr int kk = decltype(step)::value;
#pragma unroll
          for (int i = 8 * kk; i < 8 * kk + 8 && i < kAcc; ++i)
            s[i] *= p[i] - rsum[(i >> 1) & 1];
          to_frag<kk>(f1[kk], s);
          wg::fence();
          wg::mma_rs(o1, f1[kk],
                     wg::desc_add(wg::desc<kRB>(b1), kk * 16 * kRB),
                     ch > 0 || kk > 0);
        });
"""
SERIAL_B = """\
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
"""
PIPELINED_B = """\
      // pd = pn ms and ds = pn (dP ms - rowsum), the columns' lse and
      // rowsum from shared memory, 16 columns (a k-step) at a time; each
      // k-step's dk += ds . qs and dv += pd . g products are issued as soon
      // as its fragments are packed, and run while the next columns' exp
      // and masks are worked
      const float* sb = stat + (t & 1) * 2 * kChunk + wgi * kCols;
      uint32_t f2[kSteps][4];
      for_steps<kSteps>([&](auto step) {
        constexpr int kk = decltype(step)::value;
        if (live) {
#pragma unroll
          for (int j = 2 * kk; j < 2 * kk + 2 && j < kBits / 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * c + e;
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
        to_frag<kk>(f1[kk], p);   // ds
        to_frag<kk>(f2[kk], s);   // pd
        wg::fence();
        const int acc = ch > 0 || kk > 0;
        wg::mma_rs(o1, f1[kk], wg::desc_add(wg::desc<kRB>(b1), kk * 16 * kRB),
                   acc);
        wg::mma_rs(o2, f2[kk], wg::desc_add(wg::desc<kRB>(b2), kk * 16 * kRB),
                   acc);
      });
"""
STEP_HELPERS = """\
// The A fragment of k-step kk (columns [16 kk, 16 kk + 16)) of the bf16
// rounding of a 64 x 104 f32 accumulator x: element (row hh, n8 block j,
// column e) is x[4 j + 2 hh + e]; the columns past 104 are zero.
template <int kk>
__device__ __forceinline__ void to_frag(uint32_t (&f)[4],
                                        const float (&x)[kAcc]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 2 * kk + (r >> 1), i = 4 * j + 2 * (r & 1);
    f[r] = j < kCols / 8 ? pack_bf16(x[i], x[i + 1]) : 0u;
  }
}

// Calls f(Step<k>{}) for k = 0 .. N - 1, in order: a loop body that takes
// its k-step as a constant (a template argument, a register index).
template <int K>
struct Step {
  static constexpr int value = K;
};
template <int N, int K = 0, typename F>
__device__ __forceinline__ void for_steps(F&& f) {
  if constexpr (K < N) {
    f(Step<K>{});
    for_steps<N, K + 1>(f);
  }
}

"""
BODY_ANCHOR = "// Pass A (kPassB false): rows are queries"
VARIANTS = {
    "base": {},
    "diag_no_elementwise": {SRC: [
        ("      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (live) {",
         "      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (false) {"),
        ("      // rowsum from shared memory\n      if (live) {",
         "      // rowsum from shared memory\n      if (false) {")]},
    "diag_exp_free": {SRC: [
        ("? fast_exp2(fmaf(s[i], kLog2e, -lse2[hh]))",
         "? (fmaf(s[i], kLog2e, -lse2[hh]))"),
        ("? fast_exp2(fmaf(s[i], kLog2e, -l2))",
         "? (fmaf(s[i], kLog2e, -l2))")]},
    "diag_no_score_products": {SRC: [
        ("    for (int kk = 0; kk < D / 16; ++kk)\n"
         "      wg::mma_ss_n104(s,",
         "    for (int kk = 0; kk < D / 16 && false; ++kk)\n"
         "      wg::mma_ss_n104(s,"),
        ("    for (int kk = 0; kk < D / 16; ++kk)\n"
         "      wg::mma_ss_n104(p,",
         "    for (int kk = 0; kk < D / 16 && false; ++kk)\n"
         "      wg::mma_ss_n104(p,")]},
    "diag_no_output_products": {SRC: [
        ("        for (int kk = 0; kk < kSteps; ++kk)\n"
         "          wg::mma_rs(o1,",
         "        for (int kk = 0; kk < kSteps && false; ++kk)\n"
         "          wg::mma_rs(o1,"),
        ("      for (int kk = 0; kk < kSteps; ++kk) {\n"
         "        wg::mma_rs(o1,",
         "      for (int kk = 0; kk < kSteps && false; ++kk) {\n"
         "        wg::mma_rs(o1,")]},
    "products_per_k_step": {SRC: [(BODY_ANCHOR, STEP_HELPERS + BODY_ANCHOR),
                                   (SERIAL_A, PIPELINED_A),
                                   (SERIAL_B, PIPELINED_B)]},
    "keep_below_tk": {
        KEEP_SRC: [
            ("int h, int qw, int kb, int Tq) {",
             "int h, int qw, int kb, int Tq,\n"
             "                                              int Tk) {"),
            (KEEP_CALL,
             "    uint32_t lo = 0u, hi = 0u;\n"
             "    if (8 * kb < Tk)\n"
             "      lo = keep_bits4(seed, threshold, b, h, q, 2 * kb);\n"
             "    if (8 * kb + 4 < Tk)\n"
             "      hi = keep_bits4(seed, threshold, b, h, q, 2 * kb + 1);\n"
             "    word |= (lo | hi << 4) << (8 * u);")],
        SRC: [(KEEP_WORD_CALL, KEEP_WORD_CALL.replace("Tq);", "Tq, Tk);"))]},
    "keep_wide_multiply": {KEEP_SRC: [
        (KEEP_ANCHOR, KEEP_BITS8 + KEEP_ANCHOR),
        (KEEP_CALL,
         "    word |= keep_bits8(seed, threshold, b, h, q, kb) << (8 * u);")]},
    "heads_per_block_rule": {SRC: [
        ("  args.hpb = walk_heads(B, n_qt, H);",
         "  args.hpb = heads_per_block(B, n_qt, H);"),
        ("  args.hpb = walk_heads(B, n_kt, H);",
         "  args.hpb = heads_per_block(B, n_kt, H);")]},
}
F32_SRC = "attention_bwd_f32.cuh"
F32_SERIAL_A = """\
#pragma unroll
        for (int kk = 0; kk < kN8; ++kk) {
          uint32_t fh[4], fl[4];
          wgtf::to_frags_tf32(s, kk, fh, fl);
          float o[D / 2];
          wg::fence();
          wgtf::mma3_rs(o, fh, fl, tr(t1, wgi * kN8 + kk),
                        tr(t1 + L::kT, wgi * kN8 + kk));
          wg::commit();
          wg::wait<0>();
          wg::hold(o);
          wgtf::hold(fh);
          wgtf::hold(fl);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o1[i] += o[i];
        }
"""
F32_PIPELINED_A = """\
        float o[2][D / 2];
        uint32_t fh[2][4], fl[2][4];
#pragma unroll
        for (int kk = 0; kk < kN8; ++kk) {
          const int u = kk & 1;
          wgtf::to_frags_tf32(s, kk, fh[u], fl[u]);
          wg::fence();
          wgtf::mma3_rs(o[u], fh[u], fl[u], tr(t1, wgi * kN8 + kk),
                        tr(t1 + L::kT, wgi * kN8 + kk));
          wg::commit();
          if (kk > 0) {
            wg::wait<1>();
            wg::hold(o[u ^ 1]);
            wgtf::hold(fh[u ^ 1]);
            wgtf::hold(fl[u ^ 1]);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) o1[i] += o[u ^ 1][i];
          }
        }
        wg::wait<0>();
        wg::hold(o[(kN8 - 1) & 1]);
        wgtf::hold(fh[(kN8 - 1) & 1]);
        wgtf::hold(fl[(kN8 - 1) & 1]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o1[i] += o[(kN8 - 1) & 1][i];
"""
F32_SERIAL_B = """\
#pragma unroll
      for (int kk = 0; kk < kN8; ++kk) {
        uint32_t dh[4], dl[4], ph[4], pl[4];
        wgtf::to_frags_tf32(p, kk, dh, dl);
        wgtf::to_frags_tf32(s, kk, ph, pl);
        const int ks = wgi * kN8 + kk;
        float ok[D / 2], ov[D / 2];
        wg::fence();
        wgtf::mma3_rs(ok, dh, dl, tr(t1, ks), tr(t1 + L::kT, ks));
        wgtf::mma3_rs(ov, ph, pl, tr(t2, ks), tr(t2 + L::kT, ks));
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
"""
F32_PIPELINED_B = """\
      float ok[2][D / 2], ov[2][D / 2];
      uint32_t dh[2][4], dl[2][4], ph[2][4], pl[2][4];
#pragma unroll
      for (int kk = 0; kk < kN8; ++kk) {
        const int u = kk & 1;
        wgtf::to_frags_tf32(p, kk, dh[u], dl[u]);
        wgtf::to_frags_tf32(s, kk, ph[u], pl[u]);
        const int ks = wgi * kN8 + kk;
        wg::fence();
        wgtf::mma3_rs(ok[u], dh[u], dl[u], tr(t1, ks), tr(t1 + L::kT, ks));
        wgtf::mma3_rs(ov[u], ph[u], pl[u], tr(t2, ks), tr(t2 + L::kT, ks));
        wg::commit();
        if (kk > 0) {
          const int w1 = u ^ 1;
          wg::wait<1>();
          wg::hold(ok[w1]);
          wg::hold(ov[w1]);
          wgtf::hold(dh[w1]);
          wgtf::hold(dl[w1]);
          wgtf::hold(ph[w1]);
          wgtf::hold(pl[w1]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) {
            o1[i] += ok[w1][i];
            o2[i] += ov[w1][i];
          }
        }
      }
      {
        const int w1 = (kN8 - 1) & 1;
        wg::wait<0>();
        wg::hold(ok[w1]);
        wg::hold(ov[w1]);
        wgtf::hold(dh[w1]);
        wgtf::hold(dl[w1]);
        wgtf::hold(ph[w1]);
        wgtf::hold(pl[w1]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          o1[i] += ok[w1][i];
          o2[i] += ov[w1][i];
        }
      }
"""
F32_KEEP_DRAWS = """\
    if (kDropout) {
      // the keep bits drawn here, a Philox call a row and 4 keys
      const unsigned seed = (unsigned)__ldg(a.seed);
      keep[0] = keep[1] = 0u;
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = ch * kChunk + wgi * kCols + 8 * j + 2 * c;
          const int row = row0 + 8 * hh;
          if (!kPassB) {
            const uint32_t bits = keep_bits4(seed, a.threshold, b + a.b_off,
                                             h + a.h_off, row, col >> 2);
            keep[hh] |= (bits >> (col & 3) & 3u) << (2 * j);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t bits =
                  keep_bits4(seed, a.threshold, b + a.b_off, h + a.h_off,
                             col + e, row >> 2);
              keep[hh] |= (bits >> (row & 3) & 1u) << (2 * j + e);
            }
          }
        }
    }
"""
F32_VARIANTS = {
    "base": {},
    "diag_no_elementwise": {F32_SRC: [
        ("      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (live) {",
         "      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (false) {"),
        ("      // rowsum from shared memory\n      if (live) {",
         "      // rowsum from shared memory\n      if (false) {")]},
    "diag_no_output_products": {F32_SRC: [
        (F32_SERIAL_A, F32_SERIAL_A.replace("kk < kN8;", "kk < kN8 && false;")),
        (F32_SERIAL_B, F32_SERIAL_B.replace("kk < kN8;", "kk < kN8 && false;"))]},
    "diag_no_score_products": {"wgmma_tf32.cuh": [
        ("  mma_ss(d, al, bh, 0);\n  mma_ss(d, ah, bl, 1);\n"
         "  mma_ss(d, ah, bh, 1);\n", "")]},
    "diag_no_split": {F32_SRC: [
        ("    for (int i0 = tid; i0 < kN; i0 += kU * kThreads) {",
         "    for (int i0 = tid; i0 < kN && false; i0 += kU * kThreads) {")]},
    "keep_in_kernel": {F32_SRC: [
        ("  float scale, keep_scale;\n};",
         "  float scale, keep_scale;\n  const long long* seed;\n"
         "  unsigned threshold;\n  int b_off, h_off;\n};"),
        ("            scale,       keep_scale};",
         "            scale, keep_scale, seed, threshold, b_off, h_off};"),
        ("  if (kDropout) {\n    const long long n =",
         "  if (false) {\n    const long long n ="),
        ("                             (kDropout ? L::kKeepBytes : 0));\n"
         "    if (kDropout)\n",
         "                             0);\n    if (false)\n"),
        ("    if (kDropout) load_keep(sm + L::kKeep, keep);\n",
         F32_KEEP_DRAWS)]},
    "pipelined_outputs": {F32_SRC: [(F32_SERIAL_A, F32_PIPELINED_A),
                                    (F32_SERIAL_B, F32_PIPELINED_B)]},
}
F128_SRC = "attention_bwd_f32_d128.cuh"
F128_COLS = "  static constexpr int kCols = kPassB ? 24 : 32;"
F128_VARIANTS = {
    "base": {},
    "diag_no_split": {F128_SRC: [
        ("    for (int i0 = tid; i0 < kN; i0 += kU * kThreads) {",
         "    for (int i0 = tid; i0 < kN && false; i0 += kU * kThreads) {")]},
    "diag_no_elementwise": {F128_SRC: [
        ("      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (live) {",
         "      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (false) {"),
        ("      // rowsum from shared memory\n      if (live) {",
         "      // rowsum from shared memory\n      if (false) {")]},
    "diag_no_score_products": {F128_SRC: [
        ("      wgtf::mma3_rs2(acc, ", "      if (false) wgtf::mma3_rs2(acc, "),
        ("        wgtf::mma3_rs2(tmp[0], ",
         "        if (false) wgtf::mma3_rs2(tmp[0], ")]},
    "diag_no_output_products": {F128_SRC: [
        ("            wgtf::mma3_rs2(to[0], ",
         "            if (false) wgtf::mma3_rs2(to[0], "),
        ("            wgtf::mma3_rs(to[0], ",
         "            if (false) wgtf::mma3_rs(to[0], "),
        ("          wgtf::mma3_rs2(tk, ", "          if (false) wgtf::mma3_rs2(tk, ")]},
    "terms_in_sequence": {"wgmma_tf32.cuh": [
        ("  mma_rs(d, al, bh, 0);\n  mma_rs(e, cl, fh, 0);\n"
         "  mma_rs(d, ah, bl, 1);\n  mma_rs(e, ch, fl, 1);\n"
         "  mma_rs(d, ah, bh, 1);\n  mma_rs(e, ch, fh, 1);\n",
         "  mma_rs(d, al, bh, 0);\n  mma_rs(d, ah, bl, 1);\n"
         "  mma_rs(d, ah, bh, 1);\n  mma_rs(e, cl, fh, 0);\n"
         "  mma_rs(e, ch, fl, 1);\n  mma_rs(e, ch, fh, 1);\n")]},
    "descriptors_from_base": {F128_SRC: [
        ("    return wg::desc<128>(plane + (kk >> 2) * L::kBlkB + 32 * (kk & 3));",
         "    return wg::desc_add(wg::desc<128>(plane),\n"
         "                        (kk >> 2) * L::kBlkB + 32 * (kk & 3));"),
        ("    return wg::desc<128>(plane + (ks >> 2) * L::kBlkP + 32 * (ks & 3));",
         "    return wg::desc_add(wg::desc<128>(plane),\n"
         "                        (ks >> 2) * L::kBlkP + 32 * (ks & 3));")]},
    "score_loop_rolled": {F128_SRC: [
        ("#pragma unroll\n      for (int kk = 2; kk < kD / 8; kk += 2) {",
         "#pragma unroll 1\n      for (int kk = 2; kk < kD / 8; kk += 2) {")]},
    "pass_a_chunk_48": {F128_SRC: [
        (F128_COLS, F128_COLS.replace("24 : 32", "24 : 24"))]},
    "pass_b_chunk_32": {F128_SRC: [
        (F128_COLS, F128_COLS.replace("24 : 32", "16 : 32"))]},
}
SHAPES = ((cs.BIG_B, (cs.DROPOUT, 0.0)), (cs.TRAIN_B, (cs.DROPOUT, 0.0)))


B128_SRC = "attention_bwd_bf16_d128.cuh"
B128_VARIANTS = {
    "base": {},
    "diag_no_elementwise": {B128_SRC: [
        ("      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (live) {",
         "      // pn = exp(s - lse) where attended, dpn = dP ms\n"
         "      if (false) {"),
        ("      // rowsum from shared memory\n      if (live) {",
         "      // rowsum from shared memory\n      if (false) {")]},
    "diag_no_score_products": {B128_SRC: [
        ("    for (int kk = 0; kk < kD / 16; ++kk)\n"
         "      wg::mma_ss_n104(\n          s,",
         "    for (int kk = 0; kk < kD / 16 && false; ++kk)\n"
         "      wg::mma_ss_n104(\n          s,"),
        ("    for (int kk = 0; kk < kD / 16; ++kk)\n"
         "      wg::mma_ss_n104(\n          p,",
         "    for (int kk = 0; kk < kD / 16 && false; ++kk)\n"
         "      wg::mma_ss_n104(\n          p,")]},
    "diag_no_output_products": {B128_SRC: [
        ("        for (int kk = 0; kk < kSteps; ++kk) {",
         "        for (int kk = 0; kk < kSteps && false; ++kk) {"),
        ("        if (ks >= n_ks) break;",
         "        if (ks >= n_ks || true) break;")]},
    "diag_no_q_scale": {B128_SRC: [
        ("    if (kPassB || r == 0) {", "    if (false) {")]},
    "diag_no_attend": {B128_SRC: [
        ("  if (n_ch == 1) attend(0, att);",
         "  if (n_ch == 1) att[0] = att[1] = ~0u;")]},
    "diag_exp_free": {B128_SRC: [
        ("? fast_exp2(fmaf(s[i], kLog2e, -lse2[hh]))",
         "? (fmaf(s[i], kLog2e, -lse2[hh]))"),
        ("? fast_exp2(fmaf(s[i], kLog2e, -l2))",
         "? (fmaf(s[i], kLog2e, -l2))")]},
    "attend_guarded": {B128_SRC: [
        ("""          const int qc = min(q, a.Tq - 1), kc = min(k, a.Tk - 1);
          const int on = __ldg(a.static_mask + (long long)qc * a.Tk + kc) |
                         __ldg(a.key_pad + (long long)b * a.Tk + kc);
          if (q < a.Tq && k < a.Tk && on != 0) m[hh] |= 1u << (2 * j + e);""",
         """          if (q < a.Tq && k < a.Tk &&
              (__ldg(a.static_mask + (long long)q * a.Tk + k) |
               __ldg(a.key_pad + (long long)b * a.Tk + k)) != 0)
            m[hh] |= 1u << (2 * j + e);""")]},
    "issue_at_tile_end": {B128_SRC: [
        ("      if (tid == 0 && more) issue(t + 1, fin ? 1 : 3);",
         "      if (tid == 0 && more && !fin) issue(t + 1, 3);"),
        ("        if (tid == 0 && more) issue(t + 1, 2);",
         "        if (tid == 0 && more) issue(t + 1, 3);"),
        ("      if (tid == 0 && more) issue(t + 1, 1);\n",
         ""),
        ("      if (tid == 0 && more) issue(t + 1, 2);\n\n",
         "      if (tid == 0 && more) issue(t + 1, 3);\n\n")]},
}


def emit(**record):
    print(json.dumps(record), flush=True)


def parent_scratch_floats(B: int, H: int, Tq: int, Tk: int,
                          route: str = "wgmma") -> int:
    """f32 words of a scratch that holds either K2 scratch layout: the
    wgmma kernels' (``ops.attention._k2_scratch_floats``) and the mma.sync
    pair's that bf16 ran at 128 before its redesign (rowsum, then one byte
    per (b, h, query, 4 keys), rows padded to 64 keys), for a parent
    checkout's library of either kind."""
    pair = B * H * Tq + (B * H * Tq * (-(-Tk // 64)) * 16 + 16) // 4
    return max(pair, ORIGINAL_SCRATCH(B, H, Tq, Tk, "wgmma"))


ORIGINAL_SCRATCH = att._k2_scratch_floats


def start_build(name: str, edits: dict, src_dir: Path,
                entry: str = "attention_bwd"):
    """Write the edited sources to build/probe/k2_<name>/ and start nvcc on
    ``entry``.cu."""
    out = ROOT / "build" / "probe" / f"k2_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for src in src_dir.glob("*.cu*"):
        text = src.read_text()
        for old, new in edits.get(src.name, ()):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: an edit of {src.name} does "
                                   f"not apply")
            text = text.replace(old, new)
        (out / src.name).write_text(text)
    lib = out / f"lib{entry}.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                             str(out / f"{entry}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


def sass_counts(lib: Path) -> dict:
    """Per kernel of a library: its HGMMA, HMMA, UTMALDG, STL and LDL
    instructions in ``cuobjdump -sass``."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.search(r"attn_\w+?_kernel|\w+_kernel", m.group(1))
            cur = f"{cur.group(0) if cur else m.group(1)}#{len(counts)}"
            counts[cur] = {}
            continue
        for op in ("HGMMA", "HMMA", "UTMALDG", "STL", "LDL"):
            if cur and re.search(rf"\b{op}\b", line):
                counts[cur][op] = counts[cur].get(op, 0) + 1
    return counts


def finish_build(name: str, proc, lib: Path, argtypes):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    regs = {}
    for entry, spill, used in re.findall(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores"
            r".*?Used (\d+) registers", log, re.S):
        key = re.search(r"attn_bwd\w*?kernel\w*?E", entry)
        regs[key.group(0) if key else entry] = dict(
            registers=int(used), spill_bytes=int(spill))
    emit(phase="k2_variant_build", variant=name, ptxas=regs,
         sass=sass_counts(lib))
    fn = ctypes.CDLL(str(lib)).mmfm_attention_bwd
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k2_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", nvidia_smi=cs.nvidia_smi(),
         device=torch.cuda.get_device_name(0))
    args = sys.argv[1:]
    dtype, head_dim = torch.bfloat16, 32
    if args[:2] == ["--dtype", "float32"]:
        dtype, args = torch.float32, args[2:]
    if args[:2] == ["--head-dim", "128"]:
        head_dim, args = 128, args[2:]
    variants = {(torch.bfloat16, 32): VARIANTS,
                (torch.float32, 32): F32_VARIANTS,
                (torch.bfloat16, 128): B128_VARIANTS,
                (torch.float32, 128): F128_VARIANTS}[dtype, head_dim]
    entry = "attention_bwd" if head_dim == 32 else "attention_bwd_d128"
    emit(phase="k2_variants", dtype=cs.dtype_name(dtype), head_dim=head_dim)
    base_fn = att._k2_lib(head_dim)             # builds csrc/ as the port does
    sources = {name: (edits, build.CSRC) for name, edits in variants.items()}
    if args[:1] == ["--parent"]:
        parent = Path(args[1]).resolve()
        sources["parent"] = ({}, parent / build.CSRC.relative_to(ROOT))
    started = {name: start_build(name, edits, src, entry)
               for name, (edits, src) in sources.items()}
    fns = {name: finish_build(name, proc, lib, base_fn.argtypes)
           for name, (proc, lib) in started.items()}

    inputs = {}
    for B, _ in SHAPES:
        q, k, v, spec, H = cs.k1_inputs("encoder_eye_pad", dtype, B=B,
                                        H=256 // head_dim, D=head_dim)
        key_pad, static = att.spec_operands(spec, B, q.shape[1], k.shape[1],
                                            q.device)
        g = torch.randn(q.shape, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(3)).to(dtype)
        scale = 1.0 / math.sqrt(q.shape[-1] // H)
        lse = {rate: att.attention_fwd(q, k, v, key_pad, static, H, scale,
                                       True, rate, 7)[1]
               for rate in (cs.DROPOUT, 0.0)}
        inputs[B] = (q, k, v, key_pad, static, g, H, scale, lse)

    original = att._k2_lib
    times = {}
    try:
        order = list(fns)
        for sweep in (order, order[::-1]):
            for name in sweep:
                att._k2_lib = lambda head_dim=head_dim, fn=fns[name]: fn
                att._k2_scratch_floats = (ORIGINAL_SCRATCH if name != "parent"
                                          else parent_scratch_floats)
                for B, rates in SHAPES:
                    q, k, v, key_pad, static, g, H, scale, lse = inputs[B]
                    for rate in rates:
                        def call(rate=rate):
                            return att.attention_bwd(
                                q, k, v, key_pad, static, g, lse[rate], H,
                                scale, rate, 7)

                        if sweep is order and B == cs.BIG_B \
                                and not name.startswith("diag_"):
                            grads = call()
                            torch.cuda.synchronize()
                            gates = cs.k2_gates(q, k, v, key_pad, static, g,
                                                lse[rate], H, scale, grads,
                                                rate, 7)
                            emit(phase="k2_variant_check", variant=name,
                                 batch=B, dropout=rate, **gates)
                            del grads
                        times.setdefault((name, B, rate), []).append(
                            cs.kernel_ms_by_name(call))
    finally:
        att._k2_lib, att._k2_scratch_floats = original, ORIGINAL_SCRATCH
    for (name, B, rate), runs in times.items():
        emit(phase="k2_variant_time", variant=name, batch=B, dropout=rate,
             ms_in_order_and_reversed=[sum(r.values()) for r in runs],
             by_kernel_ms=runs)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
