#!/usr/bin/env python3
"""Design variants of the tensor-core K1, timed beside the committed kernel
on one NVIDIA GPU.

    python3 scripts/torch_k1_variants.py [--dtype float32] [--variants A,B] [--parent OTHER_CHECKOUT] [--other NAME=DIR ...]
    python3 scripts/torch_k1_variants.py --dtype float32|bfloat16 --head-dim 128 [--variants A,B] [--other NAME=DIR ...] [--parent OTHER_CHECKOUT]

Builds the committed ``csrc/attention_fwd.cu`` (head width 32) and
variants of it (string edits of the sources into
``build/probe/k1_<name>/``, each edit checked to apply exactly once) and,
with ``--parent``, another checkout's K1 (say the parent commit's,
unpacked by ``git archive``; a library whose ``mmfm_attention_fwd`` takes
no scratch pointer is called without one). Each library in turn is swapped
in for ``ops.attention._k1_lib``, checked against the plain version with
``chip_smoke.k1_gates`` at the smoke run's shapes (the encoder mask: the
eval's B = 320 without dropout, the training step's B = 256 with dropout
0.4 and lse; bf16 also dropout 0 with lse at B = 256 and dropout 0.4 at
B = 16) and timed there, kernel by kernel by profiler device time
(``chip_smoke.kernel_ms_by_name``) and by CUDA events
(``chip_smoke.cuda_time_ms``), in the order of the list and then in the
reverse order; a variant of one dtype's kernel runs that dtype only.
Prints JSON lines: the card, each build's ``ptxas`` registers and spills
per kernel, the kernels in which ptxas serialized the wgmmas (its C7514
note) and its SASS counts (``HGMMA``, ``HMMA``, ``UTMALDG``, ``STL``,
``LDL``) per kernel, each check, each timing.

The variants of the bf16 wgmma kernel (``csrc/attention_fwd_bf16.cuh``;
``diag_*`` compute wrong results on purpose and are only timed: what is
left when a piece is taken out):

- ``base``: the committed kernels (both dtypes at 16-64 on wgmma, the keep
  bits drawn by ``attn_fwd_keep_kernel`` first and read by TMA).
- ``draw_in_kernel``: no keep kernel; each warpgroup draws its elements'
  keep bits between the score wgmma's issue and its wait (one Philox call
  a pair of lanes and 4 keys, passed across the pair by a shuffle), at
  two blocks an SM, so that one block's draws run beside the other's
  products.
- ``one_block_an_sm``: ``__launch_bounds__`` asks for one block an SM
  (registers left free) in place of two.
- ``diag_no_softmax``: the scores go into pd as they are (no masks, max,
  exp, sums or dropout).
- ``diag_no_output_product``: the pd . v wgmmas not issued.

The variants of the f32 wgmma kernel (``csrc/attention_fwd_f32.cuh``,
``attn_fwd_tf_kernel<drop, 32>``; with ``--dtype float32`` and no
``--head-dim`` only base, the parent and these run, f32 only):

- ``f32_one_block_an_sm``: one block an SM in place of two:
  ``__launch_bounds__``, the grid's heads a block, and 120 KB more shared
  memory a block so that a second one cannot fit beside it (without it the
  card placed two all the same).
- ``cvt_split``: the TF32 split (``csrc/mma_tf32.cuh`` ``split_tf32``,
  of the landed tiles and of pd's fragments) rounding hi and lo by
  ``cvt.rna.tf32.f32`` in place of integer ops (the same bits,
  scripts/torch_tf32_rna_check.py).
- ``rna_unguarded``: lo rounded as hi is, without the signed min that
  keeps a NaN (one integer op fewer; a NaN operand may vanish): what
  keeping NaNs costs.
- ``split_unroll_8``: the split takes 8 chunks of 16 bytes a thread at a
  time (their loads in flight together), in place of 4 (``kU`` of
  ``csrc/tiles_f32.cuh``'s split).
- ``pairs_in_flight``: the output product's k-steps two in flight, in
  place of four (``kGroup``).
- ``group_7``: seven in flight (13 k-steps: a group of 7, then 6).
- ``diag_no_split``: the landed tiles not split into planes (the products
  read what is there).
- ``diag_no_softmax_f32``: no masks, max, exp, sums or dropout: the scores go
  into pd as they are.
- ``diag_no_score_products``: the s wgmmas not issued.
- ``diag_no_output_product_f32``: the pd . v wgmmas not issued.
- ``diag_keep_unread``: with dropout, the keep bytes land but are not
  read.
- ``diag_no_stores``: out and lse not stored.
- ``diag_loads_and_barriers``: none of the above: the loads, the attend
  bits, the barriers and the loop.

With ``--dtype float32 --head-dim 128`` the script builds
``csrc/attention_fwd_d128.cu`` and variants of its f32 kernel (edits of
``csrc/attention_fwd_f32_d128.cuh``), and with ``--parent`` the other
checkout's K1 at 128 (called with the scratch of the wgmma route: an
older mma.sync kernel ignores it). Each is checked with
``chip_smoke.k1_gates`` at the width row's shape (2 heads of 128, T =
200, the encoder mask) at B = 16 and B = 256, dropout 0.4 with lse, and
timed there by profiler device time kernel by kernel (the keep draws and
the kernel apart), dropout 0.4 with lse and dropout 0 without, in the
order of the list and reversed. The variants:

- ``base``: the committed kernel.
- ``split_before_products``: each chunk's k split whole (its four column
  blocks waited for and split) before its score products, not a column
  block at a time beside them.
- ``attend_per_thread``: the attend bits read by each thread for its
  own elements from the masks (two loads an element), not through a
  table in shared memory.
- ``stores_per_thread``: out stored by each thread from its accumulator
  (4-byte stores, eight rows of 32 bytes a warp store), not staged.
- ``v_with_first_k``: the first chunk's v issued beside its k and q, not
  once their first column block has landed.
- ``keep_read_during_scores``: with dropout, each thread's keep bits read
  from shared memory while the first score products run (live through
  them), not after s.
- ``diag_keep_unread``: with dropout, the keep bytes land but are not
  read (every score kept).
- ``diag_no_split``: the landed k rows not split into hi and lo planes
  (the products read what is there).
- ``diag_no_score_products``: the s wgmmas not issued.
- ``diag_no_output_product``: the o^T wgmmas not issued.
- ``diag_no_stores``: out not stored.
- ``diag_loads_and_barriers``: no split, no score or output products, no
  masks, exp, pd planes or stores: the loads, the attend bits, the
  barriers and the loop.
- ``cvt_split``, ``rna_unguarded``: as at 16-64 (``csrc/mma_tf32.cuh``).

With ``--dtype bfloat16 --head-dim 128`` the same for the bf16 kernel at
128 (edits of ``csrc/attention_fwd_bf16_d128.cuh``; ``--parent``: the
other checkout's K1 at 128), at the same shapes, and beside it SDPA's memory-efficient and cuDNN
forwards with the same bias and dropout 0.4 (profiler device time). The
variants:

- ``base``: the committed kernel.
- ``issue_at_tile_end``: the next tile's copies issued in one part once
  the output products are read, in place of two parts as buffers free up
  (q, k and the keep bytes once s is read).
- ``attend_guarded``: the attend bits' loads guarded by the bounds, in
  place of all issued with their indices clamped into the masks.
- ``diag_no_attend``: every element attended, no mask read.
- ``diag_no_softmax``: no masks, max, exp, sums or dropout: the scores go
  into pd as they are.
- ``diag_no_q_scale``: q not scaled in place (nor the barrier after it).
- ``diag_no_score_products``: the s wgmmas not issued.
- ``diag_no_output_product``: the pd . v wgmmas not issued.
- ``stores_staged``: out rounded to bf16 into a staging tile in shared
  memory (16 KB more), then stored 16 bytes a thread (a row's 128 bytes by
  8 threads), in place of each thread storing its sums 4 bytes at a time.
- ``divide_by_l``: out divided by l, each element, in place of times
  1 / l.
- ``diag_no_stores``: out and lse not stored (the exchange's reads, the
  sums and divisions go with them).

``--variants A,B,...`` runs only the named variants beside ``base`` (and
the parent and others). ``--other NAME=DIR`` (any number) adds another
checkout's K1 (at 128 with
``--head-dim 128``, else at 32) under
NAME, called as this one is (another version of
``csrc/attention_fwd_f32_d128.cuh`` or ``attention_fwd_bf16_d128.cuh`` in
DIR, say).

A variant whose build fails (nvcc has crashed on some of these edits)
is reported with its log and left out.
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
from torch_k2_variants import sass_counts  # noqa: E402

WG = "attention_fwd_bf16.cuh"
# draw_in_kernel: the draws, spliced in before the kernel's main loop
DRAW_ANCHOR = "  uint32_t att[2] = {0u, 0u};\n  if (n_ch == 1) attend(0, att);\n"
DRAW_KEEP = '''\
  // the keep bits of this thread's elements, in attend's order, drawn
  // here: keys [4 G, 4 G + 4) of a query, one Philox call, serve the pair
  // of lanes (c, c ^ 1) of an n8 block; the lane with c & 1 == j & 1
  // draws block j's group and the pair swaps its nibbles by a shuffle
  const unsigned seed = kDropout ? (unsigned)__ldg(a.seed) : 0u;
  auto draw_keep = [&](int t, uint32_t (&keep)[2]) {
    const int h = h0 + t / n_ch, ch = t % n_ch;
    const int g0 = (ch * kChunk + wgi * kCols) / 4 + (c >> 1);
    const int odd = c & 1;
    keep[0] = keep[1] = 0u;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = row0 + 8 * hh;
#pragma unroll
      for (int jj = 0; jj < (kBits / 2 + 1) / 2; ++jj) {
        const int j = 2 * jj + odd, jo = 2 * jj + 1 - odd;
        uint32_t mine = 0u;
        if (j < kBits / 2 && q < a.Tq)
          mine = keep_bits4(seed, a.threshold, b + a.b_off, h + a.h_off, q,
                            g0 + 2 * j);
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
        if (j < kBits / 2) keep[hh] |= (mine >> (2 * odd) & 3u) << (2 * j);
        if (jo < kBits / 2)
          keep[hh] |= (other >> (2 * odd) & 3u) << (2 * jo);
      }
    }
  };
'''

F32_SRC = "attention_fwd_f32.cuh"
F32_NO_SPLIT = [
    ("    if (ch == 0)\n      f32t::split<D, kRows, true, true, false, kThreads>(",
     "    if (false)\n      f32t::split<D, kRows, true, true, false, kThreads>("),
    ("    f32t::split<D, kChunk, false, true, false, kThreads>(",
     "    if (false) f32t::split<D, kChunk, false, true, false, kThreads>("),
    ("    f32t::split<D, kChunk, false, false, true, kThreads>(",
     "    if (false) f32t::split<D, kChunk, false, false, true, kThreads>(")]
F32_NO_SOFTMAX = [
    ("    if (live) {\n      // the bias, -inf past Tk",
     "    if (false) {\n      // the bias, -inf past Tk")]
F32_NO_SCORE = [
    ("        if (gi == 0)\n          f32t::step3x2<D>(s,",
     "        if (false)\n          f32t::step3x2<D>(s,"),
    ("        else\n          f32t::step3x2<D>(tmp[0],",
     "        else if (false)\n          f32t::step3x2<D>(tmp[0],")]
F32_NO_OUTPUT = [("  wgtf::mma3_rs_g(t, fh, fl, bh, bl);",
                  "  if (false) wgtf::mma3_rs_g(t, fh, fl, bh, bl);")]
F32_KEEP_UNREAD = [
    ("        if (gi == 0 && kDropout) load_keep(keep);",
     "        if (false) load_keep(keep);")]
F32_NO_STORES = [("    if (ch == n_ch - 1 && live) {", "    if (false) {")]
SPLIT_BODY = """  hi = tf32_rna(x);
  const int r = __float_as_int(x - __uint_as_float(hi));
  lo = ((uint32_t)min(r, 0x7FFFDFFF) + 0x1000u) & 0xFFFFE000u;"""
CVT_SPLIT = {"mma_tf32.cuh": [(SPLIT_BODY, """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));""")]}
RNA_UNGUARDED = {"mma_tf32.cuh": [(SPLIT_BODY, """  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));""")]}
F32_GROUP = "constexpr int kGroup = D <= 32 ? 4 : 2;"

# file name -> [(old, new)], each old text present exactly once
VARIANTS = {
    "base": {},
    "draw_in_kernel": {WG: [
        (DRAW_ANCHOR, DRAW_KEEP + DRAW_ANCHOR),
        ("    if (kDropout) load_keep(sm + L::kKeep + (t & 1) * kKeepBuf, keep);",
         "    if (kDropout) draw_keep(t, keep);"),
        ("                         (kDropout ? kKeepBytes : 0));",
         "                         0);"),
        ("    if (kDropout)\n      tma_load(base + L::kKeep",
         "    if (false)\n      tma_load(base + L::kKeep"),
        ("  float scale, keep_scale;\n};",
         "  float scale, keep_scale;\n  const long long* seed;\n"
         "  unsigned threshold;\n  int b_off, h_off;\n};"),
        ("                  scale,\n                  keep_scale};",
         "                  scale,\n                  keep_scale,\n"
         "                  seed,\n                  threshold,\n"
         "                  b_off,\n                  h_off};"),
        ("  if (kDropout) {\n    if (keep == nullptr ||",
         "  if (false) {\n    if (keep == nullptr ||"),
    ]},
    "one_block_an_sm": {WG: [
        ("constexpr int kBlocksPerSm = D <= 32 ? 2 : 1;",
         "constexpr int kBlocksPerSm = 1;")]},
    "diag_no_softmax": {WG: [
        ("    if (live) {\n      // the bias, -inf past Tk",
         "    if (false) {\n      // the bias, -inf past Tk"),
        ("    if (live) {\n      float corr[2];",
         "    if (false) {\n      float corr[2];")]},
    "diag_no_output_product": {WG: [
        ("    for (int kk = 0; kk < kSteps; ++kk)\n      mma_rs(o,",
         "    for (int kk = 0; kk < kSteps && false; ++kk)\n      mma_rs(o,")]},
    "f32_one_block_an_sm": {F32_SRC: [
        ("constexpr int kBlocksPerSm = 2;", "constexpr int kBlocksPerSm = 1;"),
        ("  static constexpr int kBytes = kBar + 8 + 1024;",
         "  static constexpr int kBytes = kBar + 8 + 1024 + 120 * 1024;")]},
    "cvt_split": CVT_SPLIT,
    "rna_unguarded": RNA_UNGUARDED,
    "split_unroll_8": {"tiles_f32.cuh": [(
        "  constexpr int kN = Rows<D>::kHalves * R * kCh, kU = 4;",
        "  constexpr int kN = Rows<D>::kHalves * R * kCh, kU = 8;")]},
    "pairs_in_flight": {F32_SRC: [
        (F32_GROUP, "constexpr int kGroup = 2;")]},
    "group_7": {F32_SRC: [
        (F32_GROUP, "constexpr int kGroup = D <= 32 ? 7 : 2;")]},
    "diag_no_split": {F32_SRC: F32_NO_SPLIT},
    "diag_no_softmax_f32": {F32_SRC: F32_NO_SOFTMAX},
    "diag_no_score_products": {F32_SRC: F32_NO_SCORE},
    "diag_no_output_product_f32": {F32_SRC: F32_NO_OUTPUT},
    "diag_keep_unread": {F32_SRC: F32_KEEP_UNREAD},
    "diag_no_stores": {F32_SRC: F32_NO_STORES},
    "diag_loads_and_barriers": {F32_SRC: F32_NO_SPLIT + F32_NO_SOFTMAX +
                                F32_NO_SCORE + F32_NO_OUTPUT +
                                F32_KEEP_UNREAD + F32_NO_STORES},
}


F128_SRC = "attention_fwd_f32_d128.cuh"
NO_SPLIT = [("      split(sm + region(t), sm + region(t + 1), 0);\n",
             "      if (false) split(sm + region(t), sm + region(t + 1), 0);\n"),
            ("          split(sm + region(t), sm + region(t + 1), nb);\n",
             "          if (false) split(sm + region(t), sm + region(t + 1), nb);"
             "\n")]
NO_SCORE = [("        if (gi == 0)\n          wgtf::mma3_rs2(acc,",
             "        if (false)\n          wgtf::mma3_rs2(acc,"),
            ("        else\n          wgtf::mma3_rs2(tmp[0],",
             "        else if (false)\n          wgtf::mma3_rs2(tmp[0],")]
NO_OUTPUT = [("        if (pair)\n          wgtf::mma3_rs2(to[0]",
              "        if (false)\n          wgtf::mma3_rs2(to[0]"),
             ("        else\n          wgtf::mma3_rs(to[0]",
              "        else if (false)\n          wgtf::mma3_rs(to[0]")]
NO_STORES = [("        if (row < a.Tq)\n          *reinterpret_cast<float4*>",
              "        if (false)\n          *reinterpret_cast<float4*>")]
NO_SOFTMAX = [
    ("      float cmax[2] = {-INFINITY, -INFINITY};\n#pragma unroll\n"
     "      for (int j = 0;",
     "      float cmax[2] = {-INFINITY, -INFINITY};\n#pragma unroll\n"
     "      if (false) for (int j = 0;"),
    ("#pragma unroll\n      for (int j = 0; j < kN8; ++j)\n#pragma unroll\n"
     "        for (int hh = 0; hh < 2; ++hh) {\n          float pd[2];",
     "#pragma unroll\n      if (false) for (int j = 0; j < kN8; ++j)\n"
     "#pragma unroll\n        for (int hh = 0; hh < 2; ++hh) {\n"
     "          float pd[2];")]
# the committed attend table and staged stores, and what they replaced
ATT_TABLE = (
    "  if (held) {\n    unsigned char* const tab = sm + region(1);",
    "  if (held) {\n    for (int ch = 0; ch < n_ch; ++ch) {\n"
    "      uint32_t bits[2];\n      attend(ch, bits);\n"
    "      att_all[0] |= bits[0] << (2 * kN8 * ch);\n"
    "      att_all[1] |= bits[1] << (2 * kN8 * ch);\n    }\n  }\n"
    "  if (false) {\n    unsigned char* const tab = sm + region(1);")
STAGED_STORES = (
    "      float* const stage = reinterpret_cast<float*>(sm + region(t));\n",
    "      float* const stage = reinterpret_cast<float*>(sm + region(t));\n"
    "#pragma unroll\n      for (int j = 0; j < kN8; ++j)\n#pragma unroll\n"
    "        for (int e = 0; e < 2; ++e) {\n"
    "          const int q = 8 * j + 2 * c + e, row = q0 + q;\n"
    "          if (row >= a.Tq) continue;\n"
    "          const float sum = corr_s[q];\n"
    "          float* const op = a.out + ((long long)b * a.Tq + row) * "
    "a.H * kD +\n                            h * kD + 64 * wgi + lr;\n"
    "#pragma unroll\n          for (int hh = 0; hh < 2; ++hh)\n"
    "            op[8 * hh] = o[4 * j + 2 * hh + e] / sum;\n        }\n"
    "      if (true) continue;\n")
# the whole chunk split before its score products
SPLIT_FIRST = [
    ("      wg::mbar_wait(bar_k, t & 1);\n"
     "      split(sm + region(t), sm + region(t + 1), 0);\n",
     "      for (int hf = 0; hf < kD / kBlk; ++hf) {\n"
     "        wg::mbar_wait(bar_k + 8 * hf, t & 1);\n"
     "        split(sm + region(t), sm + region(t + 1), hf);\n      }\n"),
    ("        if (gi % 2 == 0 && nb < kD / kBlk) {\n",
     "        if (false) {\n"),
    ("        if (gi % 2 == 1 && nb < kD / kBlk) {\n",
     "        if (false) {\n")]
F128_VARIANTS = {
    "base": {},
    "cvt_split": CVT_SPLIT,
    "rna_unguarded": RNA_UNGUARDED,
    "split_before_products": {F128_SRC: SPLIT_FIRST},
    "attend_per_thread": {F128_SRC: [ATT_TABLE]},
    "stores_per_thread": {F128_SRC: [STAGED_STORES]},
    "v_with_first_k": {F128_SRC: [
        ("    issue_k(0);\n    if (kDropout) issue_keep(0);\n",
         "    issue_k(0);\n    if (kDropout) issue_keep(0);\n"
         "    issue_v(0);\n"),
        ("      if (t == 0 && tid == 0) issue_v(0);\n", "")]},
    "keep_read_during_scores": {F128_SRC: [
        ("    uint32_t keep[2] = {~0u, ~0u};\n    if (kDropout) load_keep(keep);"
         "\n", ""),
        ("    float acc[kAcc];\n",
         "    float acc[kAcc];\n    uint32_t keep[2] = {~0u, ~0u};\n"),
        ("        wg::commit();\n        // the next column block split",
         "        wg::commit();\n"
         "        if (gi == 0 && kDropout) load_keep(keep);\n"
         "        // the next column block split")]},
    "diag_keep_unread": {F128_SRC: [
        ("    if (kDropout) load_keep(keep);\n",
         "    if (false) load_keep(keep);\n")]},
    "diag_no_split": {F128_SRC: NO_SPLIT},
    "diag_no_score_products": {F128_SRC: NO_SCORE},
    "diag_no_output_product": {F128_SRC: NO_OUTPUT},
    "diag_no_stores": {F128_SRC: NO_STORES},
    "diag_loads_and_barriers": {
        F128_SRC: NO_SPLIT + NO_SCORE + NO_OUTPUT + NO_STORES + NO_SOFTMAX},
}
# the K1 at 128: (batch, dropout, with lse) timed; checks at dropout 0.4
F128_SHAPES = ((cs.TRAIN_B, cs.DROPOUT, True), (cs.TRAIN_B, 0.0, False),
               (cs.BIG_B, cs.DROPOUT, True), (cs.BIG_B, 0.0, False))

B128_SRC = "attention_fwd_bf16_d128.cuh"
# stores_staged: out rounded into a staging tile in shared memory (its
# 16-byte pieces rotated by the row), then stored 16 bytes a thread
STAGED_LAYOUT = ("  static constexpr int kBar = kSum + 2 * kRows * 4;",
                 "  static constexpr int kOut = kSum + 2 * kRows * 4;\n"
                 "  static constexpr int kBar = kOut + 2 * kRows * kAtom;")
PER_THREAD_STORES = """\
    if (last && live) {
      // warpgroup 0's partial plus warpgroup 1's, times 1 / l (divided by
      // l, each element, the kernel took 3-7% longer): warpgroup 0 stores
      // columns [0, 64), warpgroup 1 [64, 128)
      const float* other = xchg + (wgi == 0 ? 32 : 0) * 128 + t128;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= a.Tq) continue;
        const float sum = rsum[lr + 8 * hh] + rsum[kRows + lr + 8 * hh];
        const float inv = 1.f / sum;
        bf16* op = a.out + ((long long)b * a.Tq + row) * a.H * kD + h * kD +
                   kBox * wgi;
#pragma unroll
        for (int nt = 0; nt < kBox / 8; ++nt) {
          const int i = 4 * nt + 2 * hh;
          const float x0 = other[i * 128], x1 = other[(i + 1) * 128];
          const float s0 = wgi == 0 ? o1[i] + x0 : x0 + o2[i];
          const float s1 = wgi == 0 ? o1[i + 1] + x1 : x1 + o2[i + 1];
          *reinterpret_cast<uint32_t*>(op + 8 * nt + 2 * c) =
              pack_bf16(s0 * inv, s1 * inv);
        }
        if (a.lse != nullptr && wgi == 0 && c == 0)
          a.lse[((long long)b * a.H + h) * a.Tq + row] =
              fmaxf(m[hh], kLseFloor) + logf(sum);
      }
    }
"""
STAGED_STORES = """\
    if (last) {
      unsigned char* const st = sm + L::kOut + wgi * kRows * kAtom;
      if (live) {
        const float* other = xchg + (wgi == 0 ? 32 : 0) * 128 + t128;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = lr + 8 * hh;
          if (q0 + r >= a.Tq) continue;
          const float sum = rsum[r] + rsum[kRows + r];
          const float inv = 1.f / sum;
#pragma unroll
          for (int nt = 0; nt < kBox / 8; ++nt) {
            const int i = 4 * nt + 2 * hh;
            const float x0 = other[i * 128], x1 = other[(i + 1) * 128];
            const float s0 = wgi == 0 ? o1[i] + x0 : x0 + o2[i];
            const float s1 = wgi == 0 ? o1[i + 1] + x1 : x1 + o2[i + 1];
            *reinterpret_cast<uint32_t*>(st + r * kAtom +
                                         ((nt ^ (r & 7)) << 4) + 4 * c) =
                pack_bf16(s0 * inv, s1 * inv);
          }
          if (a.lse != nullptr && wgi == 0 && c == 0)
            a.lse[((long long)b * a.H + h) * a.Tq + q0 + r] =
                fmaxf(m[hh], kLseFloor) + logf(sum);
        }
      }
      asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wgi) : "memory");
      bf16* const op = a.out + ((long long)b * a.Tq + q0) * a.H * kD +
                       h * kD + kBox * wgi;
#pragma unroll
      for (int i = t128; i < kRows * 8; i += 128) {
        const int r = i >> 3, pc = i & 7;
        if (q0 + r >= a.Tq) break;
        *reinterpret_cast<uint4*>(op + (long long)r * a.H * kD + 8 * pc) =
            *reinterpret_cast<const uint4*>(st + r * kAtom +
                                            ((pc ^ (r & 7)) << 4));
      }
    }
"""
B128_VARIANTS = {
    "base": {},
    "issue_at_tile_end": {B128_SRC: [
        ("    if (tid == 0 && more) issue(t + 1, 1);\n", ""),
        ("    if (tid == 0 && more) issue(t + 1, 2);\n",
         "    if (tid == 0 && more) issue(t + 1, 3);\n")]},
    "attend_guarded": {B128_SRC: [
        ("""          const int qc = min(q, a.Tq - 1), kc = min(k, a.Tk - 1);
          const int on = __ldg(a.static_mask + (long long)qc * a.Tk + kc) |
                         __ldg(a.key_pad + (long long)b * a.Tk + kc);
          if (q < a.Tq && k < a.Tk && on != 0) m[hh] |= 1u << (2 * j + e);""",
         """          if (q < a.Tq && k < a.Tk &&
              (__ldg(a.static_mask + (long long)q * a.Tk + k) |
               __ldg(a.key_pad + (long long)b * a.Tk + k)) != 0)
            m[hh] |= 1u << (2 * j + e);""")]},
    "diag_no_attend": {B128_SRC: [
        ("  if (n_ch == 1) attend(0, att);",
         "  if (n_ch == 1) att[0] = att[1] = ~0u;")]},
    "diag_no_softmax": {B128_SRC: [
        ("    if (live) {\n      // the bias, -inf past Tk",
         "    if (false) {\n      // the bias, -inf past Tk"),
        ("    if (live) {\n      float corr[2];",
         "    if (false) {\n      float corr[2];")]},
    "diag_no_q_scale": {B128_SRC: [
        ("    mbar_wait(bar, t & 1);\n    if (ch == 0) {",
         "    mbar_wait(bar, t & 1);\n    if (false) {")]},
    "diag_no_score_products": {B128_SRC: [
        ("    for (int kk = 0; kk < kD / 16; ++kk)\n      mma_ss_n104(",
         "    for (int kk = 0; kk < kD / 16 && false; ++kk)\n      mma_ss_n104(")]},
    "diag_no_output_product": {B128_SRC: [
        ("    for (int kk = 0; kk < kSteps; ++kk) {",
         "    for (int kk = 0; kk < kSteps && false; ++kk) {")]},
    "diag_no_stores": {B128_SRC: [
        ("    if (last && live) {", "    if (false) {")]},
    "stores_staged": {B128_SRC: [STAGED_LAYOUT,
                                 (PER_THREAD_STORES, STAGED_STORES)]},
    "divide_by_l": {B128_SRC: [
        ("              pack_bf16(s0 * inv, s1 * inv);",
         "              pack_bf16(s0 / sum, s1 / sum);")]},
}

# the dtype each variant's kernel runs (the others time both)
F32_ONLY = ("f32_one_block_an_sm", "cvt_split", "rna_unguarded",
            "split_unroll_8",
            "pairs_in_flight",
            "group_7", "diag_no_split",
            "diag_no_softmax_f32", "diag_no_score_products",
            "diag_no_output_product_f32", "diag_keep_unread",
            "diag_no_stores", "diag_loads_and_barriers")
BF16_ONLY = ("draw_in_kernel", "one_block_an_sm", "diag_no_softmax",
             "diag_no_output_product")


def chosen(variants: dict, args) -> dict:
    """``variants`` cut to ``base`` and the names after ``--variants``
    (comma-separated) when ``args`` holds it."""
    if "--variants" not in args:
        return variants
    names = set(args[args.index("--variants") + 1].split(",")) | {"base"}
    unknown = names - set(variants)
    if unknown:
        raise SystemExit(f"unknown variants: {sorted(unknown)}")
    return {name: edits for name, edits in variants.items() if name in names}


def emit(**record):
    print(json.dumps(record), flush=True)


def start_build(name: str, edits: dict, src_dir: Path,
                entry: str = "attention_fwd"):
    """Write the edited sources to build/probe/k1_<name>/ and start nvcc on
    ``entry``.cu."""
    out = ROOT / "build" / "probe" / f"k1_{name}"
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


def finish_build(name: str, proc, lib: Path, argtypes):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    regs = {}
    for entry, spill, used in re.findall(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores"
            r".*?Used (\d+) registers", log, re.S):
        key = re.search(r"attn_fwd\w*?kernel\w*?E", entry)
        regs[key.group(0) if key else entry] = dict(
            registers=int(used), spill_bytes=int(spill))
    # ptxas's C7514 notes: wgmmas it serialized because other instructions
    # read their accumulators inside a pipeline stage
    serialized = sorted(set(re.findall(
        r"C7514\).*?in the function '(\S+?)'", log)))
    emit(phase="k1_variant_build", variant=name, ptxas=regs,
         sass=sass_counts(lib), wgmma_serialized_in=serialized)
    fn = ctypes.CDLL(str(lib)).mmfm_attention_fwd
    if "void* scratch" in (lib.parent / "attention_fwd.cu").read_text():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn
    # an older library without the scratch pointer (the 8th argument)
    fn.argtypes = argtypes[:7] + argtypes[8:]
    fn.restype = ctypes.c_int
    return lambda *args: fn(*args[:7], *args[8:])


def main_d128(args, dtype=torch.float32) -> int:
    """The K1 at head width 128 in ``dtype``: its variants
    (``F128_VARIANTS``, ``B128_VARIANTS``) and, with ``--parent DIR``, the
    other checkout's K1 at 128,
    checked and timed at ``F128_SHAPES``; bf16 beside SDPA's
    memory-efficient and cuDNN forwards."""
    entry, H, D = "attention_fwd_d128", 2, 128
    base_fn = att._k1_lib(D)                    # builds csrc/ as the port does
    variants = chosen(F128_VARIANTS if dtype == torch.float32
                      else B128_VARIANTS, args)
    sources = {name: (edits, build.CSRC)
               for name, edits in variants.items()}
    for i, arg in enumerate(args):
        if arg == "--parent":
            sources["parent"] = ({}, Path(args[i + 1]).resolve()
                                 / build.CSRC.relative_to(ROOT))
        elif arg == "--other":
            name, path = args[i + 1].split("=", 1)
            sources[name] = ({}, Path(path).resolve()
                             / build.CSRC.relative_to(ROOT))
    started = {name: start_build(name, edits, src, entry)
               for name, (edits, src) in sources.items()}
    fns = {}
    for name, (proc, lib) in started.items():
        try:
            fns[name] = finish_build(name, proc, lib, base_fn.argtypes)
        except RuntimeError as err:
            if name == "base":
                raise
            emit(phase="k1_variant_build_failed", variant=name,
                 log=str(err)[-2000:])
    inputs = {}
    for B in sorted({b for b, _, _ in F128_SHAPES}):
        q, k, v, spec, _ = cs.k1_inputs("encoder_eye_pad", dtype,
                                        B=B, H=H, D=D)
        key_pad, static = att.spec_operands(spec, B, q.shape[1], k.shape[1],
                                            q.device)
        inputs[B] = (q, k, v, key_pad, static)
    original = att._k1_lib
    times = {}
    try:
        order = list(fns)
        for sweep in (order, order[::-1]):
            for name in sweep:
                att._k1_lib = lambda head_dim=D, fn=fns[name]: fn
                for B, rate, with_lse in F128_SHAPES:
                    q, k, v, key_pad, static = inputs[B]

                    def call(rate=rate, with_lse=with_lse):
                        return att.attention_fwd(q, k, v, key_pad, static, H,
                                                 D ** -0.5, with_lse, rate, 7)

                    if sweep is order and rate > 0.0 \
                            and not name.startswith("diag_"):
                        out, lse = call()
                        torch.cuda.synchronize()
                        gates = cs.k1_gates(q, k, v, key_pad, static, H,
                                            D ** -0.5, out, lse, rate, 7)
                        emit(phase="k1_variant_check", variant=name,
                             dtype=cs.dtype_name(dtype), head_dim=D, batch=B,
                             **gates)
                        del out, lse
                    times.setdefault((name, B, rate, with_lse), []).append(
                        cs.kernel_ms_by_name(call))
                if dtype == torch.bfloat16 and name == order[0]:
                    sdpa_times(inputs, H, D, times)
    finally:
        att._k1_lib = original
    for (name, B, rate, with_lse), runs in times.items():
        emit(phase="k1_variant_time", variant=name,
             dtype=cs.dtype_name(dtype), head_dim=D, batch=B, dropout=rate,
             with_lse=with_lse,
             device_ms_in_order_and_reversed=[sum(r.values()) for r in runs],
             by_kernel_ms=runs)
    print(cs.nvidia_smi(), flush=True)
    return 0


def sdpa_times(inputs, H: int, D: int, times: dict) -> None:
    """SDPA's memory-efficient and cuDNN forwards on the same inputs, the
    additive bias of the masks and dropout 0.4, by profiler device time,
    into ``times`` under ``sdpa_<backend>`` (a refusal is named)."""
    for B, (q, k, v, key_pad, static) in inputs.items():
        bias = att.mask_to_bias(static.bool()[None] | key_pad.bool()[:, None])
        bias = bias[:, None].to(q.dtype)
        qh, kh, vh = (x.unflatten(-1, (H, D)).transpose(1, 2)
                      for x in (q, k, v))
        for backend in ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
            def call(backend=backend):
                return cs.sdpa(qh, kh, vh, attn_mask=bias,
                               dropout_p=cs.DROPOUT, backend=backend)

            try:
                by = cs.kernel_ms_by_name(call)
            except RuntimeError as err:
                emit(phase="k1_sdpa_refused", backend=backend, batch=B,
                     why=str(err)[:200])
                continue
            times.setdefault((f"sdpa_{backend.lower()}", B, cs.DROPOUT,
                              False), []).append(by)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", nvidia_smi=cs.nvidia_smi(),
         device=torch.cuda.get_device_name(0))
    args = sys.argv[1:]
    if args[:4] == ["--dtype", "float32", "--head-dim", "128"]:
        return main_d128(args[4:])
    if args[:4] == ["--dtype", "bfloat16", "--head-dim", "128"]:
        return main_d128(args[4:], torch.bfloat16)
    only_f32 = args[:2] == ["--dtype", "float32"]
    if only_f32:
        args = args[2:]
    base_fn = att._k1_lib()                     # builds csrc/ as the port does
    sources = {name: (edits, build.CSRC)
               for name, edits in chosen(VARIANTS, args).items()
               if not (only_f32 and name in BF16_ONLY)}
    for i, arg in enumerate(args):
        if arg == "--parent":
            sources["parent"] = ({}, Path(args[i + 1]).resolve()
                                 / build.CSRC.relative_to(ROOT))
        elif arg == "--other":
            name, path = args[i + 1].split("=", 1)
            sources[name] = ({}, Path(path).resolve()
                             / build.CSRC.relative_to(ROOT))
    started = {name: start_build(name, edits, src)
               for name, (edits, src) in sources.items()}
    fns = {name: finish_build(name, proc, lib, base_fn.argtypes)
           for name, (proc, lib) in started.items()}

    shapes = {}
    cases = [(dtype, "eval", 320, 0.0, False) for dtype in cs.DTYPES]
    cases += [(dtype, "train", cs.BIG_B, cs.DROPOUT, True)
              for dtype in cs.DTYPES]
    cases += [(torch.bfloat16, "train_rate0", cs.BIG_B, 0.0, True),
              (torch.bfloat16, "train_b16", cs.TRAIN_B, cs.DROPOUT, True)]
    if only_f32:
        cases = [c for c in cases if c[0] == torch.float32]
    for dtype, kind, B, rate, with_lse in cases:
        q, k, v, spec, H = cs.k1_inputs("encoder_eye_pad", dtype, B=B)
        key_pad, static = att.spec_operands(spec, B, q.shape[1], k.shape[1],
                                            q.device)
        shapes[dtype, kind] = (q, k, v, key_pad, static, H,
                               1.0 / math.sqrt(q.shape[-1] // H), with_lse,
                               rate)

    original = att._k1_lib
    times = {}
    try:
        order = list(fns)
        for sweep in (order, order[::-1]):
            for name in sweep:
                att._k1_lib = lambda head_dim=32, fn=fns[name]: fn
                for (dtype, kind), args in shapes.items():
                    if (name in F32_ONLY and dtype != torch.float32) or \
                            (name in BF16_ONLY and dtype != torch.bfloat16):
                        continue
                    q, k, v, key_pad, static, H, scale, with_lse, rate = args

                    def call():
                        return att.attention_fwd(q, k, v, key_pad, static, H,
                                                 scale, with_lse, rate, 7)

                    if sweep is order and not name.startswith("diag_"):
                        out, lse = att.attention_fwd(q, k, v, key_pad, static,
                                                     H, scale, True, rate, 7)
                        torch.cuda.synchronize()
                        gates = cs.k1_gates(q, k, v, key_pad, static, H,
                                            scale, out, lse, rate, 7)
                        emit(phase="k1_variant_check", variant=name,
                             dtype=cs.dtype_name(dtype), kind=kind,
                             shape=list(q.shape), **gates)
                        del out, lse
                    times.setdefault((name, dtype, kind), []).append(dict(
                        device_by_kernel=cs.kernel_ms_by_name(call),
                        events=cs.cuda_time_ms(call)))
    finally:
        att._k1_lib = original
    for (name, dtype, kind), runs in times.items():
        args = shapes[dtype, kind]
        emit(phase="k1_variant_time", variant=name,
             dtype=cs.dtype_name(dtype), kind=kind,
             batch=args[0].shape[0], dropout=args[-1], with_lse=args[-2],
             device_ms_in_order_and_reversed=[
                 sum(r["device_by_kernel"].values()) for r in runs],
             events_ms_in_order_and_reversed=[r["events"] for r in runs],
             by_kernel_ms=[r["device_by_kernel"] for r in runs])
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
