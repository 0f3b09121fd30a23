#!/usr/bin/env python3
"""Design variants of the tensor-core K1, timed beside the committed kernel
on one NVIDIA GPU.

    python3 scripts/torch_k1_variants.py [--parent OTHER_CHECKOUT]

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
per kernel and its SASS counts (``HGMMA``, ``HMMA``, ``UTMALDG``, ``STL``,
``LDL``) per kernel, each check, each timing.

The variants of the bf16 wgmma kernel (``csrc/attention_fwd_bf16.cuh``;
``diag_*`` compute wrong results on purpose and are only timed: what is
left when a piece is taken out):

- ``base``: the committed kernels (bf16 at 16-64 on wgmma, the keep bits
  drawn by ``attn_fwd_keep_kernel`` first and read by TMA; f32 on
  mma.sync).
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

The variants of the f32 mma.sync kernel (``attn_fwd_tc_kernel<float>``):

- ``b_split_in_registers``: the f32 k and v tiles kept as one f32 plane
  (half the shared memory again) and each B fragment split into hi and lo
  in registers where it is read.
- ``int_index``: the tile loops' chunk index an ``int`` instead of
  ``unsigned`` (its division and remainder no longer a shift and a mask).
- ``other_buffers``: two k/v tile buffers in place of one (~81 KB of
  shared memory a block, 2 blocks an SM; each tile's copy overlaps the
  last one's products).
- ``heads_per_block_2``: blocks of 2 heads instead of all 8 (4x the
  blocks, the mask read 4x as often).
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

SPLIT_HELPERS = '''
// b_split_in_registers: mma_rows_3x / mma_cols_3x on one f32 plane, each B
// fragment split where it is read (at D = 32, the width it was measured at)
constexpr int kLdF = ld_f32(32);

__device__ __forceinline__ void mma_rows_3x_r(float (&acc)[8][4],
                                              const uint32_t (&ah)[4][4],
                                              const uint32_t (&al)[4][4],
                                              const float* tile, int lane,
                                              int n_valid) {
  const int gid = lane >> 2, tig = lane & 3;
  const float* t = tile + gid * kLdF + tig;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= n_valid) break;
    const float* r = t + nt * 8 * kLdF;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(r[ks * 8], bh0, bl0);
      split_tf32(r[ks * 8 + 4], bh1, bl1);
      mma_3xtf32(acc[nt], ah[ks], al[ks], bh0, bh1, bl0, bl1);
    }
  }
}

__device__ __forceinline__ void mma_cols_3x_r(float (&out)[4][4],
                                              const float (&acc)[8][4],
                                              const float* tile, int lane,
                                              int n_valid) {
  const int gid = lane >> 2, tig = lane & 3;
  const float* t = tile + 2 * tig * kLdF + gid;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt * 8 >= n_valid) break;
    uint32_t ah[4], al[4];
    split_tf32(acc[nt][0], ah[0], al[0]);
    split_tf32(acc[nt][2], ah[1], al[1]);
    split_tf32(acc[nt][1], ah[2], al[2]);
    split_tf32(acc[nt][3], ah[3], al[3]);
    const float* r = t + nt * 8 * kLdF;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(r[dt * 8], bh0, bl0);
      split_tf32(r[kLdF + dt * 8], bh1, bl1);
      mma_3xtf32(out[dt], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

}  // namespace mmfm
'''

LOAD_LOOP = """\
    for (unsigned c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int r = c / Ops::kChunks"""
LAND_LOOP = """\
    for (unsigned c = tid; c < kTcRows * Ops::kChunks; c += kTcThreads) {
      const int at = """

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
    "b_split_in_registers": {
        "tc_traits.cuh": [
            ("  static constexpr int kElems = 2 * plane_f32(D);",
             "  static constexpr int kElems = plane_f32(D);"),
            ("    mma_rows_3x<D>(acc, a.hi, a.lo, tile, lane, n_valid);",
             "    mma_rows_3x_r(acc, a.hi, a.lo, tile, lane, n_valid);"),
            ("    mma_cols_3x<D>(out, acc, tile, lane, n_valid);",
             "    mma_cols_3x_r(out, acc, tile, lane, n_valid);"),
            # K1 lands its tiles with kScale = false: nothing to do
            ("    land_split<D, kScale>(p, mul);",
             "    (void)p;\n    (void)mul;"),
        ],
        "mma_tf32.cuh": [("\n}  // namespace mmfm\n", SPLIT_HELPERS)],
    },
    "int_index": {
        "attention_fwd.cu": [
            (LOAD_LOOP, LOAD_LOOP.replace("(unsigned c", "(int c")),
            (LAND_LOOP, LAND_LOOP.replace("(unsigned c", "(int c")),
        ],
    },
    "other_buffers": {
        "tc_traits.cuh": [
            ("kFwdBufs = 1;\n  struct Frags {\n    uint32_t hi[",
             "kFwdBufs = 2;\n  struct Frags {\n    uint32_t hi["),
        ],
    },
    "heads_per_block_2": {
        "attention_fwd.cu": [
            ("  const int hpb = heads_per_block(B, n_qt, H);",
             "  const int hpb = H % 2 ? 1 : 2;"),
        ],
    },
}


# the dtype each variant's kernel runs (the others time both)
F32_ONLY = ("b_split_in_registers", "int_index", "other_buffers",
            "heads_per_block_2")
BF16_ONLY = ("draw_in_kernel", "one_block_an_sm", "diag_no_softmax",
             "diag_no_output_product")


def emit(**record):
    print(json.dumps(record), flush=True)


def start_build(name: str, edits: dict, src_dir: Path):
    """Write the edited sources to build/probe/k1_<name>/ and start nvcc."""
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
    lib = out / "libattention_fwd.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                             str(out / "attention_fwd.cu")],
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
    emit(phase="k1_variant_build", variant=name, ptxas=regs,
         sass=sass_counts(lib))
    fn = ctypes.CDLL(str(lib)).mmfm_attention_fwd
    if "void* scratch" in (lib.parent / "attention_fwd.cu").read_text():
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn
    # an older library without the scratch pointer (the 8th argument)
    fn.argtypes = argtypes[:7] + argtypes[8:]
    fn.restype = ctypes.c_int
    return lambda *args: fn(*args[:7], *args[8:])


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", nvidia_smi=cs.nvidia_smi(),
         device=torch.cuda.get_device_name(0))
    base_fn = att._k1_lib()                     # builds csrc/ as the port does
    sources = {name: (edits, build.CSRC) for name, edits in VARIANTS.items()}
    if sys.argv[1:2] == ["--parent"]:
        parent = Path(sys.argv[2]).resolve()
        sources["parent"] = ({}, parent / build.CSRC.relative_to(ROOT))
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
