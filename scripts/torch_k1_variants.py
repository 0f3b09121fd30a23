#!/usr/bin/env python3
"""Design variants of the tensor-core K1, timed beside the committed kernel
on one NVIDIA GPU.

    python3 scripts/torch_k1_variants.py [--parent OTHER_CHECKOUT]

Builds the committed ``csrc/attention_fwd.cu`` and variants of it (string
edits of the sources into ``build/probe/k1_<name>/``, each edit checked to
apply exactly once) and, with ``--parent``, another checkout's K1 (say the
parent commit's, unpacked by ``git archive``). Each library in turn is
swapped in for ``ops.attention._k1_lib``, checked against the plain version
with ``chip_smoke.k1_gates`` at the smoke run's shapes (the encoder mask:
the eval's B = 320 without dropout, the training step's B = 256 with
dropout 0.4 and lse), and timed there with ``chip_smoke.cuda_time_ms``
(CUDA events, 20 launches after 3 warm-ups), f32 and bf16, in the order of
the list and then in the reverse order. Prints JSON lines: the card, each
build's ``ptxas`` registers and spills per kernel, each check, each timing.

The variants:

- ``base``: the committed kernel (f32 k/v tiles in one buffer, bf16 in
  two: ``Tc<T, D>::kFwdBufs``); all at head width 32.
- ``b_split_in_registers``: the f32 k and v tiles kept as one f32 plane
  (half the shared memory again) and each B fragment split into hi and lo
  in registers where it is read.
- ``int_index``: the tile loops' chunk index an ``int`` instead of
  ``unsigned`` (its division and remainder no longer a shift and a mask).
- ``other_buffers``: each dtype with the other's number of k/v tile
  buffers: f32 double-buffered (~81 KB of shared memory a block, 2 blocks
  an SM; each tile's copy overlaps the last one's products), bf16 in one.
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
            ("kFwdBufs = 2;\n  struct Frags {\n    uint32_t f[",
             "kFwdBufs = 1;\n  struct Frags {\n    uint32_t f["),
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
        key = re.search(r"attn_fwd\w*?EE", entry).group(0)
        regs[key] = dict(registers=int(used), spill_bytes=int(spill))
    emit(phase="k1_variant_build", variant=name, ptxas=regs)
    fn = ctypes.CDLL(str(lib)).mmfm_attention_fwd
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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
    for dtype in cs.DTYPES:
        for kind, B in (("eval", 320), ("train", cs.BIG_B)):
            q, k, v, spec, H = cs.k1_inputs("encoder_eye_pad", dtype, B=B)
            key_pad, static = att.spec_operands(spec, B, q.shape[1],
                                                k.shape[1], q.device)
            rate, lse = (0.0, False) if kind == "eval" else (cs.DROPOUT, True)
            shapes[dtype, kind] = (q, k, v, key_pad, static, H,
                                   1.0 / math.sqrt(q.shape[-1] // H), lse,
                                   rate)

    original = att._k1_lib
    times = {}
    try:
        order = list(fns)
        for sweep in (order, order[::-1]):
            for name in sweep:
                att._k1_lib = lambda head_dim=32, fn=fns[name]: fn
                for (dtype, kind), args in shapes.items():
                    q, k, v, key_pad, static, H, scale, with_lse, rate = args

                    def call():
                        return att.attention_fwd(q, k, v, key_pad, static, H,
                                                 scale, True, rate, 7)

                    if sweep is order:
                        out, lse = call()
                        torch.cuda.synchronize()
                        gates = cs.k1_gates(q, k, v, key_pad, static, H,
                                            scale, out, lse, rate, 7)
                        emit(phase="k1_variant_check", variant=name,
                             dtype=cs.dtype_name(dtype), kind=kind,
                             shape=list(q.shape), **gates)
                        del out, lse
                    times.setdefault((name, dtype, kind), []).append(
                        cs.cuda_time_ms(lambda: att.attention_fwd(
                            q, k, v, key_pad, static, H, scale, with_lse,
                            rate, 7)))
    finally:
        att._k1_lib = original
    for (name, dtype, kind), ms in times.items():
        emit(phase="k1_variant_time", variant=name,
             dtype=cs.dtype_name(dtype), kind=kind,
             batch=shapes[dtype, kind][0].shape[0],
             dropout=shapes[dtype, kind][-1], ms_in_order_and_reversed=ms)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
