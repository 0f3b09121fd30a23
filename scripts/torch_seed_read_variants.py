#!/usr/bin/env python3
"""How K1 and K2 read their Philox key, timed on one NVIDIA GPU.

    python3 scripts/torch_seed_read_variants.py

K1 and K2 read the key from a seed-table entry in device memory, so that a
CUDA graph of a training step draws each step's own bits. This script
builds the committed ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``
and variants of how the kernels take the key (string edits of the sources
into ``build/probe/seed_<name>/``, each edit checked to apply exactly
once), swaps each in for ``ops.attention._k1_lib`` / ``_k2_lib``, checks
K1 with ``chip_smoke.k1_gates`` and K2 against its plain version (the
smoke's gates: f32 atol 1e-5) on the same Philox bits, and times both with
CUDA events at the training step's B=256 encoder shape, dropout 0.4, in
order and then reversed. f32 only: the variants edit the mma.sync kernels'
read of the key, and bf16 at head width 32 runs the wgmma kernels, whose
keep kernels read it (``ops.attention.k1_route`` / ``k2_route``); the
``by_value`` build hands those launches no key.

- ``pointer``: the committed read, ``__ldg`` of the entry into a register.
- ``by_value``: the key as a kernel argument (the ABI before the seed
  table; the harness passes the value), the register-free reference.
- ``redux``: the loaded key passed through ``__reduce_max_sync`` over the
  warp, whose result ptxas keeps in a uniform register, as it keeps a
  kernel argument.

Prints JSON lines: the card, each build's ``ptxas`` registers per kernel,
each check, each timing.
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

READ = ("const unsigned seed = kDropout ? (unsigned)__ldg(seed_ptr) : 0u;")
# both kernels' parameter, launcher and entry-point spellings of the key
PARAMS = {
    "attention_fwd.cu": ("float scale, const long long* __restrict__ "
                         "seed_ptr,", "float scale, const long long* seed,",
                         "const long long* seed, unsigned threshold, float "
                         "keep_scale, int dropout,"),
    "attention_bwd.cu": ("const long long* __restrict__ seed_ptr,",
                         "const long long* seed, unsigned threshold,\n"
                         "                      float keep_scale, "
                         "int b_off",
                         "float scale, const long long* seed, unsigned "
                         "threshold,"),
}


# the wgmma launches' key argument (bf16, not timed here): none in the
# by_value build, whose entry points take the key's value
WG_KEY = {
    "attention_fwd.cu": ("lse, scratch, B, Tq, Tk, H, q_sb,  \\\n"
                         "      q_st, k_sb, k_st, v_sb, v_st, scale, seed,"),
    "attention_bwd.cu": ("mmfm::k2wg::launch<DROP, MMFM_HEAD_DIM>(" + " " * 35
                         + "\\\n      q, k, v, g, key_pad, static_mask, lse, "
                         "rowsum, dq, dk, dv, B, Tq, Tk,  \\\n      H, q_sb, "
                         "q_st, k_sb, k_st, v_sb, v_st, g_sb, g_st, scale, "
                         "seed,"),
}


def _by_value_edits():
    edits = {}
    for src, (kern, launch, entry) in PARAMS.items():
        edits[src] = [
            (kern, kern.replace("const long long* __restrict__ seed_ptr",
                                "unsigned seed_val")),
            (launch, launch.replace("const long long* seed",
                                    "unsigned seed")),
            (entry, entry.replace("const long long* seed", "unsigned seed")),
            (READ, "const unsigned seed = seed_val;"),
            (WG_KEY[src], WG_KEY[src].replace("scale, seed,",
                                              "scale, nullptr,"))]
    return edits


VARIANTS = {
    "pointer": {},
    "by_value": _by_value_edits(),
    "redux": {src: [(READ, "const unsigned seed = kDropout ? "
                     "__reduce_max_sync(0xffffffffu, "
                     "(unsigned)__ldg(seed_ptr)) : 0u;")]
              for src in PARAMS},
}
K1_SEED_ARG, K2_SEED_ARG = 20, 25          # index of the key in the ABI


def emit(**record):
    print(json.dumps(record), flush=True)


def start_builds(name: str, edits: dict):
    out = ROOT / "build" / "probe" / f"seed_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for src in build.CSRC.glob("*.cu*"):
        text = src.read_text()
        for old, new in edits.get(src.name, ()):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: an edit of {src.name} does "
                                   f"not apply ({text.count(old)} matches)")
            text = text.replace(old, new)
        (out / src.name).write_text(text)
    procs = {}
    for lib in ("attention_fwd", "attention_bwd"):
        so = out / f"lib{lib}.so"
        procs[lib] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
             str(out / f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    return procs


def finish_builds(name: str, procs: dict, by_value: bool) -> dict:
    fns = {}
    for lib, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} {lib}: nvcc failed\n{log}")
        regs = {m[0][:60]: int(m[1]) for m in re.findall(
            r"Compiling entry function '(\S+)'.*?Used (\d+) registers",
            log, re.S)}
        emit(phase="seed_variant_build", variant=name, library=lib,
             registers=regs)
        base = att._k1_lib() if lib == "attention_fwd" else att._k2_lib()
        argtypes = list(base.argtypes)
        at = K1_SEED_ARG if lib == "attention_fwd" else K2_SEED_ARG
        if by_value:
            argtypes[at] = ctypes.c_uint
        fn = getattr(ctypes.CDLL(str(so)), f"mmfm_{lib}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[lib] = fn
    return fns


def _by_value(fn, at: int, seed: int):
    """``fn`` called with the key's value where the wrapper passes its
    pointer."""
    def call(*args):
        args = list(args)
        args[at] = seed & 0xFFFFFFFF if args[at] is not None else 0
        return fn(*args)
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_seed_read_variants: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", nvidia_smi=cs.nvidia_smi(),
         device=torch.cuda.get_device_name(0))
    started = {n: start_builds(n, e) for n, e in VARIANTS.items()}
    libs = {n: finish_builds(n, p, n == "by_value")
            for n, p in started.items()}
    seed = 7
    ops = {}
    for dtype in (torch.float32,):
        q, k, v, spec, H = cs.k1_inputs("encoder_eye_pad", dtype, B=cs.BIG_B)
        B, Tq, hidden = q.shape
        key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1],
                                            q.device)
        g = torch.randn(q.shape, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(3)).to(dtype)
        ops[dtype] = (q, k, v, key_pad, static, H,
                      1.0 / math.sqrt(hidden // H), g)
    originals = att._k1_lib, att._k2_lib
    times = {}
    try:
        order = list(libs)
        for sweep in (order, order[::-1]):
            for name in sweep:
                fwd, bwd = libs[name]["attention_fwd"], \
                    libs[name]["attention_bwd"]
                if name == "by_value":
                    fwd = _by_value(fwd, K1_SEED_ARG, seed)
                    bwd = _by_value(bwd, K2_SEED_ARG, seed)
                att._k1_lib = lambda head_dim=32, fn=fwd: fn
                att._k2_lib = lambda head_dim=32, fn=bwd: fn
                for dtype, (q, k, v, key_pad, static, H, scale, g) in \
                        ops.items():
                    out, lse = att.attention_fwd(q, k, v, key_pad, static,
                                                 H, scale, True, cs.DROPOUT,
                                                 seed)
                    if sweep is order:
                        grads = att.attention_bwd(q, k, v, key_pad, static,
                                                  g, lse, H, scale,
                                                  cs.DROPOUT, seed)
                        ref = att.attention_bwd_reference(
                            q, k, v, key_pad, static, g, lse, H, scale,
                            cs.DROPOUT, seed)
                        tol = 1e-5 if dtype == torch.float32 else 2e-2
                        k2_excess = max(cs._excess(a, b, tol) if tol > 1e-5
                                        else (a.float() - b.float()).abs()
                                        .max().item() - tol
                                        for a, b in zip(grads, ref))
                        gates = cs.k1_gates(q, k, v, key_pad, static, H,
                                            scale, out, lse, cs.DROPOUT,
                                            seed)
                        emit(phase="seed_variant_check", variant=name,
                             dtype=cs.dtype_name(dtype), k1_ok=gates["ok"],
                             k1_max_abs_err=gates["max_abs_err"],
                             k2_excess=k2_excess, k2_ok=k2_excess <= 0.0)
                        del grads, ref
                    times.setdefault((name, dtype, "k1"), []).append(
                        cs.cuda_time_ms(lambda: att.attention_fwd(
                            q, k, v, key_pad, static, H, scale, True,
                            cs.DROPOUT, seed)))
                    times.setdefault((name, dtype, "k2"), []).append(
                        cs.cuda_time_ms(lambda: att.attention_bwd(
                            q, k, v, key_pad, static, g, lse, H, scale,
                            cs.DROPOUT, seed)))
    finally:
        att._k1_lib, att._k2_lib = originals
    for (name, dtype, kernel), ms in times.items():
        emit(phase="seed_variant_time", variant=name, kernel=kernel,
             dtype=cs.dtype_name(dtype), batch=cs.BIG_B,
             dropout=cs.DROPOUT, ms_in_order_and_reversed=ms)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
