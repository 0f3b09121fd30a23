#!/usr/bin/env python3
"""Where the f32 K2's error against its plain version comes from, on one
NVIDIA GPU.

    python3 scripts/torch_k2_f32_accuracy.py      # from the repository root

At the inputs of ``chip_smoke.py``'s ``k2_check`` (B=256, T=200, 8 heads of
32, the three mask cases, dropout 0 and 0.4, on K1 f32's lse), the f32 K2
(``csrc/attention_bwd.cu``, 3xTF32, pn by ``ex2.approx``) is held against

- the f32 plain version (``attention_bwd_reference``, the smoke's
  yardstick at atol 1e-5) and an f64 evaluation of the same formula;
- the 3xTF32 emulation of ``tests/tf32_emulation.py`` (torch's exp);
- the same kernel built with pn = ``expf(s - lse)`` (the library's accurate
  exp, an edit of ``Tc<float>::prob`` into ``build/probe/k2_expf/``).

The plain version and the emulation are held against f64 as well. Then the
two builds are timed at the smoke's timing shape (encoder mask), in one
order and the reverse, each with CUDA events over 20 launches after 3
warm-ups. Prints JSON lines: the card, ``ptxas`` registers and spills,
one line of max-abs errors per case and dropout, then the timings.
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
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402  (the smoke run's inputs and timers)
import tf32_emulation as emu  # noqa: E402
from multi_modal_foundation_model_tpu_torch.ops import attention as att  # noqa: E402
from multi_modal_foundation_model_tpu_torch.ops import build  # noqa: E402

PROB = """  static __device__ __forceinline__ float prob(float s, float l) {
    return fast_exp2((s - l) * kLog2e);
  }"""
PROB_EXPF = PROB.replace("fast_exp2((s - l) * kLog2e)", "expf(s - l)")


def build_expf():
    """The f32 K2 with pn = expf(s - lse): (entry point, [(spill bytes,
    registers)] per kernel)."""
    out = ROOT / "build" / "probe" / "k2_expf"
    out.mkdir(parents=True, exist_ok=True)
    for src in build.CSRC.glob("*.cu*"):
        text = src.read_text()
        if src.name == "attention_bwd.cu":
            if text.count(PROB) != 1:
                raise RuntimeError("Tc<float>::prob is not as expected")
            text = text.replace(PROB, PROB_EXPF)
        (out / src.name).write_text(text)
    lib = out / "libattention_bwd.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / "attention_bwd.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(log)
    regs = [(int(a), int(b)) for a, b in re.findall(
        r"(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)]
    return ctypes.CDLL(str(lib)).mmfm_attention_bwd, regs


def _err(got, want) -> list:
    return [(a.double() - b.double()).abs().max().item()
            for a, b in zip(got, want)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k2_f32_accuracy: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(dict(nvidia_smi=chip_smoke.nvidia_smi())), flush=True)
    kernel = att._k2_lib()
    expf, regs = build_expf()
    expf.argtypes, expf.restype = kernel.argtypes, kernel.restype
    libs = {"ex2.approx": kernel, "expf": expf}
    print(json.dumps(dict(expf_ptxas_spill_bytes_registers=regs)), flush=True)
    original = att._k2_lib
    try:
        for case in ("encoder_eye_pad", "decoder_pad", "cross"):
            q, k, v, spec, H = chip_smoke.k1_inputs(case, torch.float32,
                                                    B=chip_smoke.BIG_B)
            B, Tq, hidden = q.shape
            key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1],
                                                q.device)
            scale = 1.0 / math.sqrt(hidden // H)
            g = torch.randn(q.shape, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(2))
            for rate in (0.0, chip_smoke.DROPOUT):
                _, lse = att.attention_fwd(q, k, v, key_pad, static, H,
                                           scale, True, rate, 1234)
                args = (q, k, v, key_pad, static, g, lse, H, scale, rate,
                        1234)
                plain = att.attention_bwd_reference(*args)
                f64 = emu.k2(*args, dot=torch.matmul, dtype=torch.float64)
                emulated = emu.k2(*args)
                row = dict(case=case, dropout=rate, shape=[B, Tq, hidden],
                           plain_vs_f64=_err(plain, f64),
                           emulation_vs_plain=_err(emulated, plain),
                           emulation_vs_f64=_err(emulated, f64))
                for name, fn in libs.items():
                    att._k2_lib = lambda fn=fn: fn
                    got = att.attention_bwd(*args)
                    row[name] = dict(vs_plain=_err(got, plain),
                                     vs_f64=_err(got, f64),
                                     vs_emulation=_err(got, emulated))
                    del got
                att._k2_lib = original
                print(json.dumps(row), flush=True)
                del plain, f64, emulated
                torch.cuda.empty_cache()

        q, k, v, spec, H = chip_smoke.k1_inputs("encoder_eye_pad",
                                                torch.float32,
                                                B=chip_smoke.BIG_B)
        B, Tq, hidden = q.shape
        key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1], q.device)
        scale = 1.0 / math.sqrt(hidden // H)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
        rates = (chip_smoke.DROPOUT, 0.0)
        lse = {r: att.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                                    r, 1234)[1] for r in rates}
        for name in [*libs, *reversed(libs)]:
            att._k2_lib = lambda fn=libs[name]: fn
            for rate in rates:
                ms = chip_smoke.cuda_time_ms(lambda: att.attention_bwd(
                    q, k, v, key_pad, static, g, lse[rate], H, scale, rate,
                    1234))
                print(json.dumps(dict(exp=name, dropout=rate, ms=ms,
                                      shape=[B, Tq, Tq, H, hidden // H])),
                      flush=True)
    finally:
        att._k2_lib = original
    return 0


if __name__ == "__main__":
    sys.exit(main())
