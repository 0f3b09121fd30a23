#!/usr/bin/env python3
"""Where the f32 K2's error against its plain version comes from, on one
NVIDIA GPU.

    python3 scripts/torch_k2_f32_accuracy.py      # from the repository root

At the inputs of ``chip_smoke.py``'s ``k2_check`` (B=256, T=200, 8 heads of
32, the three mask cases, dropout 0 and 0.4, on K1 f32's lse), the f32 K2
(at head width 32 the wgmma kernel of ``csrc/attention_bwd_f32.cuh``,
3xTF32, pn by ``ex2.approx``), and at the same inputs with 2 heads of 128
the kernel of ``csrc/attention_bwd_f32_d128.cuh``, is held against

- the f32 plain version (``attention_bwd_reference``, the smoke's
  yardstick at atol 1e-5) and an f64 evaluation of the same formula;
- the 3xTF32 emulation of ``tests/tf32_emulation.py`` in the kernel's sum
  order (torch's exp; ``wgmma_dots``), and in the mma.sync kernels' order
  (``emulation_mma_sync_*``);
- the same kernel built with pn = ``expf(s - lse)`` (the library's accurate
  exp, an edit of the two exponentials of its source into
  ``build/probe/k2_expf_<library>/``).

The plain version and the emulations are held against f64 as well. Then the
two builds are timed at the smoke's timing shape (encoder mask), in one
order and the reverse, each with CUDA events over 20 launches after 3
warm-ups. Prints JSON lines: the card, ``ptxas`` registers and spills,
one line of max-abs errors per head width, case and dropout, then the
timings.
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

# the exponentials of pass A and pass B, and their expf edits
PROBS = (("fast_exp2((s[i] - lse[hh]) * kLog2e)", "expf(s[i] - lse[hh])"),
         ("fast_exp2((s[i] - l) * kLog2e)", "expf(s[i] - l)"))
# (head width, library, the f32 kernel's source)
WIDTHS = ((32, "attention_bwd", "attention_bwd_f32.cuh"),
          (128, "attention_bwd_d128", "attention_bwd_f32_d128.cuh"))


def build_expf(library: str, source: str):
    """The f32 K2 of ``library`` with pn = expf(s - lse) in ``source``:
    (entry point, [(spill bytes, registers)] per kernel)."""
    out = ROOT / "build" / "probe" / f"k2_expf_{library}"
    out.mkdir(parents=True, exist_ok=True)
    for src in build.CSRC.glob("*.cu*"):
        text = src.read_text()
        if src.name == source:
            for old, new in PROBS:
                if text.count(old) != 1:
                    raise RuntimeError(f"{old} is not as expected")
                text = text.replace(old, new)
        (out / src.name).write_text(text)
    lib = out / f"lib{library}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / f"{library}.cu")],
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
    original = att._k2_lib
    try:
        for D, library, source in WIDTHS:
            accuracy(D, library, source)
    finally:
        att._k2_lib = original
    return 0


def accuracy(D: int, library: str, source: str) -> None:
    """The lines of one head width (module docstring), 256 // D heads."""
    kernel = att._k2_lib(D)
    expf, regs = build_expf(library, source)
    expf.argtypes, expf.restype = kernel.argtypes, kernel.restype
    libs = {"ex2.approx": kernel, "expf": expf}
    print(json.dumps(dict(head_dim=D,
                          expf_ptxas_spill_bytes_registers=regs)),
          flush=True)
    original = att._k2_lib
    try:
        for case in ("encoder_eye_pad", "decoder_pad", "cross"):
            q, k, v, spec, H = chip_smoke.k1_inputs(case, torch.float32,
                                                    B=chip_smoke.BIG_B,
                                                    H=256 // D, D=D)
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
                emulated = emu.k2(*args, out_dots=emu.wgmma_dots(hidden // H))
                mma_sync = emu.k2(*args)
                row = dict(head_dim=D, case=case, dropout=rate,
                           shape=[B, Tq, hidden],
                           plain_vs_f64=_err(plain, f64),
                           emulation_vs_plain=_err(emulated, plain),
                           emulation_vs_f64=_err(emulated, f64),
                           emulation_mma_sync_vs_plain=_err(mma_sync, plain),
                           emulation_mma_sync_vs_f64=_err(mma_sync, f64))
                del mma_sync
                for name, fn in libs.items():
                    att._k2_lib = lambda head_dim=D, fn=fn: fn
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
                                                B=chip_smoke.BIG_B,
                                                H=256 // D, D=D)
        B, Tq, hidden = q.shape
        key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1], q.device)
        scale = 1.0 / math.sqrt(hidden // H)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
        rates = (chip_smoke.DROPOUT, 0.0)
        lse = {r: att.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                                    r, 1234)[1] for r in rates}
        for name in [*libs, *reversed(libs)]:
            att._k2_lib = lambda head_dim=D, fn=libs[name]: fn
            for rate in rates:
                ms = chip_smoke.cuda_time_ms(lambda: att.attention_bwd(
                    q, k, v, key_pad, static, g, lse[rate], H, scale, rate,
                    1234))
                print(json.dumps(dict(head_dim=D, exp=name, dropout=rate,
                                      ms=ms,
                                      shape=[B, Tq, Tq, H, hidden // H])),
                      flush=True)
    finally:
        att._k2_lib = original
    del q, k, v, g, lse
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
