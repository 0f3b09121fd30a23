#!/usr/bin/env python3
"""A first chip call of the bf16 K2 at head width 128, on one NVIDIA GPU.

    python3 scripts/torch_k2_first_call.py

Builds ``csrc/attention_bwd_d128.cu`` alone and prints JSON lines: the
build's seconds, every kernel's ``ptxas`` registers and spills and the
SASS counts of each kernel (``torch_k2_variants.sass_counts``); then, in a
child process with a 300 s timeout (an mbarrier wait that never completes
spins forever), the bf16 K2 at 2 heads of 128 on the bf16 K1's lse
against the bf16-dots plain version (``chip_smoke.k2_gates``) at Tq x Tk
from 1 x 1 to 520 x 520, dropout 0 and 0.4, a second launch bit-equal to
the first; at the width row's shape (the encoder mask, T = 200) at B=16
and B=256: that check, device ms kernel by kernel (dropout 0.4 and 0)
and SDPA's cuDNN and memory-efficient backward ((fwd + bwd) - fwd, the
same bias and dropout); last pass B's keep bits read back (q = k = v = 0,
g one-hot at one query). Without CUDA it exits non-zero.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H, D = 2, 128
SHAPES = ((1, 1), (17, 17), (63, 63), (64, 64), (65, 65), (200, 200),
          (208, 208), (209, 209), (256, 256), (520, 520), (200, 300),
          (300, 17), (1, 200), (200, 1))


def emit(**record):
    print(json.dumps(record), flush=True)


def sdpa_bwd_ms(cs, att, q, k, v, key_pad, st, g, backend: str) -> float:
    """SDPA's backward on ``backend`` by profiler device time: (fwd + bwd)
    - fwd, the additive bias of the masks and dropout 0.4."""
    bias = att.mask_to_bias(st.bool()[None] | key_pad.bool()[:, None])[
        :, None].to(q.dtype)
    qh, kh, vh = (x.detach().unflatten(-1, (H, D)).transpose(1, 2)
                  .requires_grad_(True) for x in (q, k, v))
    gh = g.unflatten(-1, (H, D)).transpose(1, 2)

    def fwd():
        return cs.sdpa(qh, kh, vh, attn_mask=bias, dropout_p=cs.DROPOUT,
                       backend=backend)

    both = cs.device_ms(lambda: torch.autograd.grad(fwd(), (qh, kh, vh), gh))
    return both - cs.device_ms(lambda: fwd().detach())


def checks() -> None:
    """The child process's checks and timings (module docstring)."""
    import chip_smoke as cs
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    dt = torch.bfloat16
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(5)
    for tq, tk in SHAPES:
        for rate in (0.0, 0.4):
            q = torch.randn(3, tq, H * D, device="cuda", generator=gen).to(dt)
            k = torch.randn(3, tk, H * D, device="cuda", generator=gen).to(dt)
            v = torch.randn(3, tk, H * D, device="cuda", generator=gen).to(dt)
            g = torch.randn(3, tq, H * D, device="cuda", generator=gen).to(dt)
            rng = np.random.default_rng(tq + tk)
            pad = (rng.random((3, tk)) > 0.3).astype(np.int32)
            pad[0] = 1
            static = (rng.random((tq, tk)) > 0.8).astype(np.int32)
            key_pad = torch.from_numpy(pad).cuda()
            st = torch.from_numpy(static).cuda()
            _, lse = att.attention_fwd(q, k, v, key_pad, st, H, scale, True,
                                       rate, 9)
            grads = att.attention_bwd(q, k, v, key_pad, st, g, lse, H, scale,
                                      rate, 9)
            again = att.attention_bwd(q, k, v, key_pad, st, g, lse, H, scale,
                                      rate, 9)
            torch.cuda.synchronize()
            emit(phase="check", tq=tq, tk=tk, rate=rate,
                 bit_equal=all(torch.equal(a, b)
                               for a, b in zip(grads, again)),
                 **cs.k2_gates(q, k, v, key_pad, st, g, lse, H, scale,
                               grads, rate, 9, f32_dots_gate=False))
    for B in (cs.TRAIN_B, cs.BIG_B):
        q, k, v, spec, _ = cs.k1_inputs("encoder_eye_pad", dt, B=B, H=H, D=D)
        key_pad, st = att.spec_operands(spec, B, 200, 200, q.device)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(dt)
        lse = {rate: att.attention_fwd(q, k, v, key_pad, st, H, scale, True,
                                       rate, 7)[1]
               for rate in (cs.DROPOUT, 0.0)}
        for rate in (cs.DROPOUT, 0.0):
            grads = att.attention_bwd(q, k, v, key_pad, st, g, lse[rate], H,
                                      scale, rate, 7)
            torch.cuda.synchronize()
            emit(phase="check_width_row", B=B, rate=rate,
                 **cs.k2_gates(q, k, v, key_pad, st, g, lse[rate], H, scale,
                               grads, rate, 7))
            del grads
            by = cs.kernel_ms_by_name(lambda rate=rate: att.attention_bwd(
                q, k, v, key_pad, st, g, lse[rate], H, scale, rate, 7))
            emit(phase="time", B=B, rate=rate, by_kernel=by,
                 total=sum(by.values()))
        for backend in ("CUDNN_ATTENTION", "EFFICIENT_ATTENTION"):
            try:
                ms = sdpa_bwd_ms(cs, att, q, k, v, key_pad, st, g, backend)
            except RuntimeError as err:
                ms = f"refused: {str(err)[:200]}"
            emit(phase="time_sdpa_bwd", B=B, backend=backend, ms=ms)
    # pass B's keep bits read back: q = k = 0 make every probability 1/Tk,
    # v = 0 and g one-hot at query q0 make dv[b, k, h, :] = ms(q0, k) / Tk
    B, T, q0, seed = 3, 200, 77, 987654321
    z = torch.zeros(B, T, H * D, device="cuda", dtype=dt)
    g = torch.zeros(B, T, H * D, device="cuda")
    g[:, q0] = 1.0
    key_pad = torch.ones(B, T, dtype=torch.int32, device="cuda")
    st = torch.zeros(T, T, dtype=torch.int32, device="cuda")
    _, lse = att.attention_fwd(z, z, z, key_pad, st, H, 1.0, True, cs.DROPOUT,
                               seed)
    _, _, dv = att.attention_bwd(z, z, z, key_pad, st, g.to(dt), lse, H, 1.0,
                                 cs.DROPOUT, seed)
    got = dv.float().reshape(B, T, H, D).transpose(1, 2) > 0
    keep = att.philox_keep(seed, B, H, T, T, cs.DROPOUT, device="cuda")
    emit(phase="keep_bits", equal=bool(torch.equal(
        got, keep[:, :, q0, :, None].expand_as(got))))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k2_first_call: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--child"]:
        checks()
        return 0
    sys.path.insert(0, str(ROOT / "scripts"))
    from multi_modal_foundation_model_tpu_torch.ops import build
    from torch_k2_variants import sass_counts

    emit(phase="build", s=build.build(["attention_bwd_d128"]))
    for log in build.BUILD_DIR.glob("libattention_bwd_d128*.log"):
        for entry, spill, used in re.findall(
                r"Compiling entry function '(\S+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", log.read_text(), re.S):
            emit(phase="ptxas", entry=entry, spill_bytes=int(spill),
                 registers=int(used))
        emit(phase="sass", counts=sass_counts(log.with_suffix(".so")))
    try:
        child = subprocess.run([sys.executable, __file__, "--child"],
                               timeout=300, capture_output=True, text=True)
    except subprocess.TimeoutExpired as err:
        out = err.stdout or b""
        print(out.decode() if isinstance(out, bytes) else out, end="",
              flush=True)
        emit(phase="checks", ok=False, why="the child timed out")
        return 1
    print(child.stdout, end="", flush=True)
    print(child.stderr[-6000:], file=sys.stderr)
    return child.returncode


if __name__ == "__main__":
    sys.exit(main())
