#!/usr/bin/env python3
"""A first chip call of a K1 library, on one NVIDIA GPU.

    python3 scripts/torch_k1_first_call.py [--dtype float32] [--head-dim 16,32,64]

Builds the K1 libraries of the head widths asked for (128 unless given:
``csrc/attention_fwd_d128.cu``; 16, 32, 64: ``attention_fwd_d16.cu``,
``attention_fwd.cu``, ``attention_fwd_d64.cu``) together and prints JSON
lines: each build's seconds, every kernel's ``ptxas`` registers and spills
and the SASS counts of each kernel (``torch_k2_variants.sass_counts``);
then, in a child process with a 240 s timeout (an mbarrier wait that never
completes spins forever), at each width the K1 in bf16 (``--dtype
float32``: the f32 one) at 2 heads against its plain version
(``chip_smoke.k1_gates``) at Tq x Tk from 1 x 1 to 520 x 520, dropout 0
and 0.4, with lse, a second launch bit-equal to the first; at the width
row's shape (256 // D heads, the encoder mask, T = 200) at B=16 and
B=256: that check, the K2 of the same dtype and width on this lse
(``chip_smoke.k2_gates``), the lse row sums (``chip_smoke.lse_row_sums``),
device ms kernel by kernel (dropout 0.4 with lse, 0 without) and SDPA's
forwards (bf16: memory-efficient and cuDNN; f32: memory-efficient and
MATH) with the same bias and dropout; last the keep bits read back (q = 0,
one-hot V). Without CUDA it exits non-zero.
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

SHAPES = ((1, 1), (17, 17), (64, 64), (65, 65), (128, 128), (129, 129),
          (200, 200), (207, 207), (208, 208), (209, 209), (256, 256),
          (257, 257), (520, 520), (200, 300), (300, 17), (1, 200), (200, 1))


def emit(**record):
    print(json.dumps(record), flush=True)


def library(D: int) -> str:
    """The K1 library of head width D."""
    return "attention_fwd" if D == 32 else f"attention_fwd_d{D}"


def widths(args) -> list:
    """The head widths of ``--head-dim`` (128 unless given)."""
    if "--head-dim" not in args:
        return [128]
    return [int(x) for x in args[args.index("--head-dim") + 1].split(",")]


def checks(dt, D: int) -> None:
    """The child process's checks and timings at head width D (module
    docstring)."""
    import chip_smoke as cs
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    H = 2
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(5)
    for tq, tk in SHAPES:
        for rate in (0.0, 0.4):
            q, k, v = (torch.randn(3, t, H * D, device="cuda",
                                   generator=gen).to(dt)
                       for t in (tq, tk, tk))
            rng = np.random.default_rng(tq + tk)
            pad = (rng.random((3, tk)) > 0.3).astype(np.int32)
            pad[0] = 1
            static = (rng.random((tq, tk)) > 0.8).astype(np.int32)
            key_pad = torch.from_numpy(pad).cuda()
            st = torch.from_numpy(static).cuda()
            out, lse = att.attention_fwd(q, k, v, key_pad, st, H, scale, True,
                                         rate, 9)
            again = att.attention_fwd(q, k, v, key_pad, st, H, scale, True,
                                      rate, 9)
            torch.cuda.synchronize()
            emit(phase="check", head_dim=D, tq=tq, tk=tk, rate=rate,
                 bit_equal=bool(torch.equal(out, again[0])
                                and torch.equal(lse, again[1])),
                 **cs.k1_gates(q, k, v, key_pad, st, H, scale, out, lse,
                               rate, 9))
    H = 256 // D
    for B in (cs.TRAIN_B, cs.BIG_B):
        q, k, v, spec, _ = cs.k1_inputs("encoder_eye_pad", dt, B=B, H=H, D=D)
        key_pad, st = att.spec_operands(spec, B, 200, 200, q.device)
        out, lse = att.attention_fwd(q, k, v, key_pad, st, H, scale, True,
                                     cs.DROPOUT, 7)
        torch.cuda.synchronize()
        emit(phase="check_width_row", head_dim=D, B=B,
             **cs.k1_gates(q, k, v, key_pad, st, H, scale, out, lse,
                           cs.DROPOUT, 7))
        g = torch.randn(q.shape, device="cuda", generator=gen).to(dt)
        grads = att.attention_bwd(q, k, v, key_pad, st, g, lse, H, scale,
                                  cs.DROPOUT, 7)
        torch.cuda.synchronize()
        k2 = cs.k2_gates(q, k, v, key_pad, st, g, lse, H, scale, grads,
                         cs.DROPOUT, 7)
        emit(phase="k2_on_this_lse", head_dim=D, B=B, ok=k2["ok"],
             err=k2.get("dq_dk_dv_max_abs_err"))
        _, lse0 = att.attention_fwd(q, k, v, key_pad, st, H, scale, True)
        emit(phase="lse_rows", head_dim=D, B=B,
             **cs.lse_row_sums(q, k, key_pad, st, H, scale, lse0))
        for rate, with_lse in ((cs.DROPOUT, True), (0.0, False)):
            by = cs.kernel_ms_by_name(lambda: att.attention_fwd(
                q, k, v, key_pad, st, H, scale, with_lse, rate, 7))
            emit(phase="time", head_dim=D, B=B, rate=rate,
                 with_lse=with_lse,
                 by_kernel=by, total=sum(by.values()))
        bias = att.mask_to_bias(st.bool()[None] | key_pad.bool()[:, None])
        bias = bias[:, None].to(dt)
        qh, kh, vh = (x.unflatten(-1, (H, D)).transpose(1, 2)
                      for x in (q, k, v))
        backends = (("EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
                    if dt == torch.bfloat16 else ("EFFICIENT_ATTENTION",
                                                  "MATH"))
        for backend in backends:
            try:
                ms = cs.device_ms(lambda: cs.sdpa(
                    qh, kh, vh, attn_mask=bias,
                    dropout_p=cs.DROPOUT, backend=backend))
            except RuntimeError as err:
                ms = f"refused: {str(err)[:200]}"
            emit(phase="time_sdpa", head_dim=D, B=B, backend=backend,
                 ms=ms)
    # the keep bits read back: q = 0, V one-hot a head over Tk = D keys
    B, T, H, seed = 3, 70, 2, 123456789
    q = torch.zeros(B, T, H * D, device="cuda", dtype=dt)
    v = torch.eye(D, device="cuda").repeat(1, H).expand(B, D, H * D)
    k = torch.zeros(B, D, H * D, device="cuda", dtype=dt)
    key_pad = torch.ones(B, D, dtype=torch.int32, device="cuda")
    st = torch.zeros(T, D, dtype=torch.int32, device="cuda")
    out, _ = att.attention_fwd(q, k, v.contiguous().to(dt), key_pad, st, H,
                               1.0, dropout_rate=cs.DROPOUT, seed=seed)
    got = out.float().reshape(B, T, H, D).transpose(1, 2) > 0
    want = att.philox_keep(seed, B, H, T, D, cs.DROPOUT, device="cuda")
    emit(phase="philox", head_dim=D, equal=bool(torch.equal(got, want)))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_first_call: CUDA is not available", file=sys.stderr)
        return 2
    dtype = torch.float32 if "float32" in sys.argv[1:] else torch.bfloat16
    dims = widths(sys.argv)
    if sys.argv[1:2] == ["--child"]:
        for D in dims:
            checks(dtype, D)
        return 0
    sys.path.insert(0, str(ROOT / "scripts"))
    from multi_modal_foundation_model_tpu_torch.ops import build
    from torch_k2_variants import sass_counts

    import chip_smoke as cs

    emit(phase="device", nvidia_smi=cs.nvidia_smi(),
         device=torch.cuda.get_device_name(0))
    names = [library(D) for D in dims]
    emit(phase="build", s=build.build(names))
    for log in (build.library_path(n).with_suffix(".log") for n in names):
        for entry, spill, used in re.findall(
                r"Compiling entry function '(\S+)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", log.read_text(), re.S):
            emit(phase="ptxas", entry=entry, spill_bytes=int(spill),
                 registers=int(used))
        emit(phase="sass", counts=sass_counts(log.with_suffix(".so")))
    try:
        child = subprocess.run([sys.executable, __file__, "--child",
                                str(dtype).split(".")[-1], "--head-dim",
                                ",".join(map(str, dims))],
                               timeout=240 * len(dims), capture_output=True,
                               text=True)
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
