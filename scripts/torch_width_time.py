#!/usr/bin/env python3
"""K1-K4 at every width the JAX package runs, timed on one NVIDIA GPU.

    python3 scripts/torch_width_time.py [--parent OTHER_CHECKOUT]
    python3 scripts/torch_width_time.py --d32-b256

Builds the port's kernels, then prints JSON lines:

- ``width_attention``: K1 (dropout 0.4, lse) and K2 at head widths 32 (the
  reference), 8, 16, 24, 64 and 128, B=16, 200 tokens, 256 // D heads, the
  encoder's mask, f32 and bf16 (``chip_smoke.head_width_kernels``'s
  inputs), each timed by profiler device time (the kernels a call
  launches, pad and slice copies included) beside its plain version and
  bounded by its bytes and operations (``chip_smoke.attn_train_times``),
  and beside ``F.scaled_dot_product_attention`` with the same additive
  bias and dropout pinned to each backend in turn: a backend that refuses
  the call is named with its error.
- ``width_layernorm``: K3 and K4 at 3,200 rows (the B=16 step's tokens) of
  256 (the reference), 48, 100, 1280, 2048 and 4096 columns, f32 and bf16,
  by profiler device time beside their plain versions, ``F.layer_norm``
  and ``aten.native_layer_norm_backward``, with their bounds
  (``chip_smoke.ln_time``) and ``ops.layernorm.ln_plan``'s layout.
- with ``--parent`` (another checkout, say the parent commit's unpacked by
  ``git archive``): ``ptxas_compare``, the registers, spills, stack and
  static shared memory of every kernel both checkouts build (the
  attention kernels at head width 32, the LayerNorm kernels at the
  layouts the parent had), read from both build logs, and ``width_side``
  lines: K1 (eval, B=320; training, B=256) and K2 (B=256) at head width
  32 and K3/K4 at 51,200 and 3,200 x 256, the smoke's shapes, timed in
  six processes in the order other, this, this, other, other, this, each
  importing its own checkout's package and building its kernels.

With ``--d32-b256`` it prints only ``d32_b256`` lines: K1 (dropout 0.4,
lse) and K2 at head width 32 and the smoke's B=256 training shape (256 x
200 tokens, 8 heads, the encoder's mask, ``chip_smoke.k1_inputs``'s seed;
the shape of PERF.md's D=32 rows), f32 and bf16, by profiler device time
and by CUDA events (the smoke's ``cuda_time_ms``), beside SDPA pinned to
each backend in turn with the same bias and dropout (``sdpa_by_backend``,
profiler device time), each backend's refusal named.

The second-to-last line is ``nvidia-smi``'s name and power limit. Without
CUDA it exits non-zero.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (inputs, gates, timers, bounds)

SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "FLASH_ATTENTION",
                 "MATH")
LN_ROWS = cs.HW_LN_ROWS


def device_timer(fn, reps: int = 20, warmup: int = 3) -> float:
    """Profiler device ms of every kernel a call of ``fn`` launches
    (``chip_smoke.device_ms``): at B=16 a wrapper's host path takes about
    as long as its kernel, so CUDA events would time the host."""
    return cs.device_ms(fn, reps)


def sdpa_by_backend(q, k, v, key_pad, static, g, H) -> dict:
    """SDPA's forward and backward ms (CUDA events) on head views of the
    operands, the additive bias of the mask and dropout 0.4, pinned to each
    backend; a backend that refuses the call gets its error."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    D = q.shape[-1] // H
    bias = att.mask_to_bias(static.bool()[None]
                            | key_pad.bool()[:, None])[:, None].to(q.dtype)
    qh, kh, vh = (x.detach().unflatten(-1, (H, D)).transpose(1, 2)
                  .requires_grad_(True) for x in (q, k, v))
    gh = g.unflatten(-1, (H, D)).transpose(1, 2)
    out = {}
    for name in SDPA_BACKENDS:
        def call():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=bias, dropout_p=cs.DROPOUT)

        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                fwd = device_timer(lambda: call().detach())
                both = device_timer(lambda: torch.autograd.grad(
                    call(), (qh, kh, vh), gh))
            out[name] = dict(fwd_ms=fwd, bwd_ms=both - fwd,
                             fwd_bwd_ms=both)
        except RuntimeError as err:
            out[name] = dict(refused=str(err).splitlines()[0][:200])
    return out


def attention_widths() -> None:
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    for D in (32, *cs.HW_WIDTHS):
        H = cs.GEOMETRY["hidden_size"] // D
        for dtype in cs.DTYPES:
            q, k, v, spec, _ = cs.k1_inputs("encoder_eye_pad", dtype,
                                            B=cs.TRAIN_B, T=200, H=H, D=D,
                                            seed=D)
            key_pad, static = att.spec_operands(spec, q.shape[0],
                                                q.shape[1], k.shape[1],
                                                q.device)
            g = torch.randn(q.shape, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(D)).to(dtype)
            k1, k2 = cs.attn_train_times(q, k, v, key_pad, static, g, H,
                                         timer=device_timer)
            cs.emit(phase="width_attention", head_width=D, heads=H,
                    compiled_width=att.kernel_head_dim(D),
                    dtype=cs.dtype_name(dtype),
                    shape=[q.shape[0], q.shape[1], k.shape[1], H, D],
                    dropout=cs.DROPOUT, k1=k1, k2=k2,
                    sdpa=sdpa_by_backend(q, k, v, key_pad, static, g, H))


def d32_b256_backends() -> None:
    """The ``d32_b256`` lines (module docstring)."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    for dtype in cs.DTYPES:
        q, k, v, spec, H = cs.k1_inputs("encoder_eye_pad", dtype,
                                        B=cs.BIG_B)
        key_pad, static = att.spec_operands(spec, q.shape[0], q.shape[1],
                                            k.shape[1], q.device)
        g = torch.randn(q.shape, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(3)).to(dtype)
        by_timer = {name: cs.attn_train_times(q, k, v, key_pad, static, g,
                                              H, timer=timer)
                    for name, timer in (("device", device_timer),
                                        ("events", cs.cuda_time_ms))}
        cs.emit(phase="d32_b256", dtype=cs.dtype_name(dtype),
                shape=[q.shape[0], q.shape[1], k.shape[1], H,
                       q.shape[-1] // H], dropout=cs.DROPOUT,
                k1={t: r[0] for t, r in by_timer.items()},
                k2={t: r[1] for t, r in by_timer.items()},
                sdpa=sdpa_by_backend(q, k, v, key_pad, static, g, H))


def layernorm_widths() -> None:
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    for width in (256, *cs.HW_LN_WIDTHS):
        for dtype in cs.DTYPES:
            t = cs.ln_time(LN_ROWS, width, dtype)
            cs.emit(phase="width_layernorm", shape=[LN_ROWS, width],
                    dtype=cs.dtype_name(dtype),
                    plan=ln.ln_plan(width, dtype)._asdict(),
                    device_ms=t["dev"], k4_by_kernel_ms=t["k4_by_kernel_ms"],
                    k3_bound=t["k3_bound"], k4_bound=t["k4_bound"],
                    k3_share_of_bound=t["k3_share_of_bound"],
                    k4_share_of_bound=t["k4_share_of_bound"])


# ---------------------------------------------------------------------------
# against another checkout
# ---------------------------------------------------------------------------

def _template_args(s: str, i: int) -> tuple:
    """The template arguments of an Itanium-mangled name from s[i] = 'I':
    a builtin type letter, a length-prefixed name, or a literal (Lb1E,
    Li32E)."""
    i += 1
    args = []
    while s[i] != "E":
        if s[i] == "L":
            j = s.index("E", i)
            args.append(s[i + 1:j])
            i = j + 1
        elif s[i].isdigit():
            n = re.match(r"\d+", s[i:]).group(0)
            args.append(s[i + len(n):i + len(n) + int(n)])
            i += len(n) + int(n)
        else:
            args.append(s[i])
            i += 1
    return tuple(args)


def kernel_key(mangled: str) -> tuple:
    """(kernel, template arguments) of a ptxas entry (an Itanium-mangled
    name nested in the file's anonymous namespace), with the parameters
    added by head-width and vector-width support dropped where they take
    the value the kernels had before: head width 32 (``Li32E``), and a
    LayerNorm vector width equal to min(values a lane, 16 bytes)."""
    i, names = 3, []                       # after "_ZN": <len><name>...
    while mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group(0)
        i += len(n)
        names.append(mangled[i:i + int(n)])
        i += int(n)
    name = names[-1]
    args = _template_args(mangled, i) if mangled[i] == "I" else ()
    if name.startswith("attn_") and len(args) == 3 and args[2] == "i32":
        args = args[:2]
    if name in ("ln_fwd_kernel", "ln_bwd_dx_kernel") and len(args) == 3:
        elem = 4 if args[0] == "f" else 2
        epl, vec = int(args[1][1:]), int(args[2][1:])
        if vec == min(epl, 16 // elem):
            args = args[:2]
    return name, args


def ptxas_entries(log: str) -> dict:
    """{kernel key: registers, spills, stack and static shared memory} of a
    build log's ``ptxas -v`` lines."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        entry = block.split("'", 1)[0]
        used = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out[kernel_key(entry)] = dict(
            registers=int(used.group(1)), stack_bytes=int(frame.group(1)),
            spill_stores=int(frame.group(2)), spill_loads=int(frame.group(3)),
            static_smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def _logs(checkout: Path, names) -> dict:
    build_dir = checkout / "build" / "torch_kernels"
    found = {}
    for name in names:
        logs = sorted(build_dir.glob(f"lib{name}-*.log"),
                      key=lambda p: p.stat().st_mtime)
        if logs:
            found.update(ptxas_entries(logs[-1].read_text()))
    return found


def ptxas_compare(parent: Path) -> bool:
    """Every kernel the parent builds against this checkout's build of it:
    equal registers, spills, stack and static shared memory."""
    names = ("attention_fwd", "attention_bwd", "layernorm", "random",
             "session_rows")
    mine, theirs = _logs(ROOT, names), _logs(parent, names)
    rows, same = [], True
    for key, want in sorted(theirs.items(), key=str):
        got = mine.get(key)
        equal = got == want
        same = same and equal
        rows.append(dict(kernel=key[0], args=list(key[1]), parent=want,
                         this=got, equal=equal))
    cs.emit(phase="ptxas_compare", kernels=rows, all_equal=same,
            compared=len(rows), parent_entries=len(theirs),
            this_entries=len(mine))
    return same


def side_worker(side: str) -> None:
    """In a process whose package is the checkout's: K1 (eval B=320,
    training B=256) and K2 (B=256) at head width 32 and K3/K4 at 51,200 and
    3,200 x 256, the smoke's shapes."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att
    from multi_modal_foundation_model_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(build.kernel_sources())
    for dtype in cs.DTYPES:
        q, k, v, spec, H = cs.k1_inputs("encoder_eye_pad", dtype)
        key_pad, static = att.spec_operands(spec, *q.shape[:2], k.shape[1],
                                            q.device)
        eval_ms = cs.cuda_time_ms(lambda: att.attention_fwd(
            q, k, v, key_pad, static, H, 32 ** -0.5))
        q, k, v, spec, H = cs.k1_inputs("encoder_eye_pad", dtype, B=cs.BIG_B)
        key_pad, static = att.spec_operands(spec, *q.shape[:2], k.shape[1],
                                            q.device)
        g = torch.randn(q.shape, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(3)).to(dtype)
        k1, k2 = cs.attn_train_times(q, k, v, key_pad, static, g, H)
        ln_ms = {rows: cs.ln_time(rows, 256, dtype)["dev"]
                 for rows in (cs.BIG_B * 200, cs.TRAIN_B * 200)}
        cs.emit(phase="width_side", side=side, dtype=cs.dtype_name(dtype),
                k1_eval_ms=eval_ms, k1_train_ms=k1["ms"], k2_ms=k2["ms"],
                k3_k4_device_ms={str(r): {"k3": t["k3"], "k4": t["k4"]}
                                 for r, t in ln_ms.items()})


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--side-worker"]:
        sys.path.insert(0, args[1])
        side_worker(args[2])
        return 0
    if not torch.cuda.is_available():
        print("torch_width_time: CUDA is not available", file=sys.stderr)
        return 2
    from multi_modal_foundation_model_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    cs.emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
            device=torch.cuda.get_device_name(0),
            build_s=build.build(build.kernel_sources()))
    if "--d32-b256" in args:
        d32_b256_backends()
        print(smi, flush=True)
        cs.emit(ok=True, device=torch.cuda.get_device_name(0))
        return 0
    attention_widths()
    layernorm_widths()
    ok = True
    if "--parent" in args:
        parent = Path(args[args.index("--parent") + 1]).resolve()
        for side, where in (("other", parent), ("this", ROOT),
                            ("this", ROOT), ("other", parent),
                            ("other", parent), ("this", ROOT)):
            run = subprocess.run([sys.executable, __file__, "--side-worker",
                                  str(where), side], capture_output=True,
                                 text=True, timeout=900)
            sys.stdout.write(run.stdout)
            if run.returncode != 0:
                sys.stderr.write(run.stderr)
                return run.returncode
        ok = ptxas_compare(parent)
    print(smi, flush=True)
    cs.emit(ok=ok, device=torch.cuda.get_device_name(0))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
