#!/usr/bin/env python3
"""Time the port's single-session training steps on one card.

    python3 scripts/torch_step_time.py [--dispatch]
    python3 scripts/torch_step_time.py --dispatch --dtype float32 --heads 2 [--parent OTHER_CHECKOUT]

Builds the port's kernels (TF32 off, as ``chip_smoke.py`` does) and runs
the step timings that ``chip_smoke.py`` checks the paths of but no longer
times: ``chip_smoke.host_split_worker`` (the eager B=16 step's host time
by kind, with and without remat, f32 and bf16), ``chip_smoke.dispatch_time``
(the eager host-batch step against the
CUDA-graph step at B=16 and B=256, f32 under the port's default LayerNorm
mode and bf16 under ``"full"``, interleaved, with profiles, capture seconds
and peak memory), ``chip_smoke.plain_step_time`` (the plain path's f32
step at B=16 and B=256) and ``chip_smoke.layernorm_ab`` (kernel-path
steps under ``"off"``, ``"bwd"`` and ``"full"`` interleaved, f32 and bf16,
B=16 and B=256, with profiles), then the ``layernorm_default`` line (the
mode the A/B rule picks at B=256 beside the default in the code), the
``nvidia-smi`` reading and the wall time. The full-width model is
``chip_smoke``'s (N=668 + 2, T=100, H=256, 8 heads, 5+5 layers). With
``--dispatch`` it runs ``chip_smoke.dispatch_time`` alone (f32 and bf16,
B=16 and B=256, eager and graph steps with their profiles); ``--dtype``
keeps one dtype, ``--heads N`` gives the model N heads (2: head width 128,
the mm.yaml model with 2 heads). With ``--parent`` the timings run in four
processes, the other checkout's (say the parent commit's, unpacked by
``git archive``), this one's, this one's, the other's, each importing its
own checkout's ``chip_smoke`` and package and building its kernels; a
``step_time_side`` line opens each process's lines.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _opt(args, name, default=None):
    return args[args.index(name) + 1] if name in args else default


def run(checkout: Path, args) -> None:
    """The timings of ``args`` with ``checkout``'s chip_smoke and package."""
    sys.path.insert(0, str(checkout))
    import chip_smoke as cs
    from multi_modal_foundation_model_tpu_torch.ops import build
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = build.build(build.kernel_sources())
    out = checkout / "build"
    default = ln.PALLAS_LAYERNORM
    heads = _opt(args, "--heads")
    if heads is not None:
        cfg = cs._cfg

        def with_heads(dtype, **over):
            return dataclasses.replace(cfg(dtype, **over), n_heads=int(heads))

        cs._cfg = with_heads
    dtypes = [d for d in cs.DTYPES
              if _opt(args, "--dtype", cs.dtype_name(d)) == cs.dtype_name(d)]
    t_time = time.perf_counter()
    only_dispatch = "--dispatch" in args
    if not only_dispatch:
        cs.host_split_worker("this", out)
    for dtype in dtypes:
        cs.dispatch_time(out, dtype, default if dtype == torch.float32
                         else "full")
    if not only_dispatch:
        cs.plain_step_time(out)
        picks = {cs.dtype_name(dt): cs.layernorm_ab(out, dt)
                 for dt in cs.DTYPES}
        cs.emit(phase="layernorm_default", rule_pick_at_b256=picks,
                default_in_code=default)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps(dict(phase="step_time_wall",
                          total_s=time.perf_counter() - t_time,
                          build_s=build_s,
                          wall_s=time.perf_counter() - t0)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--side-worker"]:
        print(json.dumps(dict(phase="step_time_side", side=args[2],
                              checkout=args[1])), flush=True)
        run(Path(args[1]), args[3:])
        return 0
    parent = _opt(args, "--parent")
    if parent is None:
        run(ROOT, args)
        return 0
    rest = [a for i, a in enumerate(args)
            if a != "--parent" and (i == 0 or args[i - 1] != "--parent")]
    sides = (("parent", Path(parent).resolve()), ("this", ROOT),
             ("this", ROOT), ("parent", Path(parent).resolve()))
    for label, checkout in sides:
        proc = subprocess.run([sys.executable, __file__, "--side-worker",
                               str(checkout), label, *rest])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
