#!/usr/bin/env python3
"""Time the port's multi-session graph steps on one card.

    python3 scripts/torch_multisession_time.py

Builds the port's kernels (TF32 off, as ``chip_smoke.py`` does) and runs
``chip_smoke.multisession_time`` over ``chip_smoke``'s ten full-width
synthetic sessions (668-1001 neurons, 400 trials each, N_max 1024): the
single-session, multi-session and session-mixed graph steps at B=16 and
B=256, interleaved, f32 under the port's default LayerNorm mode and bf16
under ``"full"``, with profiles, capture seconds and peak memory. It
prints ``chip_smoke``'s ``multisession_time``, ``multisession_mixed_time``
and ``multisession_profile`` lines, then the ``nvidia-smi`` reading and
the wall time. The numbers need no gate: ``chip_smoke.py`` checks these
paths (``multisession``, ``multisession_mixed``) and no longer times them.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from multi_modal_foundation_model_tpu_torch.ops import build
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = build.build(build.kernel_sources())
    loaders = cs.ms_loaders(cs.ms_sessions())
    out = ROOT / "build"
    t_time = time.perf_counter()
    cs.multisession_time(out, loaders, torch.float32, ln.PALLAS_LAYERNORM)
    cs.multisession_time(out, loaders, torch.bfloat16, "full")
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps(dict(phase="multisession_time_wall",
                          total_s=time.perf_counter() - t_time,
                          build_s=build_s,
                          wall_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
