#!/usr/bin/env python3
"""How many kernels a short torch.profiler trace loses as a process ages.

    python3 scripts/torch_profiler_loss.py [--rounds 4] [--age-s 60]

On one card: 20 launches of the Philox byte draw (B=16's largest dropout,
16 x 200 x 256 bytes) traced with a plain ``torch.profiler.profile``, with
host sleep of 0.1 s before and after the launches inside the trace, and
through ``chip_smoke.traced`` (the lead-in of spin kernels), six traces of
each; then ``--age-s`` seconds of bf16 8192^2 GEMMs, and again, for
``--rounds`` rounds. One JSON line a round: the process's age, the kernels
each trace caught (of 20) and the lead-in kernels ``traced`` lost.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

REPS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profiler_loss: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--age-s", type=float, default=60.0)
    args = ap.parse_args()
    t0 = time.time()
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from multi_modal_foundation_model_tpu_torch.ops import build
    from multi_modal_foundation_model_tpu_torch.ops import random as rnd

    build.build(["random"])
    key = torch.tensor([2 ** 40 + 123], dtype=torch.int64, device="cuda")

    def fn():
        rnd.u8_bits(key[0:1], (16, 200, 256), 1)

    def caught(prof) -> int:
        return sum(1 for name, _ in cs._device_events(prof)
                   if "philox" in name)

    def plain(pad_s: float) -> int:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad_s)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        return caught(prof)

    def lead_in() -> int:
        """Kernels caught, or -1 where the trace lost its whole lead-in."""
        fn()
        try:
            with cs.traced() as prof:
                for _ in range(REPS):
                    fn()
        except cs.TraceLost:
            return -1
        return caught(prof)

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    print(cs.nvidia_smi(), flush=True)
    for r in range(args.rounds):
        if r:
            end = time.time() + args.age_s
            while time.time() < end:
                for _ in range(20):
                    a @ a
                torch.cuda.synchronize()
        n = len(cs.TRACE_LOSSES)
        row = dict(age_s=round(time.time() - t0, 1),
                   plain=[plain(0.0) for _ in range(6)],
                   plain_padded=[plain(0.1) for _ in range(6)],
                   traced=[lead_in() for _ in range(6)])
        row["traced_lead_in_lost"] = cs.TRACE_LOSSES[n:]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
