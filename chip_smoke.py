#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — ``nvidia-smi`` name and power limit, torch/CUDA versions,
   TF32 off, every CUDA kernel of the port built from ``csrc/``.
2. kernels — each kernel against its plain PyTorch version at the shapes
   the main path gives it (f32 atol 1e-5, bf16 atol 2e-2, ``lse`` too),
   timed beside the plain version, the one library call that computes the
   same function, and the bound the card could reach.
3. eval    — the main path: ``co_smoothing_eval`` in all six modes on a
   full-width ``MultiModal`` (N=668 + 2 behavior, T=100, H=256, 8 heads,
   5+5 layers, random weights from a seed) over the port's synthetic test
   split, with the kernel launch counts read around it; then one
   full-test-set forward through the kernel path and the plain path.

The second-to-last line repeats the ``nvidia-smi`` reading; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
The port never imports JAX, and neither does this script.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# the main path: the reference model at full width
GEOMETRY = dict(n_channels={"ap": 668, "behavior": 2}, max_F=100,
                hidden_size=256, n_heads=8, n_enc_layers=5, n_dec_layers=5,
                inter_size=512, act="gelu")
N_TRIALS, SEED, CHUNK = 200, 0, 16
K1_ATTN_PER_FORWARD = 15          # 5 encoder self, 5 decoder self, 5 cross


def emit(**record):
    print(json.dumps(record), flush=True)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(fn, top: int = 6) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler, CUPTI
    tracing), grouped as K1 / GEMM / other, beside the host wall time of
    the same profiled call (so the idle share includes profiler cost)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    groups = {"k1_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("k1_ms" if "attn_fwd_kernel" in low else
               "gemm_ms" if any(s in low for s in ("gemm", "cutlass", "sm90_",
                                                    "ampere_", "xmma"))
               else "other_ms")
        groups[key] += ms
    busy = sum(by_name.values())
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=(1.0 - busy / wall_ms) if busy else None,
                **groups, top_kernels_ms=[
                    [n[:90], ms] for n, ms in sorted(
                        by_name.items(), key=lambda kv: -kv[1])[:top]])


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_inputs(case: str, dtype, B=320, T=200, H=8, D=32, seed=1):
    """q/k/v as the model gives them (column views of a fused QKV or KV
    product) and the MaskSpec of the case."""
    from multi_modal_foundation_model_tpu_torch.ops.attention import MaskSpec

    g = torch.Generator(device="cuda").manual_seed(seed)
    hidden = H * D
    pad = torch.ones(B, T, dtype=torch.int32, device="cuda")
    pad[::7, T - 40:] = 0                   # trials with padded keys
    if case == "cross":
        q = torch.randn(B, T, hidden, device="cuda", generator=g).to(dtype)
        kv = torch.randn(B, T, 2 * hidden, device="cuda",
                         generator=g).to(dtype)
        k, v = kv.split(hidden, dim=-1)
    else:
        qkv = torch.randn(B, T, 3 * hidden, device="cuda",
                          generator=g).to(dtype)
        q, k, v = qkv.split(hidden, dim=-1)
    if case == "decoder_pad":
        pad[3] = 0                          # a padded trial: masked rows
        return q, k, v, MaskSpec(key_pad=pad, static=None), H
    eye = torch.eye(T, dtype=torch.int32, device="cuda")
    return q, k, v, MaskSpec(key_pad=pad, static=eye), H


def k1_phase():
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    worst = 0.0
    for case in ("encoder_eye_pad", "decoder_pad", "cross"):
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            q, k, v, spec, H = k1_inputs(case, dtype)
            B, Tq, hidden = q.shape
            key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1],
                                                q.device)
            scale = 1.0 / math.sqrt(hidden // H)
            out, lse = att.attention_fwd(q, k, v, key_pad, static, H, scale,
                                         with_lse=True)
            torch.cuda.synchronize()
            ref, ref_lse = att.attention_reference(q, k, v, key_pad, static,
                                                   H, scale, with_lse=True)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = (err <= atol and lse_err <= 1e-5
                  and bool(torch.isfinite(out).all()))
            emit(phase="k1_check", case=case, dtype=str(dtype), shape=[
                B, Tq, hidden], heads=H, max_abs_err=err,
                lse_max_abs_err=lse_err, atol=atol, ok=ok)
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"({case}, {dtype}): {err}, {lse_err}")
            if dtype == torch.float32:
                worst = max(worst, err)

    # timing at the encoder shape, f32 (the main path's type)
    q, k, v, spec, H = k1_inputs("encoder_eye_pad", torch.float32)
    B, Tq, hidden = q.shape
    Tk, D = k.shape[1], hidden // H
    key_pad, static = att.spec_operands(spec, B, Tq, Tk, q.device)
    scale = 1.0 / math.sqrt(D)
    ms = cuda_time_ms(lambda: att.attention_fwd(q, k, v, key_pad, static, H,
                                                scale))
    plain_ms = cuda_time_ms(lambda: att.attention_reference(
        q, k, v, key_pad, static, H, scale))
    # library yardstick (never called by the port): SDPA on head views
    # with the same additive bias
    bias = att.mask_to_bias(static.bool()[None] | key_pad.bool()[:, None])
    bias = bias[:, None]
    qh, kh, vh = (x.unflatten(-1, (H, D)).transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=bias))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    bf16_ms = cuda_time_ms(lambda: att.attention_fwd(qb, kb, vb, key_pad,
                                                     static, H, scale))
    # least time for the same work: each input read once, the output
    # written once; the two products' flops at the f32 CUDA-core peak
    elem = q.element_size()
    bytes_moved = ((2 * B * Tq + 2 * B * Tk) * hidden * elem
                   + key_pad.numel() * 4 + static.numel() * 4)
    flops = 4 * B * H * Tq * Tk * D
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    emit(phase="k1_time", shape=[B, Tq, Tk, H, D], dtype="float32", ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bf16_ms=bf16_ms,
         bytes=bytes_moved, flops=flops, bound_bytes_ms=t_bytes,
         bound_ops_ms=t_ops)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def eval_phase(save_root: Path):
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import (
        EvalForward, co_smoothing_eval)
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModal, MultiModalConfig)
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    cfg = MultiModalConfig(**GEOMETRY)
    T, N = cfg.max_F, cfg.n_channels["ap"]
    model = MultiModal(cfg, generator=torch.Generator().manual_seed(SEED))
    splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                              n_timesteps=T)
    loader = make_loader(splits.test, batch_size=splits.test.n_trials,
                         max_time_length=T, max_space_length=N)
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(
        0, forwards[0] + 1))

    modes = [("per_neuron", None), ("forward_pred", list(range(70, T))),
             ("inter_region", None), ("intra_region", None),
             ("modal_spike", list(range(T))),
             ("modal_behavior", list(range(T)))]
    att.K1_LAUNCHES = 0
    forwards[0] = 0
    t_all = time.perf_counter()
    for mode, held in modes:
        f0, k0 = forwards[0], att.K1_LAUNCHES
        t0 = time.perf_counter()
        res = co_smoothing_eval(model, loader, mode, use_mtm=True,
                                chunk=CHUNK, n_time_steps=T,
                                held_out_list=held,
                                save_path=str(save_root / mode))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        metrics = (res[f"{mode}_behav_results"] if mode == "modal_behavior"
                   else res)
        finite = all(math.isfinite(x) for x in metrics.values())
        if mode != "modal_behavior":
            bps = np.load(save_root / mode / "bps.npy")
            r2 = np.load(save_root / mode / "r2.npy")
            finite = bool(finite and bps.shape == (N,)
                          and r2.shape == (N, 2) and np.isfinite(bps).any())
        n_fwd, n_k1 = forwards[0] - f0, att.K1_LAUNCHES - k0
        emit(phase="eval", mode=mode, use_mtm=True, chunk=CHUNK,
             metrics=metrics, wall_s=wall, forwards=n_fwd, k1_launches=n_k1,
             ok=finite)
        if not finite:
            raise AssertionError(f"{mode}: non-finite or misshapen metrics")
        if n_k1 != K1_ATTN_PER_FORWARD * n_fwd:
            raise AssertionError(f"{mode}: {n_k1} K1 launches for {n_fwd} "
                                 f"forwards")
    launches = att.K1_LAUNCHES
    torch.cuda.synchronize()
    emit(phase="eval_total", wall_s=time.perf_counter() - t_all,
         forwards=forwards[0], k1_launches=launches,
         device=torch.cuda.get_device_name(0))
    if launches == 0:
        raise AssertionError("the main path launched no K1 kernel")

    # kernel path vs plain path on the card: one full-test-set forward
    plain = MultiModal(dataclasses.replace(cfg, attn_impl="xla"))
    plain.load_state_dict(model.state_dict())
    batch = next(iter(loader))
    ap_k, beh_k = EvalForward(model, batch).forward()
    ap_p, beh_p = EvalForward(plain, batch).forward()
    err = max(np.abs(ap_k - ap_p).max(), np.abs(beh_k - beh_p).max())
    ok = bool(err <= 1e-4 and np.isfinite(ap_k).all())

    # one sweep-chunk forward (B = CHUNK * trials) on each path
    fwd_k = EvalForward(model, batch, chunk=CHUNK)
    fwd_p = EvalForward(plain, batch, chunk=CHUNK)
    visible = np.ones((CHUNK, N), np.float32)
    visible[np.arange(CHUNK), np.arange(CHUNK)] = 0.0
    tgt = np.arange(CHUNK)
    chunk_ms = cuda_time_ms(lambda: fwd_k.sweep(visible, tgt, True), 5, 1)
    chunk_plain_ms = cuda_time_ms(lambda: fwd_p.sweep(visible, tgt, True),
                                  5, 1)
    emit(phase="kernel_vs_plain_forward", batch=int(batch["n_real"]),
         preds_max_abs_err=float(err), atol=1e-4, ok=ok,
         sweep_chunk_batch=CHUNK * int(batch["n_real"]),
         sweep_chunk_ms=chunk_ms, sweep_chunk_plain_ms=chunk_plain_ms)
    if not ok:
        raise AssertionError(f"kernel path vs plain path: {err}")
    for path, fwd in (("kernel", fwd_k), ("plain", fwd_p)):
        emit(phase="sweep_chunk_profile", path=path,
             batch=CHUNK * int(batch["n_real"]),
             **device_breakdown(lambda: fwd.sweep(visible, tgt, True)))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from multi_modal_foundation_model_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    build_s = build.build(build.kernel_sources())
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s,
         build_wall_s=time.perf_counter() - t0, tf32=False)

    k1 = k1_phase()
    launches = eval_phase(root / "build" / "chip_smoke_eval")
    emit(kernels=[dict(
        name="attention_fwd (K1)", route="cuda",
        source="multi_modal_foundation_model_tpu_torch/csrc/attention_fwd.cu",
        replaces="multi_modal_foundation_model_tpu/ops/attention.py:144",
        launches=launches, **k1)])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
