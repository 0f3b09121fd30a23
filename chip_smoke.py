#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — ``nvidia-smi`` name and power limit, torch/CUDA versions,
   TF32 off, every CUDA kernel of the port built from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. kernels — each kernel against its plain PyTorch version at the shapes
   the main paths give it, timed beside the plain version, the one
   library call that computes the same function, and the bound the card
   could reach: K1 of the eval (``k1_check``/``k1_time``, f32 and bf16,
   B=320), K1 of the training step with dropout and ``lse``
   (``k1_dropout_check``) and K2 (``k2_check``/``k2_time``), B=256, f32
   and bf16 (the bf16 K1 and K2 on the tensor cores, each held against the
   plain version with JAX's bf16 dots and the f32-dots one, and the bf16
   K1's lse against the scores K2 recomputes, ``k1_lse_row_sums``),
   dropout 0 and 0.4 on the same Philox bits as the plain versions; K3/K4,
   the LayerNorm forward and backward
   (``k3_k4_check``/``k3_k4_time``), at the B=256 step's 51,200 x 256
   tokens, one row fewer and 1,001 x 64, f32 and bf16, with dweight/dbias
   bit-equal from one launch to the next. Tolerances: f32 1e-5, bf16 2e-2
   (see each check's docstring).
3. eval    — the serving path: ``co_smoothing_eval`` in all six modes on a
   full-width ``MultiModal`` (N=668 + 2 behavior, T=100, H=256, 8 heads,
   5+5 layers, random weights from a seed) over the port's synthetic test
   split, with the kernel launch counts read around it: f32 under the
   port's default ``PALLAS_LAYERNORM``, then mm.yaml's bf16 compute with
   K3 (``"full"``: 15 K1 and 32 K3 per forward); then one full-test-set
   forward through the kernel path and the plain path (``"off"``).
4. train   — the training path: ``MultiModalTrainer`` on the full-width
   model (dropout 0.4, fixup init, remat) over the synthetic train split,
   batch 16, MtM menu, mixed objectives: ``train()`` for 2 epochs with
   eval, a fresh trainer restored from ``last`` for one more epoch, then
   ``load_model_data_local`` on ``best`` and one eval mode. f32 under the
   port's default LayerNorm mode, bf16 under ``"full"``; launch counts read
   around each (per
   step: K2 15, K1 30 with remat's recompute, and under "full" K3 62 = 30
   in-layer norms twice + 2, K4 32; per eval forward K1 15, K3 32).
   ``kernel_vs_plain_step`` holds one step's gradients against the plain
   path (``attn_impl="xla"``, ``"off"``) in f32 and bf16;
   ``plain_step_time`` times the plain path's f32 step at B=16 and B=256;
   ``layernorm_ab`` times kernel-path steps in f32 and bf16 under "off",
   "bwd" and "full" interleaved in one process (the LayerNorm A/B that set
   the port's default), with profiles that give K1, K2, K3, K4, GEMMs and
   the rest their own groups.

The second-to-last line repeats the ``nvidia-smi`` reading; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
The port never imports JAX, and neither does this script.

    python3 chip_smoke.py --ab OTHER_CHECKOUT

compares this checkout's port with another's (say the parent commit's,
unpacked by ``git archive`` into a git-ignored directory) on one card: four
processes in the order other, this, this, other, each importing its own
checkout's package and building its kernels, each timing the bf16 training
step under ``"full"`` at B=16 and B=256, the bf16 sweep-chunk forward and
the f32 training step at B=256 under the port's default LayerNorm mode
(``ab_step`` / ``ab_sweep_chunk`` lines, with profiles).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
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
PEAK_TF32_FLOPS = 495e12          # tensor cores, TF32 operands

# the main path: the reference model at full width
GEOMETRY = dict(n_channels={"ap": 668, "behavior": 2}, max_F=100,
                hidden_size=256, n_heads=8, n_enc_layers=5, n_dec_layers=5,
                inter_size=512, act="gelu")
N_TRIALS, SEED, CHUNK = 200, 0, 16
K1_ATTN_PER_FORWARD = 15          # 5 encoder self, 5 decoder self, 5 cross
# LayerNorms per forward: 2 per encoder layer, 4 per decoder layer, plus
# encoder_norm and decoder_norm; under remat the in-layer 30 run twice
K3_PER_FORWARD = 5 * 2 + 5 * 4 + 2
K3_PER_STEP = 2 * (K3_PER_FORWARD - 2) + 2
K4_PER_STEP = K3_PER_FORWARD
# the trainer's batch (trainer_mm.yaml:26) and the JAX package's
# benchmark batch
TRAIN_B, BIG_B = 16, 256
MTM_MENU = ("inter-region", "intra-region", "neuron", "temporal")
DROPOUT = 0.4
DTYPES = (torch.float32, torch.bfloat16)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LN_MODES = ("off", "bwd", "full")


def emit(**record):
    print(json.dumps(record), flush=True)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


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


def _group(name: str) -> str:
    low = name.lower()
    if "attn_fwd_" in low:
        return "k1_ms"
    if "attn_bwd_" in low:
        return "k2_ms"
    if "ln_fwd_kernel" in low:
        return "k3_ms"
    if "ln_bwd_" in low:
        return "k4_ms"
    # cuBLAS's bf16 GEMMs on Hopper are its "nvjet" kernels
    if any(s in low for s in ("gemm", "cutlass", "sm90_", "ampere_", "xmma",
                              "nvjet")):
        return "gemm_ms"
    return "other_ms"


def _device_events(prof):
    """(name, ms) of every kernel in a profile; user annotations (e.g.
    "Optimizer.step#AdamW.step") also appear on the device timeline, and
    span kernels counted on their own."""
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False):
            yield evt.name, evt.time_range.elapsed_us() / 1e3


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    it launches, from a torch.profiler trace of ``reps`` calls. For kernels
    of tens of microseconds, whose wrappers take about as long on the host,
    CUDA events would time the host's launch rate instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for _, ms in _device_events(prof)) / reps


def device_breakdown(fn, top: int = 6) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler, CUPTI
    tracing), grouped as K1 / K2 / K3 / K4 / GEMM / other by kernel name,
    beside the host wall time of the same profiled call (so the idle share
    includes profiler cost)."""
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
    for name, ms in _device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + ms
    groups = dict.fromkeys(("k1_ms", "k2_ms", "k3_ms", "k4_ms", "gemm_ms",
                            "other_ms"), 0.0)
    for name, ms in by_name.items():
        groups[_group(name)] += ms
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


def _bound(bytes_moved: float, flops: float, dtype=torch.float32,
           peak: float | None = None) -> dict:
    """The least time for the work: bytes at the memory rate, operations at
    the peak rate of the inputs' type (or ``peak``); the larger one bounds
    it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)


_ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by")


def _row(d: dict) -> dict:
    return {k: d[k] for k in _ROW_KEYS}


@contextlib.contextmanager
def ln_mode(mode: str):
    """Run under ``PALLAS_LAYERNORM = mode``."""
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    old = ln.PALLAS_LAYERNORM
    ln.PALLAS_LAYERNORM = mode
    try:
        yield
    finally:
        ln.PALLAS_LAYERNORM = old


def reset_counts() -> None:
    from multi_modal_foundation_model_tpu_torch.ops import attention as att
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    att.K1_LAUNCHES = att.K2_LAUNCHES = 0
    ln.K3_LAUNCHES = ln.K4_LAUNCHES = 0


def read_counts() -> dict:
    from multi_modal_foundation_model_tpu_torch.ops import attention as att
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    return dict(k1=att.K1_LAUNCHES, k2=att.K2_LAUNCHES, k3=ln.K3_LAUNCHES,
                k4=ln.K4_LAUNCHES)


def _excess(got, want, tol: float) -> float:
    """max(|got - want| - tol (1 + |want|)): <= 0 when every element agrees
    within ``tol`` absolute and relative (2e-2 covers one bf16 rounding of
    f32 math)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - tol * (1 + want.abs())).max().item()


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_inputs(case: str, dtype, B=320, T=200, H=8, D=32, seed=1,
              requires_grad=False):
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
        kv.requires_grad_(requires_grad)
        q.requires_grad_(requires_grad)
        k, v = kv.split(hidden, dim=-1)
    else:
        qkv = torch.randn(B, T, 3 * hidden, device="cuda",
                          generator=g).to(dtype)
        qkv.requires_grad_(requires_grad)
        q, k, v = qkv.split(hidden, dim=-1)
    if case == "decoder_pad":
        pad[3] = 0                          # a padded trial: masked rows
        return q, k, v, MaskSpec(key_pad=pad, static=None), H
    eye = torch.eye(T, dtype=torch.int32, device="cuda")
    return q, k, v, MaskSpec(key_pad=pad, static=eye), H


def k1_gates(q, k, v, key_pad, static, H, scale, out, lse, rate=0.0,
             seed=0) -> dict:
    """K1's output and lse against its plain versions on the same inputs
    and Philox bits. f32: out and lse atol 1e-5 (the same f32 products
    summed in other orders). bf16 (the tensor-core K1, with JAX's bf16
    dots): out within 1e-2 (1 + |plain|) of the plain version with the
    same bf16 roundings (``dots_dtype=bf16``; f32 sums in other orders,
    an online softmax that rounds p to bf16 before, not after, its last
    rescale, and one bf16 rounding of the output) and within 2e-2 (1 +
    |plain|) of the f32-dots one (one bf16 rounding of every product
    operand); lse within 1e-5 (1 + |lse|) of the bf16-dots plain lse."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    args = (q, k, v, key_pad, static, H, scale, True, rate, seed)
    ref, ref_lse = att.attention_reference(*args)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    if q.dtype == torch.float32:
        return dict(max_abs_err=err, lse_max_abs_err=lse_err,
                    tolerance="atol 1e-5",
                    ok=err <= 1e-5 and lse_err <= 1e-5 and finite)
    bf, bf_lse = att.attention_reference(*args, dots_dtype=torch.bfloat16)
    ex_bf = _excess(out, bf, 1e-2)
    ex_f32 = _excess(out, ref, 2e-2)
    ex_lse = _excess(lse, bf_lse, 1e-5)
    return dict(max_abs_err=err, f32_dots_lse_max_abs_err=lse_err,
                bf16_dots_max_abs_err=(out.float() - bf.float()).abs().max()
                .item(),
                bf16_dots_lse_max_abs_err=(lse - bf_lse).abs().max().item(),
                bf16_dots_excess=ex_bf, f32_dots_excess=ex_f32,
                bf16_dots_lse_excess=ex_lse,
                tolerance=("out 1e-2 (1 + |plain bf16 dots|) and 2e-2 (1 + "
                           "|plain f32 dots|); lse 1e-5 (1 + |lse bf16 "
                           "dots|)"),
                ok=ex_bf <= 0.0 and ex_f32 <= 0.0 and ex_lse <= 0.0
                and finite)


def lse_row_sums(q, k, key_pad, static, H, scale, lse) -> dict:
    """What the bf16 K2 relies on: with the bf16-dots scores (``s =
    bf16(q * scale) . bf16(k) + bias``, the scores K2 recomputes), every
    row that attends anything has ``sum_k exp(s - lse) = 1`` against K1's
    lse (dropout 0), within 1e-3."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    B, Tq, hidden = q.shape
    D = hidden // H

    def heads(x):
        return x.unflatten(-1, (H, D)).transpose(1, 2).float()

    s = ((heads(q) * scale).bfloat16().float()
         @ heads(k.bfloat16()).transpose(-1, -2)
         + att._attend_bias(key_pad, static)[:, None])
    sums = torch.exp(s - lse[..., None]).sum(-1)            # (B, H, Tq)
    del s
    rows = (static.bool()[None] | key_pad.bool()[:, None]).any(-1)
    err = (sums - 1).abs()[rows[:, None].expand_as(sums)].max().item()
    return dict(row_sum_max_abs_err=err, rows=int(rows.sum()) * H,
                ok=err <= 1e-3)


def k1_phase():
    """K1 of the eval (no dropout, no lse) at B=320 against its plain
    versions (``k1_gates``); timed in both dtypes at the encoder shape."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    worst = dict.fromkeys(DTYPES, 0.0)
    for case in ("encoder_eye_pad", "decoder_pad", "cross"):
        for dtype in DTYPES:
            q, k, v, spec, H = k1_inputs(case, dtype)
            B, Tq, hidden = q.shape
            key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1],
                                                q.device)
            scale = 1.0 / math.sqrt(hidden // H)
            out, lse = att.attention_fwd(q, k, v, key_pad, static, H, scale,
                                         with_lse=True)
            torch.cuda.synchronize()
            gates = k1_gates(q, k, v, key_pad, static, H, scale, out, lse)
            emit(phase="k1_check", case=case, dtype=str(dtype), shape=[
                B, Tq, hidden], heads=H, **gates)
            if not gates["ok"]:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"({case}, {dtype}): {gates}")
            worst[dtype] = max(worst[dtype], gates["max_abs_err"])

    # timing at the encoder shape, in each dtype
    rows = {}
    for dtype in DTYPES:
        q, k, v, spec, H = k1_inputs("encoder_eye_pad", dtype)
        B, Tq, hidden = q.shape
        Tk, D = k.shape[1], hidden // H
        key_pad, static = att.spec_operands(spec, B, Tq, Tk, q.device)
        scale = 1.0 / math.sqrt(D)
        ms = cuda_time_ms(lambda: att.attention_fwd(q, k, v, key_pad, static,
                                                    H, scale))
        # the plain version of the kernel: bf16 dots for the bf16 K1
        plain_ms = cuda_time_ms(lambda: att.attention_reference(
            q, k, v, key_pad, static, H, scale, dots_dtype=dtype))
        # library yardstick (never called by the port): SDPA on head views
        # with the same additive bias
        bias = att.mask_to_bias(static.bool()[None] | key_pad.bool()[:, None])
        bias = bias[:, None].to(dtype)
        qh, kh, vh = (x.unflatten(-1, (H, D)).transpose(1, 2)
                      for x in (q, k, v))
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias))
        # least time for the same work: each input read once, the output
        # written once; the two products' flops at the inputs' type's peak
        elem = q.element_size()
        bytes_moved = ((2 * B * Tq + 2 * B * Tk) * hidden * elem
                       + key_pad.numel() * 4 + static.numel() * 4)
        flops = 4 * B * H * Tq * Tk * D
        b = _bound(bytes_moved, flops, dtype)
        emit(phase="k1_time", shape=[B, Tq, Tk, H, D],
             dtype=dtype_name(dtype), ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bytes=bytes_moved, flops=flops, **b)
        rows[dtype] = dict(max_abs_err=worst[dtype], ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms, **b)
    return rows


# ---------------------------------------------------------------------------
# phase 2b: K1 with dropout and lse, K2, against their plain versions
# ---------------------------------------------------------------------------

def train_kernels_phase():
    """K1 (dropout, lse) and K2 at the training step's shapes (B=256,
    Tq=Tk=200, H=8, D=32), f32 and bf16, each case at dropout 0 and 0.4
    against the plain versions on the same Philox bits. f32: atol 1e-5 on
    out, lse, dq, dk, dv (the same f32 products summed in other orders).
    bf16: K1 as ``k1_gates`` says, and at dropout 0 its lse against the
    bf16-dots scores K2 recomputes (``lse_row_sums``); the tensor-core
    K2's dq/dk/dv within
    1e-2 (1 + |plain|) of the plain version with JAX's bf16 dots
    (``dots_dtype=bf16``: the same bf16 roundings, f32 sums in other
    orders) and within 2e-2 (1 + |plain|) of the f32-dots one (one bf16
    rounding of every product operand). A padded trial's dq exactly 0, and
    dq/dk/dv bit-equal across two launches. Then timings in both dtypes."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    worst_k1 = dict.fromkeys(DTYPES, 0.0)
    worst_k2 = dict.fromkeys(DTYPES, 0.0)
    for dtype in DTYPES:
        for case in ("encoder_eye_pad", "decoder_pad", "cross"):
            q, k, v, spec, H = k1_inputs(case, dtype, B=BIG_B)
            B, Tq, hidden = q.shape
            key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1],
                                                q.device)
            scale = 1.0 / math.sqrt(hidden // H)
            g = torch.randn(q.shape, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(2))
            g = g.to(dtype)
            for rate in (0.0, DROPOUT):
                out, lse = att.attention_fwd(q, k, v, key_pad, static, H,
                                             scale, True, rate, 1234)
                grads = att.attention_bwd(q, k, v, key_pad, static, g, lse,
                                          H, scale, rate, 1234)
                again = att.attention_bwd(q, k, v, key_pad, static, g, lse,
                                          H, scale, rate, 1234)
                torch.cuda.synchronize()
                bit_equal = all(torch.equal(a, b)
                                for a, b in zip(grads, again))
                del again
                k1 = k1_gates(q, k, v, key_pad, static, H, scale, out, lse,
                              rate, 1234)
                if dtype == torch.bfloat16 and rate == 0.0:
                    sums = lse_row_sums(q, k, key_pad, static, H, scale,
                                        lse)
                    emit(phase="k1_lse_row_sums", dtype=dtype_name(dtype),
                         case=case, shape=[B, Tq, hidden], **sums)
                    k1["ok"] = k1["ok"] and sums["ok"]
                ref_grads = att.attention_bwd_reference(
                    q, k, v, key_pad, static, g, lse, H, scale, rate, 1234)
                gerr = [(a.float() - b.float()).abs().max().item()
                        for a, b in zip(grads, ref_grads)]
                masked_dq = (grads[0][3].abs().max().item()
                             if case == "decoder_pad" else 0.0)
                ok1 = k1["ok"]
                extra = {}
                if dtype == torch.float32:
                    ok2 = max(gerr) <= 1e-5
                    tolerance = "atol 1e-5"
                else:
                    # the kernel's own yardstick: JAX's bf16 dots
                    bf_grads = att.attention_bwd_reference(
                        q, k, v, key_pad, static, g, lse, H, scale, rate,
                        1234, dots_dtype=torch.bfloat16)
                    bf_err = [(a.float() - b.float()).abs().max().item()
                              for a, b in zip(grads, bf_grads)]
                    ex_bf = max(_excess(a, b, 1e-2)
                                for a, b in zip(grads, bf_grads))
                    ex_f32 = max(_excess(a, b, 2e-2)
                                 for a, b in zip(grads, ref_grads))
                    del bf_grads
                    ok2 = ex_bf <= 0.0 and ex_f32 <= 0.0
                    tolerance = ("1e-2 (1 + |plain bf16 dots|) and "
                                 "2e-2 (1 + |plain f32 dots|)")
                    extra = dict(bf16_dots_max_abs_err=bf_err,
                                 bf16_dots_excess=ex_bf,
                                 f32_dots_excess=ex_f32)
                ok2 = ok2 and masked_dq == 0.0 and bit_equal
                emit(phase="k1_dropout_check", dtype=dtype_name(dtype),
                     case=case, dropout=rate, shape=[B, Tq, hidden], **k1)
                emit(phase="k2_check", dtype=dtype_name(dtype), case=case,
                     dropout=rate, shape=[B, Tq, hidden],
                     dq_dk_dv_max_abs_err=gerr, **extra,
                     padded_trial_max_abs_dq=masked_dq,
                     bit_equal_across_launches=bit_equal,
                     tolerance=tolerance, ok=ok2)
                if not (ok1 and ok2):
                    raise AssertionError(
                        f"K1/K2 disagree with their plain versions ({case}, "
                        f"{dtype}, {rate}): {k1}, {gerr}, "
                        f"{masked_dq}, {extra}, bit-equal {bit_equal}")
                worst_k1[dtype] = max(worst_k1[dtype], k1["max_abs_err"])
                worst_k2[dtype] = max(worst_k2[dtype], *gerr)

    # timings at the encoder shape, dropout 0.4 (the training step's)
    k1_rows, k2_rows = {}, {}
    for dtype in DTYPES:
        q, k, v, spec, H = k1_inputs("encoder_eye_pad", dtype, B=BIG_B)
        B, Tq, hidden = q.shape
        Tk, D = k.shape[1], hidden // H
        key_pad, static = att.spec_operands(spec, B, Tq, Tk, q.device)
        scale = 1.0 / math.sqrt(D)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3))
        g = g.to(dtype)
        _, lse = att.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                                   DROPOUT, 7)
        k1_ms = cuda_time_ms(lambda: att.attention_fwd(
            q, k, v, key_pad, static, H, scale, True, DROPOUT, 7))
        k1_plain = cuda_time_ms(lambda: att.attention_reference(
            q, k, v, key_pad, static, H, scale, True, DROPOUT, 7,
            dots_dtype=dtype), 5, 1)
        k2_ms = cuda_time_ms(lambda: att.attention_bwd(
            q, k, v, key_pad, static, g, lse, H, scale, DROPOUT, 7))
        k2_ms_rate0 = cuda_time_ms(lambda: att.attention_bwd(
            q, k, v, key_pad, static, g, lse, H, scale, 0.0, 7))
        # the plain version of the kernel: bf16 dots for the bf16 K2
        k2_plain = cuda_time_ms(lambda: att.attention_bwd_reference(
            q, k, v, key_pad, static, g, lse, H, scale, DROPOUT, 7,
            dots_dtype=dtype), 5, 1)
        # library yardstick (never called by the port): SDPA with the same
        # additive bias and dropout_p; K2's is its backward, (fwd + bwd) -
        # fwd
        bias = att.mask_to_bias(static.bool()[None]
                                | key_pad.bool()[:, None])[:, None]
        bias = bias.to(dtype)
        qh, kh, vh = (x.detach().unflatten(-1, (H, D)).transpose(1, 2)
                      .requires_grad_(True) for x in (q, k, v))
        gh = g.unflatten(-1, (H, D)).transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                  dropout_p=DROPOUT)

        lib_fwd = cuda_time_ms(lambda: sdpa().detach())
        lib_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            sdpa(), (qh, kh, vh), gh))
        # bounds: each input read once, each output written once; the
        # products at the inputs' type's peak (the Philox draws not counted)
        elem = q.element_size()
        masks = key_pad.numel() * 4 + static.numel() * 4
        lse_bytes = B * H * Tq * 4
        # K1: q, k, v in, out and lse out
        k1_b = _bound(B * (2 * Tq + 2 * Tk) * hidden * elem + lse_bytes
                      + masks, 4 * B * H * Tq * Tk * D, dtype)
        # K2: q, g, k, v, lse in; dq, dk, dv out. The f32 K2 runs its five
        # products as three TF32 tensor-core products each (3xTF32): its
        # bound counts 3 x the operations at the TF32 peak, with the five
        # on the CUDA cores (f32 peak) beside it
        k2_bytes = (B * (3 * Tq + 4 * Tk) * hidden * elem + lse_bytes
                    + masks)
        k2_flops = 10 * B * H * Tq * Tk * D
        if dtype == torch.float32:
            k2_b = dict(_bound(k2_bytes, 3 * k2_flops, peak=PEAK_TF32_FLOPS),
                        bound_cuda_core_ms=k2_flops / PEAK_FLOPS[dtype] * 1e3)
        else:
            k2_b = _bound(k2_bytes, k2_flops, dtype)
        emit(phase="k1_train_time", dtype=dtype_name(dtype),
             shape=[B, Tq, Tk, H, D], dropout=DROPOUT, with_lse=True,
             ms=k1_ms, plain_ms=k1_plain, library_ms=lib_fwd, **k1_b)
        emit(phase="k2_time", dtype=dtype_name(dtype),
             shape=[B, Tq, Tk, H, D], dropout=DROPOUT, ms=k2_ms,
             ms_dropout0=k2_ms_rate0, plain_ms=k2_plain,
             library_ms=lib_fwd_bwd - lib_fwd,
             library_fwd_bwd_ms=lib_fwd_bwd, **k2_b)
        k1_rows[dtype] = dict(max_abs_err=worst_k1[dtype], ms=k1_ms,
                              plain_ms=k1_plain, library_ms=lib_fwd, **k1_b)
        k2_rows[dtype] = dict(max_abs_err=worst_k2[dtype], ms=k2_ms,
                              plain_ms=k2_plain,
                              library_ms=lib_fwd_bwd - lib_fwd, **k2_b)
    return k1_rows, k2_rows


# ---------------------------------------------------------------------------
# phase 2c: K3 / K4 (LayerNorm) against their plain versions
# ---------------------------------------------------------------------------

def _ln_operands(rows, width, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, width, device="cuda", generator=g) * 2.0 + 0.3
    w = torch.randn(width, device="cuda", generator=g) * 0.2 + 1.0
    b = torch.randn(width, device="cuda", generator=g) * 0.1
    dy = torch.randn(rows, width, device="cuda", generator=g)
    return x.to(dtype), w, b, dy.to(dtype)


def ln_phase():
    """K3 and K4 at the B=256 step's token count (51,200 x 256), one row
    fewer, and 1,001 x 64, in f32 and bf16. y and dx: |kernel - plain| <=
    tol (1 + |plain|), tol 1e-5 (f32) / 2e-2 (bf16), as the JAX package's
    LayerNorm tests; dweight and dbias are sums over every row, held
    normwise (max |kernel - plain| <= 1e-5 max |plain|) and bit-equal from
    one launch to the next. Then timings at the training shape."""
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    eps = 1e-5
    H = GEOMETRY["hidden_size"]
    rows_main = BIG_B * len(GEOMETRY["n_channels"]) * GEOMETRY["max_F"]
    worst = {3: dict.fromkeys(DTYPES, 0.0), 4: dict.fromkeys(DTYPES, 0.0)}
    for dtype in DTYPES:
        tol = TOL[dtype]
        for rows, width in ((rows_main, H), (rows_main - 1, H), (1001, 64)):
            x, w, b, dy = _ln_operands(rows, width, dtype, seed=rows)
            y = ln.layernorm_fwd(x, w, b, eps, dtype)
            dx, dw, db = ln.layernorm_bwd(x, w, dy, eps)
            dx2, dw2, db2 = ln.layernorm_bwd(x, w, dy, eps)
            torch.cuda.synchronize()
            y_ref = ln.layer_norm(x, w, b, eps, dtype)
            dx_ref, dw_ref, db_ref = ln.layer_norm_bwd_reference(x, w, dy,
                                                                 eps)

            def normwise(a, r):
                return ((a - r).abs().max() / r.abs().max()).item()

            errs = dict(
                y_max_abs_err=(y.float() - y_ref.float()).abs().max().item(),
                dx_max_abs_err=(dx.float() - dx_ref.float()).abs().max()
                .item(),
                dw_normwise_err=normwise(dw, dw_ref),
                db_normwise_err=normwise(db, db_ref))
            reproducible = bool(torch.equal(dw, dw2) and torch.equal(db, db2)
                                and torch.equal(dx, dx2))
            ok = (_excess(y, y_ref, tol) <= 0
                  and _excess(dx, dx_ref, tol) <= 0
                  and errs["dw_normwise_err"] <= 1e-5
                  and errs["db_normwise_err"] <= 1e-5 and reproducible
                  and y.dtype == dx.dtype == dtype)
            emit(phase="k3_k4_check", dtype=dtype_name(dtype),
                 shape=[rows, width], tol=tol, **errs,
                 dweight_dbias_bit_equal_across_launches=reproducible, ok=ok)
            if not ok:
                raise AssertionError(f"K3/K4 disagree with their plain "
                                     f"versions ({rows}, {width}, {dtype})")
            worst[3][dtype] = max(worst[3][dtype], errs["y_max_abs_err"])
            worst[4][dtype] = max(worst[4][dtype], errs["dx_max_abs_err"])

    # device time of every kernel a call launches (``device_ms``), and the
    # same calls timed with CUDA events (host launch gaps included)
    rows3, rows4 = {}, {}
    for dtype in DTYPES:
        x, w, b, dy = _ln_operands(rows_main, H, dtype, seed=5)
        elem = x.element_size()
        # library yardsticks (never called by the port): torch's own
        # LayerNorm forward and backward (two-pass variance), parameters in
        # x's dtype
        wl, bl = w.to(dtype), b.to(dtype)
        _, mean, rstd = torch.native_layer_norm(x, [H], wl, bl, eps)
        calls = dict(
            k3=lambda: ln.layernorm_fwd(x, w, b, eps, dtype),
            k3_plain=lambda: ln.layer_norm(x, w, b, eps, dtype),
            k3_library=lambda: F.layer_norm(x, (H,), wl, bl, eps),
            k4=lambda: ln.layernorm_bwd(x, w, dy, eps),
            k4_plain=lambda: ln.layer_norm_bwd_reference(x, w, dy, eps),
            k4_library=lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [H], mean, rstd, wl, bl, [True, True, True]))
        dev = {k: device_ms(fn) for k, fn in calls.items()}
        event = {k: cuda_time_ms(fn) for k, fn in calls.items()}
        k3_ms, k3_plain, k3_lib = dev["k3"], dev["k3_plain"], dev["k3_library"]
        k4_ms, k4_plain, k4_lib = dev["k4"], dev["k4_plain"], dev["k4_library"]
        n = rows_main * H
        # bytes: x in and y out (K3); x and g in, dx out (K4); the f32
        # parameters and parameter gradients once. Operations: ~7 a value
        # forward (the two sums and the affine map), ~14 backward
        k3_b = _bound(2 * n * elem + 2 * H * 4, 7 * n, dtype)
        k4_b = _bound(3 * n * elem + 3 * H * 4, 14 * n, dtype)
        emit(phase="k3_k4_time", dtype=dtype_name(dtype), shape=[rows_main, H],
             device_ms=dev, event_ms=event, k3_bound_ms=k3_b["bound_ms"],
             k4_bound_ms=k4_b["bound_ms"])
        rows3[dtype] = dict(max_abs_err=worst[3][dtype], ms=k3_ms,
                            plain_ms=k3_plain, library_ms=k3_lib, **k3_b)
        rows4[dtype] = dict(max_abs_err=worst[4][dtype], ms=k4_ms,
                            plain_ms=k4_plain, library_ms=k4_lib, **k4_b)
    return rows3, rows4


# ---------------------------------------------------------------------------
# phase 3: the eval path
# ---------------------------------------------------------------------------

def _cfg(dtype, **over):
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModalConfig)

    return MultiModalConfig(**GEOMETRY, compute_dtype=dtype_name(dtype),
                            **over)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def eval_phase(save_root: Path, dtype, mode: str):
    """All six modes under ``PALLAS_LAYERNORM = mode``; then the kernel
    path (``attn_impl="pallas"``, ``mode``) against the plain path
    (``"xla"``, ``"off"``) on one full-test-set forward: f32 atol 1e-4 (ten
    residual blocks of f32 GEMMs summed in other orders), bf16 relative L2
    2e-2 per modality (bf16 activations rounded at other places)."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import (
        EvalForward, co_smoothing_eval)
    from multi_modal_foundation_model_tpu_torch.models import MultiModal

    cfg = _cfg(dtype)
    T, N = cfg.max_F, cfg.n_channels["ap"]
    model = MultiModal(cfg, generator=torch.Generator().manual_seed(SEED))
    splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                              n_timesteps=T)
    loader = make_loader(splits.test, batch_size=splits.test.n_trials,
                         max_time_length=T, max_space_length=N,
                         shuffle=False)
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(
        0, forwards[0] + 1))
    k3_per_forward = K3_PER_FORWARD if mode == "full" else 0

    modes = [("per_neuron", None),
             ("forward_pred", list(range(7 * T // 10, T))),
             ("inter_region", None), ("intra_region", None),
             ("modal_spike", list(range(T))),
             ("modal_behavior", list(range(T)))]
    with ln_mode(mode):
        reset_counts()
        forwards[0] = 0
        t_all = time.perf_counter()
        for name, held in modes:
            f0, c0 = forwards[0], read_counts()
            t0 = time.perf_counter()
            res = co_smoothing_eval(model, loader, name, use_mtm=True,
                                    chunk=CHUNK, n_time_steps=T,
                                    held_out_list=held,
                                    save_path=str(save_root / name))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            metrics = (res[f"{name}_behav_results"]
                       if name == "modal_behavior" else res)
            finite = all(math.isfinite(x) for x in metrics.values())
            if name != "modal_behavior":
                bps = np.load(save_root / name / "bps.npy")
                r2 = np.load(save_root / name / "r2.npy")
                finite = bool(finite and bps.shape == (N,)
                              and r2.shape == (N, 2)
                              and np.isfinite(bps).any())
            c1 = read_counts()
            n_fwd = forwards[0] - f0
            n_k1, n_k3 = c1["k1"] - c0["k1"], c1["k3"] - c0["k3"]
            emit(phase="eval", dtype=dtype_name(dtype), layernorm=mode,
                 mode=name, use_mtm=True, chunk=CHUNK, metrics=metrics,
                 wall_s=wall, forwards=n_fwd, k1_launches=n_k1,
                 k3_launches=n_k3, ok=finite)
            if not finite:
                raise AssertionError(f"{name}: non-finite or misshapen "
                                     f"metrics")
            if n_k1 != K1_ATTN_PER_FORWARD * n_fwd \
                    or n_k3 != k3_per_forward * n_fwd:
                raise AssertionError(f"{name}: {n_k1} K1 and {n_k3} K3 "
                                     f"launches for {n_fwd} forwards")
        launches = read_counts()
        torch.cuda.synchronize()
        emit(phase="eval_total", dtype=dtype_name(dtype), layernorm=mode,
             wall_s=time.perf_counter() - t_all, forwards=forwards[0],
             k1_launches=launches["k1"], k3_launches=launches["k3"],
             device=torch.cuda.get_device_name(0))
    if launches["k1"] == 0 or (mode == "full" and launches["k3"] == 0):
        raise AssertionError("the eval path launched no K1 or K3 kernel")

    # kernel path vs plain path on the card: one full-test-set forward
    plain = MultiModal(dataclasses.replace(cfg, attn_impl="xla"))
    plain.load_state_dict(model.state_dict())
    batch = next(iter(loader))
    fwd_k = EvalForward(model, batch, chunk=CHUNK)
    fwd_p = EvalForward(plain, batch, chunk=CHUNK)
    with ln_mode(mode):
        ap_k, beh_k = fwd_k.forward()
    with ln_mode("off"):
        ap_p, beh_p = fwd_p.forward()
    err = max(np.abs(ap_k - ap_p).max(), np.abs(beh_k - beh_p).max())
    rel = max(_rel(ap_k, ap_p), _rel(beh_k, beh_p))
    ok = bool((err <= 1e-4 if dtype == torch.float32 else rel <= 2e-2)
              and np.isfinite(ap_k).all())

    # one sweep-chunk forward (B = CHUNK * trials) on each path
    visible = np.ones((CHUNK, N), np.float32)
    visible[np.arange(CHUNK), np.arange(CHUNK)] = 0.0
    tgt = np.arange(CHUNK)
    with ln_mode(mode):
        chunk_ms = cuda_time_ms(lambda: fwd_k.sweep(visible, tgt, True), 5,
                                1)
    with ln_mode("off"):
        chunk_plain_ms = cuda_time_ms(lambda: fwd_p.sweep(visible, tgt, True),
                                      5, 1)
    emit(phase="kernel_vs_plain_forward", dtype=dtype_name(dtype),
         layernorm=mode, batch=int(batch["n_real"]),
         preds_max_abs_err=float(err), preds_rel_l2=rel,
         tolerance=("atol 1e-4" if dtype == torch.float32
                    else "relative L2 2e-2"), ok=ok,
         sweep_chunk_batch=CHUNK * int(batch["n_real"]),
         sweep_chunk_ms=chunk_ms, sweep_chunk_plain_ms=chunk_plain_ms)
    if not ok:
        raise AssertionError(f"kernel path vs plain path: {err}, {rel}")
    for path, fwd, m in (("kernel", fwd_k, mode), ("plain", fwd_p, "off")):
        with ln_mode(m):
            emit(phase="sweep_chunk_profile", dtype=dtype_name(dtype),
                 layernorm=m, path=path, batch=CHUNK * int(batch["n_real"]),
                 **device_breakdown(lambda: fwd.sweep(visible, tgt, True)))
    return launches


# ---------------------------------------------------------------------------
# phase 4: the training path
# ---------------------------------------------------------------------------

def step_flops(cfg, B: int) -> dict:
    """Multiply-add operations (x2) of one training step of ``cfg`` at
    batch ``B``, counted from the shapes: the forward ``F`` (GEMMs of the
    tokenizers, the 5+5 layers, the context projection and the heads, and
    the 15 attentions' two products); a step is ``3 F`` (forward, and a
    backward of twice its products), plus the layers' forward again under
    remat."""
    H, T, I = cfg.hidden_size, cfg.max_F, cfg.inter_size
    tokens = B * T * len(cfg.avail_mod)
    tok = sum(2 * 2 * B * T * (c * c * cfg.mult + c * cfg.mult * H)
              for c in cfg.n_channels.values())       # enc + dec tokenizers
    attn_proj = 2 * tokens * (3 * H * H + H * H)       # qkv + out
    cross_proj = 2 * tokens * (H * H + 2 * H * H + H * H)
    mlp = 2 * tokens * 2 * H * I
    attn = 4 * B * cfg.n_heads * (len(cfg.avail_mod) * T) ** 2 * (
        H // cfg.n_heads)
    enc = cfg.n_enc_layers * (attn_proj + mlp + attn)
    dec = cfg.n_dec_layers * (attn_proj + cross_proj + mlp + 2 * attn)
    heads = sum(2 * B * T * H * c for c in cfg.n_channels.values())
    fwd = tok + enc + dec + 2 * tokens * H * H + heads
    return dict(forward_flops=fwd, step_flops=3 * fwd,
                step_flops_with_remat=3 * fwd + enc + dec)


def _trainer(cfg, loader, val_loader, epochs, log_dir, **model_kw):
    from multi_modal_foundation_model_tpu_torch.models import MultiModal
    from multi_modal_foundation_model_tpu_torch.train import (
        MetricLogger, MultiModalTrainer, OptimizerConfig, TrainerConfig)

    model = MultiModal(cfg, generator=torch.Generator().manual_seed(SEED),
                       **model_kw)
    tcfg = TrainerConfig(num_epochs=epochs, mask_type="input",
                         mask_mode=MTM_MENU, mixed_training=True, seed=SEED,
                         log_dir=str(log_dir))
    return MultiModalTrainer(model, loader, val_loader, OptimizerConfig(),
                             tcfg, logger=MetricLogger(str(log_dir),
                                                       stdout=False))


def _count_forwards(model, counts):
    def hook(_mod, _args, kwargs, _out):
        counts["train" if kwargs.get("training") else "eval"] += 1
    model.register_forward_hook(hook, with_kwargs=True)


def train_phase(root: Path, dtype, mode: str):
    """MultiModalTrainer at full width under ``PALLAS_LAYERNORM = mode``:
    2 epochs with eval, restore into a fresh trainer, 1 more epoch; then
    the eval reload of ``best``. The loss must be finite and fall (the last
    epoch's mean step loss below the first's), the restore exact, and the
    launch counts those of the steps and eval forwards run."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import (
        co_smoothing_eval, load_model_data_local)

    cfg = _cfg(dtype)
    T, N = cfg.max_F, cfg.n_channels["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                              n_timesteps=T)
    kw = dict(batch_size=TRAIN_B, max_time_length=T, max_space_length=N)
    train_l = make_loader(splits.train, seed=SEED, **kw)
    val_l = make_loader(splits.val, shuffle=False, **kw)
    log_dir = root / f"train_{dtype_name(dtype)}"
    shutil.rmtree(log_dir, ignore_errors=True)

    counts = {"train": 0, "eval": 0}
    with ln_mode(mode):
        reset_counts()
        t0 = time.perf_counter()
        tr_a = _trainer(cfg, train_l, val_l, 2, log_dir)
        _count_forwards(tr_a.model, counts)
        res_a = tr_a.train()
        tr_b = _trainer(cfg, train_l, val_l, 3, log_dir)
        _count_forwards(tr_b.model, counts)
        epoch = tr_b.restore("last")
        restored_step = tr_b.step
        same = all(torch.equal(a, b) for a, b in zip(
            tr_a.model.state_dict().values(),
            tr_b.model.state_dict().values()))
        res_b = tr_b.train(start_epoch=epoch + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    steps = tr_a.step + tr_b.step - restored_step

    losses, epoch_means = [], []
    for row in res_a["history"] + res_b["history"]:
        losses += row["step_losses"]
        epoch_means.append(float(np.mean(row["step_losses"])))
        emit(phase="train_epoch", dtype=dtype_name(dtype), layernorm=mode,
             epoch=row["epoch"], step_losses=row["step_losses"],
             train_loss=row["train_loss"], eval_loss=row.get("eval_loss"),
             eval_trial_avg_r2=row.get("eval_trial_avg_r2"),
             lr=row["lr"], epoch_time_s=row["epoch_time_s"])
    finite = all(math.isfinite(x) for x in losses)
    falling = epoch_means[-1] < epoch_means[0]
    n_eval = counts["eval"]
    on = mode == "full"
    want = dict(
        k1=2 * K1_ATTN_PER_FORWARD * steps + K1_ATTN_PER_FORWARD * n_eval,
        k2=K1_ATTN_PER_FORWARD * steps,
        k3=(K3_PER_STEP * steps + K3_PER_FORWARD * n_eval) if on else 0,
        k4=K4_PER_STEP * steps if mode in ("bwd", "full") else 0)
    ok = (finite and falling and same and epoch == 1
          and restored_step == tr_a.step
          and steps == counts["train"] == len(losses) and launches == want)
    emit(phase="train", dtype=dtype_name(dtype), layernorm=mode,
         batch=TRAIN_B, steps=steps, epochs=3, restored_epoch=epoch,
         restored_params_equal=same, train_forwards=counts["train"],
         eval_forwards=n_eval, launches=launches, launches_expected=want,
         per_step={k: launches[k] / max(steps, 1) for k in ("k2", "k4")},
         losses_finite=finite, epoch_mean_losses=epoch_means,
         loss_falling=falling, best_epoch=res_a["best_epoch"], wall_s=wall,
         device=torch.cuda.get_device_name(0), ok=ok)
    if not ok:
        raise AssertionError("training path: launches, losses or resume "
                             "are off (see the train line)")

    with ln_mode(mode):
        model, loader = load_model_data_local(
            model_dir=str(log_dir), test_session=splits.test,
            checkpoint_name="best", max_time_length=T, max_space_length=N)
        res = co_smoothing_eval(model, loader, "forward_pred", use_mtm=True,
                                n_time_steps=T,
                                held_out_list=list(range(7 * T // 10, T)),
                                save_path=str(root / f"train_eval_"
                                              f"{dtype_name(dtype)}"))
    fin = (all(math.isfinite(x) for x in res.values())
           and model.config.compute_dtype == dtype_name(dtype))
    emit(phase="train_eval_reload", dtype=dtype_name(dtype), layernorm=mode,
         checkpoint="best", mode="forward_pred", metrics=res, ok=fin)
    if not fin:
        raise AssertionError("eval of the trained checkpoint is not finite")
    return launches


def kernel_vs_plain_step(root: Path, dtype, mode: str):
    """One training step's loss and parameter gradients, kernel path
    (``attn_impl="pallas"``, ``PALLAS_LAYERNORM = mode``) against the plain
    path (``"xla"``, ``"off"``): same weights, batch, objective, scheme and
    step seed, dropout 0.4 (the same Philox and u8 draws on both).
    f32: loss rtol 1e-5, every gradient element within 1e-6 + 1e-4 |plain|
    (f32 sums in other orders through ten layers). bf16: loss within 1e-2
    relative and every parameter's gradient within 5e-2 relative L2 (bf16
    activations rounded at other places: one bf16 step is 4e-3), except
    the attention key biases, whose exact gradient is 0 (softmax is
    shift-invariant) so that both paths hold rounding noise there."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)

    cfg = _cfg(dtype)
    T, N = cfg.max_F, cfg.n_channels["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                              n_timesteps=T)
    loader = make_loader(splits.train, batch_size=TRAIN_B, shuffle=False,
                         max_time_length=T, max_space_length=N)
    results = []
    for impl, m in (("pallas", mode), ("xla", "off")):
        with ln_mode(m):
            tr = _trainer(dataclasses.replace(cfg, attn_impl=impl), loader,
                          None, 1, root / "chip_smoke_step")
            batch = tr._device_batch(next(iter(loader)))
            out = tr.step_loss(batch, "token_masking", 1, step=5)
            out.loss.backward()
        results.append((out.loss.item(), {
            n: p.grad.detach().clone()
            for n, p in tr.model.named_parameters()}))
    (lk, gk), (lp, gp) = results
    worst = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    loss_rel = abs(lk - lp) / abs(lp)
    if dtype == torch.float32:
        # elementwise |kernel - plain| <= atol + rtol |plain|
        atol, rtol = 1e-6, 1e-4
        excess = max(((gk[n] - gp[n]).abs() - atol - rtol * gp[n].abs())
                     .max().item() for n in gk)
        ok = loss_rel <= 1e-5 and excess <= 0.0
        tol = dict(loss_rtol=1e-5, grad_atol=atol, grad_rtol=rtol)
    else:
        rel = max(((gk[n] - gp[n]).norm() / gp[n].norm()).item()
                  for n in gk if not n.endswith("key.bias"))
        ok = loss_rel <= 1e-2 and rel <= 5e-2
        tol = dict(loss_rtol=1e-2, grad_rel_l2=5e-2,
                   grad_rel_l2_worst=rel)
    emit(phase="kernel_vs_plain_step", dtype=dtype_name(dtype),
         layernorm=mode, batch=TRAIN_B, dropout=DROPOUT, loss_kernel=lk,
         loss_plain=lp, loss_rel_err=loss_rel, grad_max_abs_err=worst,
         n_params=len(gk), ok=ok, **tol)
    if not ok:
        raise AssertionError(f"kernel vs plain step ({dtype}): loss "
                             f"{loss_rel}, grads {worst}")


def _step_loaders(B: int):
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)

    T, N = GEOMETRY["max_F"], GEOMETRY["n_channels"]["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=320, n_neurons=N,
                              n_timesteps=T)
    return make_loader(splits.train, batch_size=B, shuffle=False,
                       max_time_length=T, max_space_length=N)


def _step_fn(tr):
    batch = tr._device_batch(next(iter(tr.train_dataloader)))

    def step():
        return tr.train_step(batch, *tr._sample_modes())
    return step


def plain_step_time(root: Path):
    """The plain path's step (``attn_impl="xla"``, ``"off"``), f32, at B=16
    and B=256: what the kernels are measured against end to end."""
    cfg = _cfg(torch.float32, attn_impl="xla")
    for B, reps in ((TRAIN_B, 6), (BIG_B, 2)):
        with ln_mode("off"):
            tr = _trainer(cfg, _step_loaders(B), None, 1,
                          root / "chip_smoke_time")
            step = _step_fn(tr)
            tr._reseed_host_rng(0)
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        emit(phase="train_step_time", dtype="float32", layernorm="off",
             batch=B, path="xla", ms_per_step=ms, seq_per_s=B / ms * 1e3,
             steps=reps, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del tr, step
        torch.cuda.empty_cache()


def layernorm_ab(root: Path, dtype) -> str:
    """Kernel-path steps in ``dtype`` under "off", "bwd" and "full", at
    B=16 and B=256: one trainer per batch, the switch flipped between
    segments of steps in the order off, bwd, full, full, bwd, off, ... (4
    passes), so each mode sees the same phases of the card. Per mode: the
    median segment's ms per step and the spread (max - min) over its
    segments; then a profile of one step per mode. Returns the mode the
    rule picks at B=256: the fastest whose gain over "off" exceeds both
    modes' spread, else "off"."""
    cfg = _cfg(dtype)
    choice = "off"
    for B, reps in ((TRAIN_B, 10), (BIG_B, 3)):
        tr = _trainer(cfg, _step_loaders(B), None, 1, root / "chip_smoke_ab")
        step = _step_fn(tr)
        tr._reseed_host_rng(0)
        for mode in LN_MODES:
            with ln_mode(mode):
                step()
                step()
        segs = {m: [] for m in LN_MODES}
        torch.cuda.reset_peak_memory_stats()
        for p in range(4):
            for mode in (LN_MODES if p % 2 == 0 else LN_MODES[::-1]):
                with ln_mode(mode):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        step()
                    torch.cuda.synchronize()
                segs[mode].append((time.perf_counter() - t0) * 1e3 / reps)
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = {m: float(np.median(v)) for m, v in segs.items()}
        spread = {m: max(v) - min(v) for m, v in segs.items()}
        best = min(LN_MODES, key=med.get)
        gain = med["off"] - med[best]
        pick = (best if best != "off"
                and gain > max(spread["off"], spread[best]) else "off")
        flops = step_flops(cfg, B)
        emit(phase="train_step_time", dtype=dtype_name(dtype), path="pallas",
             batch=B, steps_per_segment=reps, segments_ms=segs,
             ms_per_step=med, spread_ms=spread,
             seq_per_s={m: B / v * 1e3 for m, v in med.items()},
             fastest=best, gain_over_off_ms=gain, rule_pick=pick,
             peak_mem_gb=peak, **flops,
             step_bound_ms=flops["step_flops_with_remat"]
             / PEAK_FLOPS[dtype] * 1e3)
        for mode in LN_MODES:
            with ln_mode(mode):
                emit(phase="train_step_profile", dtype=dtype_name(dtype),
                     layernorm=mode, batch=B, path="pallas",
                     **device_breakdown(step, top=8))
        if B == BIG_B:
            choice = pick
        del tr, step
        torch.cuda.empty_cache()
    return choice


def _ab_step(side: str, where: str, out: Path, dtype, mode: str, B: int,
             reps: int) -> None:
    """One ``ab_step`` line: 4 segments of ``reps`` kernel-path steps after
    2 warm-ups, their median, and a profile of one step."""
    tr = _trainer(_cfg(dtype), _step_loaders(B), None, 1,
                  out / "chip_smoke_ab")
    step = _step_fn(tr)
    tr._reseed_host_rng(0)
    for _ in range(2):
        step()
    segs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        segs.append((time.perf_counter() - t0) * 1e3 / reps)
    emit(phase="ab_step", side=side, package=where, dtype=dtype_name(dtype),
         layernorm=mode, batch=B, segments_ms=segs,
         ms_per_step=float(np.median(segs)),
         **device_breakdown(step, top=4))
    del tr, step
    torch.cuda.empty_cache()


def ab_worker(side: str, out: Path) -> None:
    """One process of ``--ab``: the bf16 steps under "full" at B=16 and
    B=256 (4 segments of 10 and 3 steps after 2 warm-ups, their median),
    the bf16 sweep-chunk forward (B = 16 x 20, 3 timings of 5), and the
    f32 step at B=256 under the port's default LayerNorm mode (the
    device-bound step, where the f32 K2 shows), each with a profile, on the
    package first on ``sys.path``."""
    import multi_modal_foundation_model_tpu_torch as pkg
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import EvalForward
    from multi_modal_foundation_model_tpu_torch.models import MultiModal
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    dtype = torch.bfloat16
    where = str(Path(pkg.__file__).resolve().parent)
    default = ln.PALLAS_LAYERNORM
    with ln_mode("full"):
        for B, reps in ((TRAIN_B, 10), (BIG_B, 3)):
            _ab_step(side, where, out, dtype, "full", B, reps)

        cfg = _cfg(dtype)
        T, N = cfg.max_F, cfg.n_channels["ap"]
        model = MultiModal(cfg, generator=torch.Generator().manual_seed(SEED))
        splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                                  n_timesteps=T)
        loader = make_loader(splits.test, batch_size=splits.test.n_trials,
                             max_time_length=T, max_space_length=N,
                             shuffle=False)
        batch = next(iter(loader))
        fwd = EvalForward(model, batch, chunk=CHUNK)
        visible = np.ones((CHUNK, N), np.float32)
        visible[np.arange(CHUNK), np.arange(CHUNK)] = 0.0
        tgt = np.arange(CHUNK)

        def chunk():
            return fwd.sweep(visible, tgt, True)

        times = [cuda_time_ms(chunk, 5, 1) for _ in range(3)]
        emit(phase="ab_sweep_chunk", side=side, package=where,
             dtype="bfloat16", layernorm="full",
             batch=CHUNK * int(batch["n_real"]), ms=times,
             **device_breakdown(chunk, top=4))
        del fwd, model
        torch.cuda.empty_cache()
    with ln_mode(default):
        _ab_step(side, where, out, torch.float32, default, BIG_B, 3)


def ab(other: str) -> int:
    """``--ab OTHER``: other, this, this, other, one process each."""
    me = Path(__file__).resolve()
    print(nvidia_smi(), flush=True)
    for side, root in (("other", other), ("this", me.parent),
                       ("this", me.parent), ("other", other)):
        rc = subprocess.run([sys.executable, str(me), "--ab-worker", side,
                             str(Path(root).resolve())]).returncode
        if rc != 0:
            return rc
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if sys.argv[1:2] == ["--ab"]:
        return ab(sys.argv[2])
    if sys.argv[1:2] == ["--ab-worker"]:
        # this script's helpers, on the other checkout's package
        sys.path.insert(0, sys.argv[3])
        from multi_modal_foundation_model_tpu_torch.ops import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build(build.kernel_sources())
        ab_worker(sys.argv[2], root / "build")
        return 0
    sys.path.insert(0, str(root))
    from multi_modal_foundation_model_tpu_torch.ops import build
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    build_s = build.build(build.kernel_sources())
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s,
         build_wall_s=time.perf_counter() - t0, tf32=False,
         layernorm_default=ln.PALLAS_LAYERNORM)

    k1 = k1_phase()
    k1_train, k2 = train_kernels_phase()
    k3, k4 = ln_phase()
    out = root / "build"
    f32, bf16 = torch.float32, torch.bfloat16
    # f32 under the port's default LayerNorm mode, bf16 (mm.yaml) under
    # "full", each main path with its launch counts
    default = ln.PALLAS_LAYERNORM
    eval_f32 = eval_phase(out / "chip_smoke_eval_f32", f32, default)
    eval_bf16 = eval_phase(out / "chip_smoke_eval_bf16", bf16, "full")
    train_f32 = train_phase(out, f32, default)
    train_bf16 = train_phase(out, bf16, "full")
    kernel_vs_plain_step(out, f32, default)
    kernel_vs_plain_step(out, bf16, "full")
    plain_step_time(out)
    picks = {dtype_name(dt): layernorm_ab(out, dt) for dt in (f32, bf16)}
    emit(phase="layernorm_default", rule_pick_at_b256=picks,
         default_in_code=default)
    paths = dict(eval_f32=eval_f32, eval_bf16=eval_bf16,
                 train_f32=train_f32, train_bf16=train_bf16)

    src = "multi_modal_foundation_model_tpu_torch/csrc/"
    attn_py = "multi_modal_foundation_model_tpu/ops/attention.py"
    ln_py = "multi_modal_foundation_model_tpu/ops/layernorm.py"
    kernels = [
        dict(name="attention_fwd (K1, eval: no dropout, no lse), f32",
             route="cuda", source=src + "attention_fwd.cu",
             replaces=attn_py + ":144", launches=eval_f32["k1"],
             **_row(k1[f32])),
        dict(name="attention_fwd (K1, eval), bf16: tensor cores (mma.sync "
             "m16n8k16 bf16, ldmatrix, cp.async)", route="cuda",
             source=src + "attention_fwd.cu", replaces=attn_py + ":144",
             launches=eval_bf16["k1"], **_row(k1[bf16])),
        dict(name="attention_fwd (K1, training: dropout 0.4, lse), f32",
             route="cuda", source=src + "attention_fwd.cu",
             replaces=attn_py + ":144", launches=train_f32["k1"],
             **_row(k1_train[f32])),
        dict(name="attention_fwd (K1, training), bf16: tensor cores "
             "(mma.sync m16n8k16 bf16, ldmatrix, cp.async)", route="cuda",
             source=src + "attention_fwd.cu", replaces=attn_py + ":144",
             launches=train_bf16["k1"], **_row(k1_train[bf16])),
        dict(name="attention_bwd (K2), f32: tensor cores (3xTF32: mma.sync "
             "m16n8k8 tf32, hi/lo split, cp.async)", route="cuda",
             source=src + "attention_bwd.cu", replaces=attn_py + ":221",
             launches=train_f32["k2"], **_row(k2[f32])),
        dict(name="attention_bwd (K2), bf16: tensor cores (mma.sync "
             "m16n8k16 bf16, ldmatrix, cp.async)", route="cuda",
             source=src + "attention_bwd.cu", replaces=attn_py + ":221",
             launches=train_bf16["k2"], **_row(k2[bf16])),
        dict(name="layernorm_fwd (K3), bf16 at 51,200 x 256", route="cuda",
             source=src + "layernorm.cu", replaces=ln_py + ":100",
             launches=sum(c["k3"] for c in paths.values()),
             launches_by_path={k: c["k3"] for k, c in paths.items()},
             f32_ms=k3[f32]["ms"], **_row(k3[bf16])),
        dict(name="layernorm_bwd (K4), bf16 at 51,200 x 256", route="cuda",
             source=src + "layernorm.cu", replaces=ln_py + ":109",
             launches=sum(c["k4"] for c in paths.values()),
             launches_by_path={k: c["k4"] for k, c in paths.items()},
             f32_ms=k4[f32]["ms"], **_row(k4[bf16])),
    ]
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError("a kernel of the main paths never launched")
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
