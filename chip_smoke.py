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
   and bf16 (all four on the tensor cores: bf16 each held against the plain
   version with JAX's bf16 dots and the f32-dots one, f32 in 3xTF32 against
   the f32 one; each K1's lse against the scores K2 recomputes,
   ``k1_lse_row_sums``), dropout 0 and 0.4 on the same Philox bits as the
   plain versions; K3/K4,
   the LayerNorm forward and backward
   (``k3_k4_check``/``k3_k4_time``), at the B=256 and B=16 steps' 51,200
   and 3,200 x 256 tokens, a row fewer each, one row and 1,001 x 64, f32
   and bf16, with dx, dweight and dbias bit-equal from one launch to the
   next; timed at 51,200 and 3,200 rows, K4 also kernel by kernel.
   Tolerances: f32 1e-5, bf16 2e-2 (see each check's docstring).
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
5. dispatch — the trainer's host-dispatch options: ``host_split`` splits
   the eager B=16 step's host time by kind (CPU side of torch.profiler)
   beside its wall time with and without remat; ``dispatch`` trains the
   resident path with K=10 steps a dispatch as CUDA graphs, f32 and bf16,
   full MtM menu with mixed training, epoch 0, save, epoch 1, restore in
   place, epoch 1 again, epoch 2, against the same steps run eagerly (per
   step loss and per parameter, bit for bit or within the stated gates;
   the graph path's launches counted by kernel name in a profile);
   ``dispatch_time`` times the eager step against the graph step at B=16
   and B=256, f32 and bf16, one variant, interleaved, with profiles, the
   capture seconds and the peak memory; ``prefetch_check`` runs the
   host-batch path with ``prefetch_depth=2`` against the same epochs
   without it; ``philox_check`` holds the Philox draw kernel against its
   plain version and times it. The SDPA
   yardsticks run on a pinned backend (``SDPA_BACKEND``).

The second-to-last line repeats the ``nvidia-smi`` reading; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
The port never imports JAX, and neither does this script.

    python3 chip_smoke.py --ab OTHER_CHECKOUT

compares this checkout's port with another's (say the parent commit's,
unpacked by ``git archive`` into a git-ignored directory) on one card: four
processes in the order other, this, this, other, each importing its own
checkout's package and building its kernels, each timing K3 and K4 alone
at 51,200 and 3,200 x 256 in f32 and bf16 (``ab_layernorm``), the bf16
training step under ``"full"`` at B=16 and B=256, the bf16 sweep-chunk forward
under ``"full"``, and the f32 sweep-chunk forward and training step at
B=256 under the port's default LayerNorm mode (``ab_step`` /
``ab_sweep_chunk`` lines, with profiles).

    python3 chip_smoke.py --host-split OTHER_CHECKOUT

runs ``host_split`` (the eager B=16 step's host time by kind, f32 and
bf16) on the other checkout's port, then on this one, one process each.
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


# the library yardstick's SDPA backend, pinned so that every run times the
# same kernels (memory-efficient attention takes the additive bias and
# dropout in f32 and bf16, forward and backward)
SDPA_BACKEND = "EFFICIENT_ATTENTION"


def sdpa(*args, **kwargs):
    """``F.scaled_dot_product_attention`` on ``SDPA_BACKEND`` only (it
    raises if that backend cannot run the call)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([getattr(SDPBackend, SDPA_BACKEND)]):
        return F.scaled_dot_product_attention(*args, **kwargs)


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
    span kernels counted on their own. The lead-in of ``traced`` is left
    out."""
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False) \
                and LEAD_IN_KERNEL not in evt.name:
            yield evt.name, evt.time_range.elapsed_us() / 1e3


# torch.profiler (torch 2.11+cu128 on an H100 80GB HBM3) loses the first
# device records of a trace, more the longer the process has run: of 20
# short kernels it lost none at 3 s, 5 at 71 s, 9 at 132 s, 14 at 194 s,
# up to 19 at 255 s (scripts/torch_profiler_loss.py); host sleep before
# and after the traced work does not help. The loss is a count of records,
# not a span of time: a lead-in of 100 us spin kernels lost as many as the
# 1.4 us draws did. ``traced`` opens each trace with LEAD_IN spin kernels
# (~10 us each) that take that loss, and refuses a trace that lost all of
# them. Rarely a trace also loses records after a caught lead-in kernel
# (in that script, once in 30 traces: all 20 draws), so each caller checks
# what it counts as well and traces again: ``device_ms_by_kernel`` (each
# kernel's count a multiple of the calls), ``device_breakdown`` (the fuller
# of two kept traces), ``dispatch_phase`` (the launches a step).
LEAD_IN = 256
LEAD_IN_CYCLES = 20_000
LEAD_IN_KERNEL = "spin_kernel"     # torch.cuda._sleep's kernel
TRACE_LOSSES: list = []            # lead-in kernels lost, trace by trace


class TraceLost(RuntimeError):
    """A trace lost its whole lead-in, so it may have lost records of the
    work it traced too."""


@contextlib.contextmanager
def traced(cpu: bool = False):
    """``torch.profiler.profile`` of the body (device activity, the host's
    too with ``cpu``), opened by the lead-in; raises ``TraceLost`` when no
    lead-in kernel came back."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
    caught = sum(1 for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA
                 and LEAD_IN_KERNEL in evt.name)
    TRACE_LOSSES.append(LEAD_IN - caught)
    if caught == 0:
        raise TraceLost(f"the trace lost all {LEAD_IN} lead-in kernels")


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device time per call of ``fn`` by kernel name: the durations of the
    kernels it launches, from a ``traced`` run of ``reps`` calls. For
    kernels of tens of microseconds, whose wrappers take about as long on
    the host, CUDA events would time the host's launch rate instead. A
    trace is taken again (up to 5 times) when it lost its lead-in or when
    a kernel's count is not a multiple of ``reps`` (each call launches the
    same kernels)."""
    fn()
    torch.cuda.synchronize()
    why = ""
    for _ in range(5):
        try:
            with traced() as prof:
                for _ in range(reps):
                    fn()
        except TraceLost as e:
            why = str(e)
            continue
        ms_by: dict = {}
        count: dict = {}
        for name, ms in _device_events(prof):
            ms_by[name] = ms_by.get(name, 0.0) + ms / reps
            count[name] = count.get(name, 0) + 1
        if ms_by and all(c % reps == 0 for c in count.values()):
            return ms_by
        why = f"kernel counts {count} over {reps} calls"
    raise RuntimeError(f"no whole trace in five: {why}")


def device_ms(fn, reps: int = 20) -> float:
    """``device_ms_by_kernel`` summed: device ms of every kernel a call of
    ``fn`` launches."""
    return sum(device_ms_by_kernel(fn, reps).values())


def device_breakdown(fn, top: int = 6) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler, CUPTI
    tracing), grouped as K1 / K2 / K3 / K4 / GEMM / other by kernel name,
    beside the host wall time of the same profiled call (so the idle share
    includes profiler cost)."""
    fn()
    torch.cuda.synchronize()
    best, kept = None, 0
    for _ in range(4):      # the fuller of two kept traces (see ``traced``)
        try:
            with traced(cpu=True) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        except TraceLost:
            continue
        events = list(_device_events(prof))
        if best is None or len(events) > len(best[0]):
            best = (events, wall_ms)
        kept += 1
        if kept == 2:
            break
    if best is None:
        raise RuntimeError("device_breakdown: four traces were lost")
    events, wall_ms = best
    by_name: dict = {}
    for name, ms in events:
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


def _tc_bound(bytes_moved: float, flops: float, dtype) -> dict:
    """The bound of a tensor-core attention kernel. bf16: ``_bound``. f32
    runs each product as three TF32 tensor-core products (3xTF32): 3 x the
    operations at the TF32 peak, with the same products on the CUDA cores
    (f32 peak) beside it as ``bound_cuda_core_ms``."""
    if dtype != torch.float32:
        return _bound(bytes_moved, flops, dtype)
    return dict(_bound(bytes_moved, 3 * flops, peak=PEAK_TF32_FLOPS),
                bound_cuda_core_ms=flops / PEAK_FLOPS[dtype] * 1e3)


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

    from multi_modal_foundation_model_tpu_torch.ops import random as rnd

    att.K1_LAUNCHES = att.K2_LAUNCHES = 0
    ln.K3_LAUNCHES = ln.K4_LAUNCHES = 0
    rnd.PHILOX_LAUNCHES = 0


def read_counts() -> dict:
    from multi_modal_foundation_model_tpu_torch.ops import attention as att
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    from multi_modal_foundation_model_tpu_torch.ops import random as rnd

    return dict(k1=att.K1_LAUNCHES, k2=att.K2_LAUNCHES, k3=ln.K3_LAUNCHES,
                k4=ln.K4_LAUNCHES, philox=rnd.PHILOX_LAUNCHES)


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
    and Philox bits. f32 (3xTF32): out and lse atol 1e-5 (f32 products to
    about f32 accuracy, summed in other orders; out is a convex combination
    of V's rows and lse = m + log(l), so no relative term). bf16 (the tensor-core K1, with JAX's bf16
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
    """What K2 relies on: with the scores K2 recomputes, every row that
    attends anything has ``sum_k exp(s - lse) = 1`` against K1's lse
    (dropout 0). bf16: the bf16-dots scores (``s = bf16(q * scale) .
    bf16(k) + bias``), within 1e-3. f32: the f32 scores (cuBLAS in f32,
    TF32 off; K2's 3xTF32 ones are within a few ulps of them), within
    1e-5 + Tk 2^-24: K1's lse gate (1e-5) moves every exp(s - lse) by a
    factor within 1 +- 1e-5, and the f32 sum of Tk terms rounds by up to
    Tk 2^-24."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    B, Tq, hidden = q.shape
    Tk, D = k.shape[1], hidden // H

    def heads(x):
        return x.unflatten(-1, (H, D)).transpose(1, 2).float()

    qs = heads(q) * scale
    if q.dtype == torch.bfloat16:
        qs = qs.bfloat16().float()
        tol = 1e-3
    else:
        tol = 1e-5 + Tk * 2.0 ** -24
    s = (qs @ heads(k).transpose(-1, -2)
         + att._attend_bias(key_pad, static)[:, None])
    sums = torch.exp(s - lse[..., None]).sum(-1)            # (B, H, Tq)
    del s
    rows = (static.bool()[None] | key_pad.bool()[:, None]).any(-1)
    err = (sums - 1).abs()[rows[:, None].expand_as(sums)].max().item()
    return dict(row_sum_max_abs_err=err, rows=int(rows.sum()) * H,
                tolerance=tol, ok=err <= tol)


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
        library_ms = cuda_time_ms(lambda: sdpa(qh, kh, vh, attn_mask=bias))
        # least time for the same work: each input read once, the output
        # written once; the two products' flops as ``_tc_bound`` counts them
        elem = q.element_size()
        bytes_moved = ((2 * B * Tq + 2 * B * Tk) * hidden * elem
                       + key_pad.numel() * 4 + static.numel() * 4)
        flops = 4 * B * H * Tq * Tk * D
        b = _tc_bound(bytes_moved, flops, dtype)
        emit(phase="k1_time", shape=[B, Tq, Tk, H, D],
             dtype=dtype_name(dtype), ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, sdpa_backend=SDPA_BACKEND,
             bytes=bytes_moved, flops=flops, **b)
        rows[dtype] = dict(max_abs_err=worst[dtype], ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms, **b)
    return rows


# ---------------------------------------------------------------------------
# phase 2b: K1 with dropout and lse, K2, against their plain versions
# ---------------------------------------------------------------------------

def train_kernels_phase():
    """K1 (dropout, lse) and K2 at the training step's shapes (B=256,
    Tq=Tk=200, H=8, D=32), f32 and bf16, each case at dropout 0 and 0.4
    against the plain versions on the same Philox bits. K1 as ``k1_gates``
    says, and at dropout 0 its lse against the scores K2 recomputes
    (``lse_row_sums``). f32 K2: atol 1e-5 on dq, dk, dv (3xTF32 products
    summed in other orders). bf16: the tensor-core K2's dq/dk/dv within
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
                if rate == 0.0:
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

        def lib():
            return sdpa(qh, kh, vh, attn_mask=bias, dropout_p=DROPOUT)

        lib_fwd = cuda_time_ms(lambda: lib().detach())
        lib_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            lib(), (qh, kh, vh), gh))
        # bounds: each input read once, each output written once; the
        # products as ``_tc_bound`` counts them (the Philox draws not
        # counted)
        elem = q.element_size()
        masks = key_pad.numel() * 4 + static.numel() * 4
        lse_bytes = B * H * Tq * 4
        # K1: q, k, v in, out and lse out; two products
        k1_b = _tc_bound(B * (2 * Tq + 2 * Tk) * hidden * elem + lse_bytes
                         + masks, 4 * B * H * Tq * Tk * D, dtype)
        # K2: q, g, k, v, lse in; dq, dk, dv out; five products
        k2_b = _tc_bound(B * (3 * Tq + 4 * Tk) * hidden * elem + lse_bytes
                         + masks, 10 * B * H * Tq * Tk * D, dtype)
        emit(phase="k1_train_time", dtype=dtype_name(dtype),
             shape=[B, Tq, Tk, H, D], dropout=DROPOUT, with_lse=True,
             ms=k1_ms, plain_ms=k1_plain, library_ms=lib_fwd,
             sdpa_backend=SDPA_BACKEND, **k1_b)
        emit(phase="k2_time", dtype=dtype_name(dtype),
             shape=[B, Tq, Tk, H, D], dropout=DROPOUT, ms=k2_ms,
             ms_dropout0=k2_ms_rate0, plain_ms=k2_plain,
             library_ms=lib_fwd_bwd - lib_fwd,
             library_fwd_bwd_ms=lib_fwd_bwd, sdpa_backend=SDPA_BACKEND,
             **k2_b)
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


def _normwise(a, r) -> float:
    return ((a - r).abs().max() / r.abs().max()).item()


def k4_gates(x, w, dy, got, again, tol: float, eps: float = 1e-5) -> dict:
    """K4's outputs ``got`` = (dx, dweight, dbias) against
    ``layer_norm_bwd_reference``: dx within tol (1 + |plain|) and in x's
    dtype, dweight and dbias normwise within 1e-5 (max |kernel - plain| <=
    1e-5 max |plain|: sums over every row), and the same bits as a second
    launch ``again``."""
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    dx, dw, db = got
    dx_ref, dw_ref, db_ref = ln.layer_norm_bwd_reference(x, w, dy, eps)
    errs = dict(dx_max_abs_err=(dx.float() - dx_ref.float()).abs().max()
                .item(), dw_normwise_err=_normwise(dw, dw_ref),
                db_normwise_err=_normwise(db, db_ref))
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    ok = (_excess(dx, dx_ref, tol) <= 0 and dx.dtype == x.dtype
          and errs["dw_normwise_err"] <= 1e-5
          and errs["db_normwise_err"] <= 1e-5 and same)
    return dict(errs, bit_equal_across_launches=same, ok=ok)


def k4_bound(rows: int, width: int, dtype) -> dict:
    """K4's bound: x and g read and dx written once, the f32 scale read and
    dscale and dbias written once; ~14 operations a value."""
    n = rows * width
    nbytes = 3 * n * torch.empty((), dtype=dtype).element_size() \
        + 3 * width * 4
    return dict(_bound(nbytes, 14 * n, dtype), bytes=nbytes)


def ln_time(rows: int, width: int, dtype) -> dict:
    """K3 and K4 at (rows, width) in ``dtype``, beside their plain versions
    and the library's LayerNorm forward and backward: device ms of every
    kernel a call launches, K4's also kernel by kernel
    (``device_ms_by_kernel``), and the bounds, GB/s and shares of them."""
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    eps = 1e-5
    x, w, b, dy = _ln_operands(rows, width, dtype, seed=5)
    # library yardsticks (never called by the port): torch's own LayerNorm
    # forward and backward (two-pass variance), parameters in x's dtype
    wl, bl = w.to(dtype), b.to(dtype)
    _, mean, rstd = torch.native_layer_norm(x, [width], wl, bl, eps)
    calls = dict(
        k3=lambda: ln.layernorm_fwd(x, w, b, eps, dtype),
        k3_plain=lambda: ln.layer_norm(x, w, b, eps, dtype),
        k3_library=lambda: F.layer_norm(x, (width,), wl, bl, eps),
        k4=lambda: ln.layernorm_bwd(x, w, dy, eps),
        k4_plain=lambda: ln.layer_norm_bwd_reference(x, w, dy, eps),
        k4_library=lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [width], mean, rstd, wl, bl, [True, True, True]))
    by_kernel = {k: device_ms_by_kernel(fn) for k, fn in calls.items()}
    dev = {k: sum(v.values()) for k, v in by_kernel.items()}
    # K3: x in and y out, the f32 parameters once; ~7 operations a value
    # (the two sums and the affine map). K4: ``k4_bound``
    n = rows * width
    k3_b = _bound(2 * n * x.element_size() + 2 * width * 4, 7 * n, dtype)
    k4_b = k4_bound(rows, width, dtype)
    return dict(dev=dev, k4_by_kernel_ms=by_kernel["k4"], k3_bound=k3_b,
                k4_bound=k4_b,
                k4_gb_per_s=k4_b["bytes"] / dev["k4"] / 1e6,
                k4_share_of_bound=k4_b["bound_ms"] / dev["k4"],
                k3_share_of_bound=k3_b["bound_ms"] / dev["k3"])


def ln_phase():
    """K3 and K4 at the training step's token counts, 51,200 x 256 (B=256)
    and 3,200 x 256 (B=16), at 51,199 and 3,199 rows (K4's last tile
    short), one row, and 1,001 x 64, in f32 and bf16. y and dx: |kernel -
    plain| <= tol (1 + |plain|), tol 1e-5 (f32) / 2e-2 (bf16), as the JAX
    package's LayerNorm tests; dweight and dbias are sums over every row,
    held normwise (max |kernel - plain| <= 1e-5 max |plain|), and dx,
    dweight and dbias are bit-equal from one launch to the next
    (``k4_gates``). Then timings at both training shapes (``ln_time``)."""
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    eps = 1e-5
    H = GEOMETRY["hidden_size"]
    tokens = len(GEOMETRY["n_channels"]) * GEOMETRY["max_F"]
    rows_main, rows_b16 = BIG_B * tokens, TRAIN_B * tokens
    worst = {3: dict.fromkeys(DTYPES, 0.0), 4: dict.fromkeys(DTYPES, 0.0)}
    for dtype in DTYPES:
        tol = TOL[dtype]
        for rows, width in ((rows_main, H), (rows_main - 1, H),
                            (rows_b16, H), (rows_b16 - 1, H), (1, H),
                            (1001, 64)):
            x, w, b, dy = _ln_operands(rows, width, dtype, seed=rows)
            y = ln.layernorm_fwd(x, w, b, eps, dtype)
            got = ln.layernorm_bwd(x, w, dy, eps)
            again = ln.layernorm_bwd(x, w, dy, eps)
            torch.cuda.synchronize()
            y_ref = ln.layer_norm(x, w, b, eps, dtype)
            gates = k4_gates(x, w, dy, got, again, tol, eps)
            y_err = (y.float() - y_ref.float()).abs().max().item()
            ok = (gates["ok"] and _excess(y, y_ref, tol) <= 0
                  and y.dtype == dtype)
            emit(phase="k3_k4_check", dtype=dtype_name(dtype),
                 shape=[rows, width], tol=tol, y_max_abs_err=y_err,
                 **dict(gates, ok=ok))
            if not ok:
                raise AssertionError(f"K3/K4 disagree with their plain "
                                     f"versions ({rows}, {width}, {dtype})")
            worst[3][dtype] = max(worst[3][dtype], y_err)
            worst[4][dtype] = max(worst[4][dtype], gates["dx_max_abs_err"])

    rows3, rows4, rows4_b16 = {}, {}, {}
    for dtype in DTYPES:
        for rows in (rows_main, rows_b16):
            t = ln_time(rows, H, dtype)
            n_sm, per_sm = ln._k4_card(ln._lib(), torch.device("cuda", 0),
                                       H, dtype)
            emit(phase="k3_k4_time", dtype=dtype_name(dtype),
                 shape=[rows, H], device_ms=t["dev"],
                 k4_by_kernel_ms=t["k4_by_kernel_ms"],
                 k3_bound_ms=t["k3_bound"]["bound_ms"],
                 k4_bound_ms=t["k4_bound"]["bound_ms"],
                 k3_share_of_bound=t["k3_share_of_bound"],
                 k4_share_of_bound=t["k4_share_of_bound"],
                 k4_gb_per_s=t["k4_gb_per_s"],
                 k4_plan=ln._k4_plan(rows, n_sm, per_sm)._asdict(),
                 k4_blocks_per_sm=per_sm, sm_count=n_sm)
            dev = t["dev"]
            k4_row = dict(max_abs_err=worst[4][dtype], ms=dev["k4"],
                          plain_ms=dev["k4_plain"],
                          library_ms=dev["k4_library"], **t["k4_bound"])
            if rows == rows_b16:
                rows4_b16[dtype] = k4_row
                continue
            rows3[dtype] = dict(max_abs_err=worst[3][dtype], ms=dev["k3"],
                                plain_ms=dev["k3_plain"],
                                library_ms=dev["k3_library"], **t["k3_bound"])
            rows4[dtype] = k4_row
    return rows3, rows4, rows4_b16


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


def _trainer(cfg, loader, val_loader, epochs, log_dir, tcfg_over=None,
             **model_kw):
    from multi_modal_foundation_model_tpu_torch.models import MultiModal
    from multi_modal_foundation_model_tpu_torch.train import (
        MetricLogger, MultiModalTrainer, OptimizerConfig, TrainerConfig)

    model = MultiModal(cfg, generator=torch.Generator().manual_seed(SEED),
                       **model_kw)
    tcfg = TrainerConfig(**{**dict(
        num_epochs=epochs, mask_type="input", mask_mode=MTM_MENU,
        mixed_training=True, seed=SEED, log_dir=str(log_dir)),
        **(tcfg_over or {})})
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
          and steps == counts["train"] == len(losses)
          and {k: launches[k] for k in want} == want
          and launches["philox"] > 0)
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


# ---------------------------------------------------------------------------
# phase 5: the host-dispatch options (resident split, CUDA-graph steps)
# ---------------------------------------------------------------------------

# the resident path's K (steps per dispatch) in this phase
DISPATCH_K = 10
# a name per launch of each wrapper (K2 and K4 launch two kernels each:
# their first is counted)
_KERNEL_GROUPS = (("k1", "attn_fwd_"), ("k2", "attn_bwd_dq_"),
                  ("k3", "ln_fwd_kernel"), ("k4", "ln_bwd_dx_"),
                  ("philox", "philox_"))


def kernel_counts(prof) -> dict:
    """Launches of the port's kernels in a profile, by kernel name (graph
    replays included: the wrappers' counters see only Python calls)."""
    counts = dict.fromkeys((g for g, _ in _KERNEL_GROUPS), 0)
    for name, _ in _device_events(prof):
        for group, key in _KERNEL_GROUPS:
            if key in name:
                counts[group] += 1
    return counts


def _launches_ok(counts: dict, steps: int, want: dict) -> bool:
    """The profiled epoch launched ``want`` of K1-K4 a step, and Philox."""
    return ({k: counts[k] / steps for k in want} == want
            and counts["philox"] > 0)


class _EagerSteps:
    """The graph path's yardstick in this script only: a ``StepGraphs``
    stand-in that runs every step of the resident path eagerly on the
    current stream."""

    def __init__(self):
        self.graphs, self.capture_s, self.replays = {}, {}, 0

    def run(self, key, step):
        step()


def _train_loaders(B: int = TRAIN_B):
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)

    T, N = GEOMETRY["max_F"], GEOMETRY["n_channels"]["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                              n_timesteps=T)
    kw = dict(batch_size=B, max_time_length=T, max_space_length=N)
    return (make_loader(splits.train, seed=SEED, **kw),
            make_loader(splits.val, shuffle=False, **kw))


def dispatch_phase(root: Path, dtype, mode: str) -> dict:
    """The resident path with K = 10 steps a dispatch at full width (B=16,
    dropout 0.4, remat, the full MtM menu with mixed training), as CUDA
    graphs and as the same steps run eagerly: epoch 0, save, epoch 1,
    restore the save in place (the graphs are kept), epoch 1 again, epoch
    2, then the resident eval. The graph run's repeated epoch 1 must equal
    its first bit for bit (a replay after a restore), and the graph run
    must equal the eager run per step loss and per parameter, bit for bit
    or within the gates: f32 loss rtol 1e-5 and parameters atol 2e-5 (the
    JAX lockstep's gate), bf16 loss rtol 1e-2 and each parameter within 5e-2
    relative L2 (the bf16 kernel-vs-plain step gate); the attention key
    biases, whose exact gradient is 0, are left out of the parameter gates.
    The repeated epoch 1 is profiled: on the graph path all its steps are
    replays, and its kernel counts by name are the graph path's launches.
    Returns them."""
    cfg = _cfg(dtype)
    train_l, val_l = _train_loaders()
    over = dict(device_resident_data=True, steps_per_dispatch=DISPATCH_K)
    want = dict(k1=2 * K1_ATTN_PER_FORWARD, k2=K1_ATTN_PER_FORWARD,
                k3=K3_PER_STEP if mode == "full" else 0,
                k4=K4_PER_STEP if mode in ("bwd", "full") else 0)
    runs = {}
    for path in ("graph", "eager"):
        log_dir = root / f"dispatch_{path}_{dtype_name(dtype)}"
        shutil.rmtree(log_dir, ignore_errors=True)
        with ln_mode(mode):
            tr = _trainer(cfg, train_l, val_l, 3, log_dir, tcfg_over=over)
            if path == "eager":
                tr.graphs = _EagerSteps()
            t0 = time.perf_counter()
            losses = tr.train_epoch(0)["step_losses"]
            tr.save_model("last", epoch=0)
            first = tr.train_epoch(1)["step_losses"]
            # epoch 1 again: every variant it draws was captured the first
            # time, so on the graph path each of its steps is a replay.
            # Restored and run again (up to 3 times) when its trace lost
            # launches (``traced``); the replays are exact, so the state
            # after the last run is the same
            counts = None
            for _ in range(3):
                epoch = tr.restore("last")
                replays = tr.graphs.replays
                try:
                    with traced() as prof:
                        again = tr.train_epoch(1)["step_losses"]
                except TraceLost:
                    continue
                counts = kernel_counts(prof)
                if _launches_ok(counts, len(again), want):
                    break
            replays = tr.graphs.replays - replays
            last = tr.train_epoch(2)["step_losses"]
            ev = tr.eval_epoch()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[path] = dict(
            losses=losses + first + again + last, replay_exact=again == first,
            restored_epoch=epoch, params={
                n: p.detach().clone()
                for n, p in tr.model.state_dict().items()},
            counts=counts, steps_profiled=len(again),
            replays_profiled=replays,
            variants=len(tr.graphs.graphs), replays=tr.graphs.replays,
            capture_s=list(tr.graphs.capture_s.values()), wall_s=wall,
            eval_loss=ev["eval_loss"], eval_r2=ev["eval_trial_avg_r2"])
        del tr
        torch.cuda.empty_cache()
    g, e = runs["graph"], runs["eager"]
    bit_losses = g["losses"] == e["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                       e["losses"]))
    bit_params = sum(not torch.equal(g["params"][n], e["params"][n])
                     for n in g["params"])
    gated = [n for n in g["params"] if not n.endswith("key.bias")]
    param_abs = max((g["params"][n].float() - e["params"][n].float())
                    .abs().max().item() for n in gated)
    param_rel = max(((g["params"][n].float() - e["params"][n].float())
                     .norm() / e["params"][n].float().norm().clamp_min(
                         1e-30)).item() for n in gated)
    if dtype == torch.float32:
        gate_ok = loss_rel <= 1e-5 and param_abs <= 2e-5
        gate = dict(loss_rtol=1e-5, param_atol=2e-5)
    else:
        gate_ok = loss_rel <= 1e-2 and param_rel <= 5e-2
        gate = dict(loss_rtol=1e-2, param_rel_l2=5e-2)
    finite = all(math.isfinite(x) for x in g["losses"])
    counts_ok = g["counts"] is not None and _launches_ok(
        g["counts"], g["steps_profiled"], want)
    per_step = {k: v / g["steps_profiled"]
                for k, v in (g["counts"] or {}).items()}
    ok = (finite and gate_ok and g["replay_exact"] and e["replay_exact"]
          and g["replays_profiled"] == g["steps_profiled"] and counts_ok)
    emit(phase="dispatch", dtype=dtype_name(dtype), layernorm=mode,
         batch=TRAIN_B, steps_per_dispatch=DISPATCH_K,
         steps=len(g["losses"]), graph_losses=g["losses"],
         losses_bit_equal=bit_losses, loss_max_rel_err=loss_rel,
         params_not_bit_equal=bit_params, n_params=len(g["params"]),
         param_max_abs_err=param_abs, param_max_rel_l2=param_rel, **gate,
         replay_after_restore_exact=g["replay_exact"],
         eager_rerun_exact=e["replay_exact"], variants=g["variants"],
         replays=g["replays"], capture_s=g["capture_s"],
         graph_wall_s=g["wall_s"], eager_wall_s=e["wall_s"],
         launches_profiled_epoch=g["counts"],
         replays_in_profiled_epoch=g["replays_profiled"],
         launches_per_step=per_step,
         launches_per_step_expected=want, eval_loss=g["eval_loss"],
         eval_loss_eager=e["eval_loss"], eval_trial_avg_r2=g["eval_r2"],
         device=torch.cuda.get_device_name(0), ok=ok)
    if not ok:
        raise AssertionError("dispatch phase: graph vs eager, replay after "
                             "restore or launches off (see its line)")
    return g["counts"]


def dispatch_time(root: Path, dtype, mode: str) -> None:
    """The eager step against the graph step at B=16 and B=256, one variant
    (MtM ``temporal`` alone, no mixed training): one resident trainer whose
    segments are a dispatch of K = 10 graph replays, one host-batch
    trainer whose segments are 10 eager steps on a batch already on the
    card, interleaved eager, graph, graph, eager (4 passes each); medians
    and spreads of the segments' ms per step; a profile of one segment
    each (device busy and idle share); capture seconds per variant, the
    variant count and the peak memory of the graph path."""
    cfg = _cfg(dtype)
    one = dict(mask_mode=("temporal",), mixed_training=False)
    for B in (TRAIN_B, BIG_B):
        loader = _step_loaders(B)
        with ln_mode(mode):
            eager = _trainer(cfg, loader, None, 1, root / "dispatch_time",
                             tcfg_over=one)
            step = _step_fn(eager)
            graph = _trainer(cfg, loader, None, 1, root / "dispatch_time",
                             tcfg_over=dict(one, device_resident_data=True,
                                            steps_per_dispatch=DISPATCH_K))
            data = graph._device_data(loader)
            idx, valid, _ = next(loader.iter_index_batches())
            group = [(idx, valid, 0)] * DISPATCH_K

            def seg_eager():
                for _ in range(DISPATCH_K):
                    step()

            def seg_graph():
                graph._dispatch(data, group, None)

            for seg in (seg_eager, seg_graph, seg_eager, seg_graph):
                seg()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            segs = {"eager": [], "graph": []}
            for p in range(4):
                for name in (("eager", "graph") if p % 2 == 0
                             else ("graph", "eager")):
                    fn = seg_eager if name == "eager" else seg_graph
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    segs[name].append((time.perf_counter() - t0) * 1e3
                                      / DISPATCH_K)
            peak = torch.cuda.max_memory_allocated() / 1e9
            prof = {name: device_breakdown(fn, top=6) for name, fn in
                    (("eager", seg_eager), ("graph", seg_graph))}
        med = {k: float(np.median(v)) for k, v in segs.items()}
        emit(phase="dispatch_time", dtype=dtype_name(dtype), layernorm=mode,
             batch=B, steps_per_segment=DISPATCH_K, segments_ms=segs,
             ms_per_step=med, spread_ms={k: max(v) - min(v)
                                         for k, v in segs.items()},
             seq_per_s={k: B / v * 1e3 for k, v in med.items()},
             device_busy_ms_per_step={
                 k: v["device_busy_ms"] / DISPATCH_K
                 for k, v in prof.items()},
             idle_share={k: v["idle_share"] for k, v in prof.items()},
             variants=len(graph.graphs.graphs),
             capture_s=list(graph.graphs.capture_s.values()),
             peak_mem_gb=peak, device=torch.cuda.get_device_name(0))
        for name, p in prof.items():
            emit(phase="dispatch_profile", dtype=dtype_name(dtype),
                 layernorm=mode, batch=B, path=name,
                 steps=DISPATCH_K, **p)
        del eager, graph, step, data
        torch.cuda.empty_cache()


# host time by kind, by the CPU events of torch.profiler: Python time lands
# in the event around it (an autograd Function's, a backward node's: the
# remat recompute runs inside the first backward node that needs a saved
# tensor of its layer)
_SPLIT = (("cuda_runtime", ("cuda", "cu")),
          ("port_kernel_wrappers", ("_FlashAttention", "_KernelLayerNorm",
                                    "_BwdKernelLayerNorm", "ops/attention.py",
                                    "ops/layernorm.py", "ops/random.py")),
          ("checkpoint", ("torch/utils/checkpoint.py", "Checkpoint")),
          ("generator", ("Generator", "manual_seed")),
          ("casts_copies", ("aten::to", "aten::_to_copy", "aten::copy_",
                            "<built-in method to of")),
          ("optimizer", ("train/schedule.py", "aten::_foreach", "optim/",
                         "Optimizer")),
          ("backward_nodes_and_remat", ("Backward",)),
          ("autograd_engine", ("run_backward", "autograd::engine")),
          ("aten_other", ("aten::",)))


def _split_group(name: str) -> str:
    for group, keys in _SPLIT:
        if any(name.startswith(k) if k in ("cuda", "cu", "aten::",
                                           "_FlashAttention",
                                           "_KernelLayerNorm",
                                           "_BwdKernelLayerNorm")
               else k in name for k in keys):
            return group
    return "python_other"


def _wall_ms(step, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def host_split(tag: str, step, dtype, no_remat_step=None,
               reps: int = 3) -> dict:
    """The eager step's host time by kind, from the CPU side of
    torch.profiler: self CPU ms per step of every event, summed by
    ``_split_group`` (the main thread and autograd's thread together, so
    the sum can exceed the wall time, and the profiler slows the step:
    the shares, not the sums, are the reading); beside it the untraced
    wall ms per step and, with ``no_remat_step`` (the same step without
    remat), both steps' wall ms in 3 interleaved rounds of 5 (what
    ``torch.utils.checkpoint`` costs whole) and the number of kernel
    launches a step (``cudaLaunchKernel`` and kin)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    wall = _wall_ms(step, reps)
    remat = {}
    if no_remat_step is not None:
        no_remat_step()
        rounds = {"remat": [], "no_remat": []}
        for _ in range(3):
            rounds["remat"].append(_wall_ms(step, 5))
            rounds["no_remat"].append(_wall_ms(no_remat_step, 5))
        remat = dict(wall_ms_rounds=rounds, wall_ms_median={
            k: float(np.median(v)) for k, v in rounds.items()})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    groups = dict.fromkeys([g for g, _ in _SPLIT] + ["python_other"], 0.0)
    top, launches = [], 0
    for evt in prof.key_averages():
        ms = evt.self_cpu_time_total / 1e3 / reps
        group = _split_group(evt.key)
        groups[group] += ms
        if group == "cuda_runtime" and "Launch" in evt.key:
            launches += evt.count
        top.append((ms, evt.key[:80]))
    total = sum(groups.values())
    out = dict(wall_ms_per_step=wall, traced_self_cpu_ms_per_step=total,
               launch_calls_per_step=launches / reps, self_cpu_ms=groups,
               share={k: v / max(total, 1e-9) for k, v in groups.items()},
               remat_ab=remat,
               top_self_cpu_ms=[[k, v] for v, k in sorted(top)[::-1][:12]])
    emit(phase="host_split", package=tag, dtype=dtype_name(dtype),
         batch=TRAIN_B, **out)
    return out


def host_split_worker(side: str, out: Path) -> None:
    """One process of ``--host-split``: the eager B=16 step's host split
    in f32 and bf16, on the package first on ``sys.path``."""
    import multi_modal_foundation_model_tpu_torch as pkg
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    where = f"{side}:{Path(pkg.__file__).resolve().parent}"
    for dtype, mode in ((torch.float32, ln.PALLAS_LAYERNORM),
                        (torch.bfloat16, "full")):
        with ln_mode(mode):
            tr = _trainer(_cfg(dtype), _step_loaders(TRAIN_B), None, 1,
                          out / "chip_smoke_split")
            flat = _trainer(_cfg(dtype, remat_layers=False),
                            _step_loaders(TRAIN_B), None, 1,
                            out / "chip_smoke_split")
            host_split(where, _step_fn(tr), dtype, _step_fn(flat))
        del tr, flat
        torch.cuda.empty_cache()


def prefetch_check(root: Path) -> None:
    """The host-batch path with ``prefetch_depth=2`` (pinned copies on a
    side stream) against the same epoch without it, f32 at B=16 under the
    port's default LayerNorm mode: per step loss bit for bit or within the
    f32 gate (rtol 1e-5), and both epochs' wall time (an epoch of 10
    steps, the second of each run, interleaved)."""
    cfg = _cfg(torch.float32)
    train_l, _ = _train_loaders()
    runs = {}
    for depth in (0, 2, 2, 0):
        tr = _trainer(cfg, train_l, None, 3, root / "chip_smoke_prefetch",
                      tcfg_over=dict(prefetch_depth=depth))
        losses = tr.train_epoch(0)["step_losses"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += tr.train_epoch(1)["step_losses"]
        torch.cuda.synchronize()
        run = runs.setdefault(depth, dict(losses=losses, epoch_s=[]))
        run["epoch_s"].append(time.perf_counter() - t0)
        del tr
    a, b = runs[0]["losses"], runs[2]["losses"]
    rel = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    ok = rel <= 1e-5
    emit(phase="prefetch_check", dtype="float32", batch=TRAIN_B,
         steps=len(a), losses_bit_equal=a == b, loss_max_rel_err=rel,
         epoch_s={str(k): v["epoch_s"] for k, v in runs.items()},
         device=torch.cuda.get_device_name(0), ok=ok)
    if not ok:
        raise AssertionError(f"prefetch changed the losses: {rel}")


def philox_check() -> dict:
    """The Philox draw kernel (``csrc/random.cu``) against its plain
    version at the B=16 step's largest dropout (16 x 200 x 256 bytes) and
    its masker draw (16 x 100 x 668 uniforms), bit for bit; timed beside
    the plain version and, for reference, ``torch.randint``'s bytes (not
    the same function: other bits), with the bound of writing the output
    once (nothing is read but the key)."""
    from multi_modal_foundation_model_tpu_torch.ops import random as rnd

    key = torch.tensor([2 ** 40 + 123], dtype=torch.int64, device="cuda")
    shapes = dict(u8=(TRAIN_B, 200, 256), uniform=(TRAIN_B, 100, 668))
    out = {}
    for kind, shape in shapes.items():
        fn = rnd.u8_bits if kind == "u8" else rnd.uniform
        ref = rnd.u8_bits_reference if kind == "u8" else \
            rnd.uniform_reference
        got = fn(key[0:1], shape, 1)
        want = ref(key[0:1], shape, 1)
        err = (got.float() - want.float()).abs().max().item()
        n = got.numel()
        ms = device_ms(lambda: fn(key[0:1], shape, 1))
        plain_ms = cuda_time_ms(lambda: ref(key[0:1], shape, 1), 5, 1)
        randint_ms = device_ms(lambda: torch.randint(
            0, 256, shape, dtype=torch.uint8, device="cuda"))
        # ten Philox rounds (~12 integer operations each) per 16 bytes or
        # 4 uniforms, at the f32 CUDA-core rate as a stand-in
        blocks = n / (16 if kind == "u8" else 4)
        b = _bound(n * got.element_size(), blocks * 120.0)
        out[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, torch_randint_ms=randint_ms,
                         shape=list(shape), **b)
        emit(phase="philox_check", kind=kind, **out[kind],
             ok=err == 0.0)
        if err != 0.0:
            raise AssertionError(f"Philox {kind} kernel != plain: {err}")
    return out


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


def _ab_sweep_chunk(side: str, where: str, dtype, mode: str) -> None:
    """One ``ab_sweep_chunk`` line: the sweep-chunk forward (B = 16 x 20)
    of a full-width ``dtype`` model, 3 timings of 5 calls, and a
    profile of one."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import EvalForward
    from multi_modal_foundation_model_tpu_torch.models import MultiModal

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
         dtype=dtype_name(dtype), layernorm=mode,
         batch=CHUNK * int(batch["n_real"]), ms=times,
         **device_breakdown(chunk, top=4))
    del fwd, model
    torch.cuda.empty_cache()


def _ab_layernorm(side: str, where: str) -> None:
    """``ab_layernorm`` lines: K3 and K4 at the B=256 and B=16 steps' rows,
    f32 and bf16, device ms of each kernel a call launches."""
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    H = GEOMETRY["hidden_size"]
    tokens = len(GEOMETRY["n_channels"]) * GEOMETRY["max_F"]
    for dtype in DTYPES:
        for rows in (BIG_B * tokens, TRAIN_B * tokens):
            x, w, b, dy = _ln_operands(rows, H, dtype, seed=5)
            by_kernel = dict(
                k3=device_ms_by_kernel(
                    lambda: ln.layernorm_fwd(x, w, b, 1e-5, dtype)),
                k4=device_ms_by_kernel(
                    lambda: ln.layernorm_bwd(x, w, dy, 1e-5)))
            emit(phase="ab_layernorm", side=side, package=where,
                 dtype=dtype_name(dtype), shape=[rows, H],
                 k3_ms=sum(by_kernel["k3"].values()),
                 k4_ms=sum(by_kernel["k4"].values()),
                 by_kernel_ms=by_kernel,
                 k4_bound_ms=k4_bound(rows, H, dtype)["bound_ms"])


def ab_worker(side: str, out: Path) -> None:
    """One process of ``--ab``: K3 and K4 alone (``_ab_layernorm``), the
    bf16 steps under "full" at B=16 and
    B=256 (4 segments of 10 and 3 steps after 2 warm-ups, their median)
    and the bf16 sweep-chunk forward; then, under the port's default
    LayerNorm mode, the f32 sweep-chunk forward (where the f32 K1 of the
    eval shows) and the f32 step at B=256 (the device-bound step, where the
    f32 K1 and K2 show), each with a profile, on the package first on
    ``sys.path``."""
    import multi_modal_foundation_model_tpu_torch as pkg
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    where = str(Path(pkg.__file__).resolve().parent)
    default = ln.PALLAS_LAYERNORM
    _ab_layernorm(side, where)
    with ln_mode("full"):
        for B, reps in ((TRAIN_B, 10), (BIG_B, 3)):
            _ab_step(side, where, out, torch.bfloat16, "full", B, reps)
        _ab_sweep_chunk(side, where, torch.bfloat16, "full")
    with ln_mode(default):
        _ab_sweep_chunk(side, where, torch.float32, default)
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


def host_split_ab(other: str) -> int:
    """``--host-split OTHER``: the eager step's host split on the other
    checkout's package, then on this one, one process each."""
    me = Path(__file__).resolve()
    print(nvidia_smi(), flush=True)
    for side, root in (("other", other), ("this", me.parent)):
        rc = subprocess.run([sys.executable, str(me), "--split-worker", side,
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
    if sys.argv[1:2] == ["--host-split"]:
        return host_split_ab(sys.argv[2])
    if sys.argv[1:2] in (["--ab-worker"], ["--split-worker"]):
        # this script's helpers, on the other checkout's package
        sys.path.insert(0, sys.argv[3])
        from multi_modal_foundation_model_tpu_torch.ops import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build(build.kernel_sources())
        worker = ab_worker if sys.argv[1] == "--ab-worker" else \
            host_split_worker
        worker(sys.argv[2], root / "build")
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
    k3, k4, k4_b16 = ln_phase()
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
    host_split_worker("this", out)
    disp_f32 = dispatch_phase(out, f32, default)
    disp_bf16 = dispatch_phase(out, bf16, "full")
    dispatch_time(out, f32, default)
    dispatch_time(out, bf16, "full")
    prefetch_check(out)
    philox = philox_check()
    plain_step_time(out)
    picks = {dtype_name(dt): layernorm_ab(out, dt) for dt in (f32, bf16)}
    emit(phase="layernorm_default", rule_pick_at_b256=picks,
         default_in_code=default)
    paths = dict(eval_f32=eval_f32, eval_bf16=eval_bf16,
                 train_f32=train_f32, train_bf16=train_bf16)
    # the graph path's launches, counted by kernel name in a profile of
    # one epoch of replays (the wrappers' counters see only Python calls)
    graph_paths = dict(dispatch_graph_f32=disp_f32,
                       dispatch_graph_bf16=disp_bf16)

    def by_path(group, names):
        got = {k: paths[k][group] for k in names if k in paths}
        got.update({k: graph_paths[k][group] for k in names
                    if k in graph_paths})
        return got

    src = "multi_modal_foundation_model_tpu_torch/csrc/"
    attn_py = "multi_modal_foundation_model_tpu/ops/attention.py"
    ln_py = "multi_modal_foundation_model_tpu/ops/layernorm.py"
    kernels = [
        dict(name="attention_fwd (K1, eval: no dropout, no lse), f32: tensor "
             "cores (3xTF32: mma.sync m16n8k8 tf32, hi/lo split, cp.async)",
             route="cuda", source=src + "attention_fwd.cu",
             replaces=attn_py + ":144", launches=eval_f32["k1"],
             **_row(k1[f32])),
        dict(name="attention_fwd (K1, eval), bf16: tensor cores (mma.sync "
             "m16n8k16 bf16, ldmatrix, cp.async)", route="cuda",
             source=src + "attention_fwd.cu", replaces=attn_py + ":144",
             launches=eval_bf16["k1"], **_row(k1[bf16])),
        dict(name="attention_fwd (K1, training: dropout 0.4, lse), f32: "
             "tensor cores (3xTF32: mma.sync m16n8k8 tf32, hi/lo split, "
             "cp.async)", route="cuda", source=src + "attention_fwd.cu",
             replaces=attn_py + ":144", launches=train_f32["k1"],
             launches_by_path=by_path("k1", ("train_f32",
                                             "dispatch_graph_f32")),
             **_row(k1_train[f32])),
        dict(name="attention_fwd (K1, training), bf16: tensor cores "
             "(mma.sync m16n8k16 bf16, ldmatrix, cp.async)", route="cuda",
             source=src + "attention_fwd.cu", replaces=attn_py + ":144",
             launches=train_bf16["k1"],
             launches_by_path=by_path("k1", ("train_bf16",
                                             "dispatch_graph_bf16")),
             **_row(k1_train[bf16])),
        dict(name="attention_bwd (K2), f32: tensor cores (3xTF32: mma.sync "
             "m16n8k8 tf32, hi/lo split, cp.async)", route="cuda",
             source=src + "attention_bwd.cu", replaces=attn_py + ":221",
             launches=train_f32["k2"],
             launches_by_path=by_path("k2", ("train_f32",
                                             "dispatch_graph_f32")),
             **_row(k2[f32])),
        dict(name="attention_bwd (K2), bf16: tensor cores (mma.sync "
             "m16n8k16 bf16, ldmatrix, cp.async)", route="cuda",
             source=src + "attention_bwd.cu", replaces=attn_py + ":221",
             launches=train_bf16["k2"],
             launches_by_path=by_path("k2", ("train_bf16",
                                             "dispatch_graph_bf16")),
             **_row(k2[bf16])),
        dict(name="layernorm_fwd (K3), bf16 at 51,200 x 256", route="cuda",
             source=src + "layernorm.cu", replaces=ln_py + ":100",
             launches=sum(c["k3"] for c in paths.values()),
             launches_by_path=by_path("k3", (*paths, *graph_paths)),
             f32_ms=k3[f32]["ms"], **_row(k3[bf16])),
        dict(name="layernorm_bwd (K4), bf16 at 51,200 x 256: a grid of one "
             "wave sized to the SMs, the next row loaded while a row is "
             "reduced, a fixed-order column sum over 2H/8 blocks",
             route="cuda", source=src + "layernorm.cu",
             replaces=ln_py + ":109",
             launches=sum(c["k4"] for c in paths.values()),
             launches_by_path=by_path("k4", (*paths, *graph_paths)),
             f32_ms=k4[f32]["ms"],
             b16_rows_3200={dtype_name(dt): _row(r)
                            for dt, r in k4_b16.items()},
             **_row(k4[bf16])),
        dict(name="philox_u8 / philox_uniform: layer and embedding "
             "dropout's random bytes (16 x 200 x 256 at B=16) and the "
             "masker's uniforms, keyed from the step's seed table on the "
             "card", route="cuda", source=src + "random.cu",
             replaces="multi_modal_foundation_model_tpu/models/layers.py"
             ":227-240",
             launches=train_f32["philox"] + train_bf16["philox"],
             launches_by_path=by_path("philox", (*paths, *graph_paths)),
             uniform=philox["uniform"], **_row(philox["u8"])),
    ]
    emit(phase="profiler_lead_in", traces=len(TRACE_LOSSES),
         lead_in=LEAD_IN, lost_by_trace=TRACE_LOSSES)
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
