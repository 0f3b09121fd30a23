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
   could reach: K1 of the eval (``k1_check``/``k1_time``: f32 atol 1e-5,
   bf16 atol 2e-2, ``lse`` 1e-5, B=320), K1 of the training step with
   dropout and ``lse`` (``k1_dropout_check``) and K2
   (``k2_check``/``k2_time``), B=256, dropout 0 and 0.4 on the same
   Philox bits as the plain versions, f32 atol 1e-5.
3. eval    — the serving path: ``co_smoothing_eval`` in all six modes on a
   full-width ``MultiModal`` (N=668 + 2 behavior, T=100, H=256, 8 heads,
   5+5 layers, random weights from a seed) over the port's synthetic test
   split, with the kernel launch counts read around it; then one
   full-test-set forward through the kernel path and the plain path.
4. train   — the training path: ``MultiModalTrainer`` on the full-width
   model (dropout 0.4, fixup init, remat, f32) over the synthetic train
   split, batch 16, MtM menu, mixed objectives: ``train()`` for 2 epochs
   with eval, a fresh trainer restored from ``last`` for one more epoch,
   then ``load_model_data_local`` on ``best`` and one eval mode; launch
   counts read around it (K2 15 per step, K1 30 per step with remat's
   recompute plus 15 per eval forward). ``kernel_vs_plain_step`` holds the
   gradients of one step against the plain path (``attn_impl="xla"``);
   ``train_step_time`` times steps at B=16 and B=256 on both paths and
   profiles one B=256 step.

The second-to-last line repeats the ``nvidia-smi`` reading; the last line
is ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
The port never imports JAX, and neither does this script.
"""

from __future__ import annotations

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

# the main path: the reference model at full width
GEOMETRY = dict(n_channels={"ap": 668, "behavior": 2}, max_F=100,
                hidden_size=256, n_heads=8, n_enc_layers=5, n_dec_layers=5,
                inter_size=512, act="gelu")
N_TRIALS, SEED, CHUNK = 200, 0, 16
K1_ATTN_PER_FORWARD = 15          # 5 encoder self, 5 decoder self, 5 cross
# the trainer's batch (trainer_mm.yaml:26) and the JAX package's
# benchmark batch
TRAIN_B, BIG_B = 16, 256
MTM_MENU = ("inter-region", "intra-region", "neuron", "temporal")
DROPOUT = 0.4


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
    tracing), grouped as K1 / K2 / GEMM / other, beside the host wall time of
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
        # user annotations (e.g. "Optimizer.step#AdamW.step") also appear on
        # the device timeline; they span kernels counted on their own
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False):
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    groups = {"k1_ms": 0.0, "k2_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        key = ("k1_ms" if "attn_fwd_kernel" in low else
               "k2_ms" if "attn_bwd_" in low else
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
# phase 2b: K1 with dropout and lse, K2, against their plain versions
# ---------------------------------------------------------------------------

def _bound(bytes_moved: float, flops: float) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)


def train_kernels_phase():
    """K1 (dropout, lse) and K2 at the training step's shapes (B=256,
    Tq=Tk=200, H=8, D=32, f32), each case at dropout 0 and 0.4 against the
    plain versions on the same Philox bits (atol 1e-5 on out, lse, dq, dk,
    dv: the same f32 products summed in other orders); then timings."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    worst_k1 = worst_k2 = 0.0
    for case in ("encoder_eye_pad", "decoder_pad", "cross"):
        q, k, v, spec, H = k1_inputs(case, torch.float32, B=BIG_B)
        B, Tq, hidden = q.shape
        key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1],
                                            q.device)
        scale = 1.0 / math.sqrt(hidden // H)
        g = torch.randn(q.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
        for rate in (0.0, DROPOUT):
            out, lse = att.attention_fwd(q, k, v, key_pad, static, H, scale,
                                         True, rate, 1234)
            grads = att.attention_bwd(q, k, v, key_pad, static, g, lse, H,
                                      scale, rate, 1234)
            torch.cuda.synchronize()
            ref, ref_lse = att.attention_reference(
                q, k, v, key_pad, static, H, scale, True, rate, 1234)
            ref_grads = att.attention_bwd_reference(
                q, k, v, key_pad, static, g, lse, H, scale, rate, 1234)
            err = (out - ref).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            gerr = [(a - b).abs().max().item()
                    for a, b in zip(grads, ref_grads)]
            masked_dq = (grads[0][3].abs().max().item()
                         if case == "decoder_pad" else 0.0)
            ok1 = err <= 1e-5 and lse_err <= 1e-5
            ok2 = max(gerr) <= 1e-5 and masked_dq == 0.0
            emit(phase="k1_dropout_check", case=case, dropout=rate,
                 shape=[B, Tq, hidden], max_abs_err=err,
                 lse_max_abs_err=lse_err, atol=1e-5, ok=ok1)
            emit(phase="k2_check", case=case, dropout=rate,
                 shape=[B, Tq, hidden], dq_dk_dv_max_abs_err=gerr,
                 padded_trial_max_abs_dq=masked_dq, atol=1e-5, ok=ok2)
            if not (ok1 and ok2):
                raise AssertionError(f"K1/K2 disagree with their plain "
                                     f"versions ({case}, {rate}): {err}, "
                                     f"{lse_err}, {gerr}, {masked_dq}")
            worst_k1, worst_k2 = max(worst_k1, err), max(worst_k2, *gerr)

    # timings at the encoder shape, dropout 0.4 (the training step's)
    q, k, v, spec, H = k1_inputs("encoder_eye_pad", torch.float32, B=BIG_B)
    B, Tq, hidden = q.shape
    Tk, D = k.shape[1], hidden // H
    key_pad, static = att.spec_operands(spec, B, Tq, Tk, q.device)
    scale = 1.0 / math.sqrt(D)
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    _, lse = att.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                               DROPOUT, 7)
    k1_ms = cuda_time_ms(lambda: att.attention_fwd(
        q, k, v, key_pad, static, H, scale, True, DROPOUT, 7))
    k1_plain = cuda_time_ms(lambda: att.attention_reference(
        q, k, v, key_pad, static, H, scale, True, DROPOUT, 7), 5, 1)
    k2_ms = cuda_time_ms(lambda: att.attention_bwd(
        q, k, v, key_pad, static, g, lse, H, scale, DROPOUT, 7))
    k2_ms_rate0 = cuda_time_ms(lambda: att.attention_bwd(
        q, k, v, key_pad, static, g, lse, H, scale, 0.0, 7))
    k2_plain = cuda_time_ms(lambda: att.attention_bwd_reference(
        q, k, v, key_pad, static, g, lse, H, scale, DROPOUT, 7), 5, 1)
    # library yardstick (never called by the port): SDPA with the same
    # additive bias and dropout_p; K2's is its backward, (fwd + bwd) - fwd
    bias = att.mask_to_bias(static.bool()[None]
                            | key_pad.bool()[:, None])[:, None]
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
    # products at the f32 CUDA-core peak (the Philox draws not counted)
    masks = key_pad.numel() * 4 + static.numel() * 4
    lse_bytes = B * H * Tq * 4
    # K1: q, k, v in, out and lse out
    k1_b = _bound(B * (2 * Tq + 2 * Tk) * hidden * 4 + lse_bytes + masks,
                  4 * B * H * Tq * Tk * D)
    # K2: q, g, k, v, lse in; dq, dk, dv out
    k2_b = _bound(B * (3 * Tq + 4 * Tk) * hidden * 4 + lse_bytes + masks,
                  10 * B * H * Tq * Tk * D)
    emit(phase="k1_train_time", shape=[B, Tq, Tk, H, D], dropout=DROPOUT,
         with_lse=True, ms=k1_ms, plain_ms=k1_plain, library_ms=lib_fwd,
         **k1_b)
    emit(phase="k2_time", shape=[B, Tq, Tk, H, D], dropout=DROPOUT, ms=k2_ms,
         ms_dropout0=k2_ms_rate0, plain_ms=k2_plain,
         library_ms=lib_fwd_bwd - lib_fwd, library_fwd_bwd_ms=lib_fwd_bwd,
         **k2_b)
    keys = ("bound_ms", "bound_by")
    return (dict(max_abs_err=worst_k1, ms=k1_ms, plain_ms=k1_plain,
                 library_ms=lib_fwd, **{k: k1_b[k] for k in keys}),
            dict(max_abs_err=worst_k2, ms=k2_ms, plain_ms=k2_plain,
                 library_ms=lib_fwd_bwd - lib_fwd,
                 **{k: k2_b[k] for k in keys}))


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
                         max_time_length=T, max_space_length=N,
                         shuffle=False)
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


def train_phase(root: Path):
    """MultiModalTrainer at full width: 2 epochs with eval, restore into a
    fresh trainer, 1 more epoch; then the eval reload of ``best``."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import (
        co_smoothing_eval, load_model_data_local)
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModalConfig)
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    cfg = MultiModalConfig(**GEOMETRY)
    T, N = cfg.max_F, cfg.n_channels["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                              n_timesteps=T)
    kw = dict(batch_size=TRAIN_B, max_time_length=T, max_space_length=N)
    train_l = make_loader(splits.train, seed=SEED, **kw)
    val_l = make_loader(splits.val, shuffle=False, **kw)
    log_dir = root / "train"
    shutil.rmtree(log_dir, ignore_errors=True)

    counts = {"train": 0, "eval": 0}
    att.K1_LAUNCHES = att.K2_LAUNCHES = 0
    t0 = time.perf_counter()
    tr_a = _trainer(cfg, train_l, val_l, 2, log_dir)
    _count_forwards(tr_a.model, counts)
    res_a = tr_a.train()
    tr_b = _trainer(cfg, train_l, val_l, 3, log_dir)
    _count_forwards(tr_b.model, counts)
    epoch = tr_b.restore("last")
    restored_step = tr_b.step
    same = all(torch.equal(a, b) for a, b in zip(
        tr_a.model.state_dict().values(), tr_b.model.state_dict().values()))
    res_b = tr_b.train(start_epoch=epoch + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = att.K1_LAUNCHES, att.K2_LAUNCHES
    steps = tr_a.step + tr_b.step - restored_step

    losses = []
    for row in res_a["history"] + res_b["history"]:
        losses += row["step_losses"]
        emit(phase="train_epoch", epoch=row["epoch"],
             step_losses=row["step_losses"], train_loss=row["train_loss"],
             eval_loss=row.get("eval_loss"),
             eval_trial_avg_r2=row.get("eval_trial_avg_r2"),
             lr=row["lr"], epoch_time_s=row["epoch_time_s"])
    finite = all(math.isfinite(x) for x in losses)
    want_k1 = 2 * K1_ATTN_PER_FORWARD * steps \
        + K1_ATTN_PER_FORWARD * counts["eval"]
    ok = (finite and same and epoch == 1 and restored_step == tr_a.step
          and steps == counts["train"] == len(losses)
          and k2 == K1_ATTN_PER_FORWARD * steps and k1 == want_k1)
    emit(phase="train", batch=TRAIN_B, steps=steps, epochs=3,
         restored_epoch=epoch, restored_params_equal=same,
         train_forwards=counts["train"], eval_forwards=counts["eval"],
         k1_launches=k1, k1_expected=want_k1, k2_launches=k2,
         k2_per_step=k2 / max(steps, 1), losses_finite=finite,
         best_epoch=res_a["best_epoch"], wall_s=wall,
         device=torch.cuda.get_device_name(0), ok=ok)
    if not ok:
        raise AssertionError("training path: launches, losses or resume "
                             "are off (see the train line)")

    model, loader = load_model_data_local(
        model_dir=str(log_dir), test_session=splits.test,
        checkpoint_name="best", max_time_length=T, max_space_length=N)
    res = co_smoothing_eval(model, loader, "forward_pred", use_mtm=True,
                            n_time_steps=T,
                            held_out_list=list(range(7 * T // 10, T)),
                            save_path=str(root / "train_eval"))
    fin = all(math.isfinite(x) for x in res.values())
    emit(phase="train_eval_reload", checkpoint="best", mode="forward_pred",
         metrics=res, ok=fin)
    if not fin:
        raise AssertionError("eval of the trained checkpoint is not finite")
    return k1, k2


def kernel_vs_plain_step(root: Path):
    """One training step's loss and parameter gradients, kernel path
    against ``attn_impl="xla"``: same weights, batch, objective, scheme
    and step seed, dropout 0.4 (the same Philox and u8 draws on both).
    Loss rtol 1e-5; every gradient element within 1e-6 + 1e-4 |plain|
    (f32 sums in other orders through ten layers)."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModalConfig)

    cfg = MultiModalConfig(**GEOMETRY)
    T, N = cfg.max_F, cfg.n_channels["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                              n_timesteps=T)
    loader = make_loader(splits.train, batch_size=TRAIN_B, shuffle=False,
                         max_time_length=T, max_space_length=N)
    results = []
    for impl in ("pallas", "xla"):
        tr = _trainer(dataclasses.replace(cfg, attn_impl=impl), loader, None,
                      1, root / "chip_smoke_step")
        batch = tr._device_batch(next(iter(loader)))
        out = tr.step_loss(batch, "token_masking", 1, step=5)
        out.loss.backward()
        results.append((out.loss.item(), {
            n: p.grad.detach().clone()
            for n, p in tr.model.named_parameters()}))
    (lk, gk), (lp, gp) = results
    # elementwise |kernel - plain| <= atol + rtol |plain| (torch.allclose)
    atol, rtol = 1e-6, 1e-4
    worst = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    excess = max(((gk[n] - gp[n]).abs() - atol - rtol * gp[n].abs())
                 .max().item() for n in gk)
    loss_rel = abs(lk - lp) / abs(lp)
    ok = loss_rel <= 1e-5 and excess <= 0.0
    emit(phase="kernel_vs_plain_step", batch=TRAIN_B, dropout=DROPOUT,
         loss_kernel=lk, loss_plain=lp, loss_rel_err=loss_rel,
         grad_max_abs_err=worst, n_params=len(gk), loss_rtol=1e-5,
         grad_atol=atol, grad_rtol=rtol, ok=ok)
    if not ok:
        raise AssertionError(f"kernel vs plain step: loss {loss_rel}, "
                             f"grads {worst}")


def train_step_time(root: Path):
    """ms per step and seq/s at B=16 and B=256, kernel and plain paths, and
    a profile of one kernel-path step at each batch."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModalConfig)

    cfg = MultiModalConfig(**GEOMETRY)
    T, N = cfg.max_F, cfg.n_channels["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=320, n_neurons=N,
                              n_timesteps=T)
    for B, reps in ((TRAIN_B, {"pallas": 20, "xla": 10}),
                    (BIG_B, {"pallas": 6, "xla": 3})):
        loader = make_loader(splits.train, batch_size=B, shuffle=False,
                             max_time_length=T, max_space_length=N)
        for impl in ("pallas", "xla"):
            tr = _trainer(dataclasses.replace(cfg, attn_impl=impl), loader,
                          None, 1, root / "chip_smoke_time")
            batch = tr._device_batch(next(iter(loader)))

            def step():
                return tr.train_step(batch, *tr._sample_modes())

            tr._reseed_host_rng(0)
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(reps[impl]):
                step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / reps[impl]
            emit(phase="train_step_time", batch=B, path=impl,
                 ms_per_step=ms, seq_per_s=B / ms * 1e3, steps=reps[impl],
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 **step_flops(cfg, B),
                 step_bound_ms=step_flops(cfg, B)["step_flops_with_remat"]
                 / PEAK_FLOPS[torch.float32] * 1e3)
            if impl == "pallas":
                emit(phase="train_step_profile", batch=B, path=impl,
                     **device_breakdown(step, top=8))
            del tr, batch
            torch.cuda.empty_cache()


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
    k1_train, k2 = train_kernels_phase()
    launches = eval_phase(root / "build" / "chip_smoke_eval")
    k1_train_launches, k2_launches = train_phase(root / "build")
    kernel_vs_plain_step(root / "build")
    train_step_time(root / "build")
    src = "multi_modal_foundation_model_tpu_torch/csrc/"
    emit(kernels=[
        dict(name="attention_fwd (K1, eval: no dropout, no lse)",
             route="cuda", source=src + "attention_fwd.cu",
             replaces="multi_modal_foundation_model_tpu/ops/attention.py:144",
             launches=launches, **k1),
        dict(name="attention_fwd (K1, training: dropout 0.4, lse)",
             route="cuda", source=src + "attention_fwd.cu",
             replaces="multi_modal_foundation_model_tpu/ops/attention.py:144",
             launches=k1_train_launches, **k1_train),
        dict(name="attention_bwd (K2)", route="cuda",
             source=src + "attention_bwd.cu",
             replaces="multi_modal_foundation_model_tpu/ops/attention.py:221",
             launches=k2_launches, **k2)])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
