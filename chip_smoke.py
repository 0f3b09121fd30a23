#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — ``nvidia-smi`` name and power limit, torch/CUDA versions,
   TF32 off, every CUDA kernel of the port built from ``csrc/`` (one
   ``nvcc`` per source, all started together; the head-width-128
   libraries, which phase 14 alone runs, beside the first phases, waited
   for before phase 14: ``device_late_build``).
2. kernels — each kernel against its plain PyTorch version at the shapes
   the main paths give it, timed beside the plain version, the one
   library call that computes the same function, and the bound the card
   could reach: K1 of the eval (``k1_check``/``k1_time``, f32 and bf16,
   B=320), K1 of the training step with dropout and ``lse``
   (``k1_dropout_check``; ``k1_time``/``k1_train_time`` with the device
   ms of each kernel K1 launches, by name: the bf16 K1 is the wgmma
   kernel of ``csrc/attention_fwd_bf16.cuh``, with dropout after its keep
   draws, the f32 one that of ``csrc/attention_fwd_f32.cuh``) and K2
   (``k2_check``/``k2_time``, with the
   device ms of each kernel K2 launches, by name, at dropout 0.4 and 0:
   the bf16 K2 is the wgmma kernel of ``csrc/attention_bwd_bf16.cuh``, the
   f32 one that of ``csrc/attention_bwd_f32.cuh``, each its keep draws and
   two passes; the f32 K2 also beside SDPA's MATH backward), B=256, f32
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
   path (``attn_impl="xla"``, ``"off"``) in f32 and bf16, and in f32 under
   ``"bwd"`` (K4 with the plain forward). The step timings
   (``plain_step_time``; ``layernorm_ab``, kernel-path steps in f32 and
   bf16 under "off", "bwd" and "full" interleaved in one process, the A/B
   that set the port's default) run in ``scripts/torch_step_time.py``.
5. dispatch — the trainer's host-dispatch options: ``dispatch`` trains the
   resident path with K=10 steps a dispatch as CUDA graphs, f32 and bf16,
   full MtM menu with mixed training, epoch 0, save, epoch 1, restore in
   place, epoch 1 again, epoch 2, against the same steps run eagerly (per
   step loss and per parameter, bit for bit or within the stated gates;
   the graph path's launches counted by kernel name in a profile);
   ``dispatch_time`` (the eager step against the graph step at B=16
   and B=256, f32 and bf16, one variant, interleaved, with profiles, the
   capture seconds and the peak memory) and ``host_split`` (the eager B=16
   step's host time by kind, CPU side of torch.profiler, beside its wall
   time with and without remat) run in ``scripts/torch_step_time.py``;
   ``prefetch_check`` runs the
   host-batch path with ``prefetch_depth=2`` against the same epochs
   without it; ``philox_check`` holds the Philox draw kernel against its
   plain version and times it. The SDPA
   yardsticks run on a pinned backend (``SDPA_BACKEND``).
6. baseline — the linear baselines (``BaselineTrainer``) at trainer.yaml's
   width and the scripts' defaults (N=668, T=100, 2 behaviors, 400 trials
   split 320/40/40, B=16, f32): in each direction one initial state_dict
   trains 2 epochs on the CPU and on the card, per-step losses within rtol
   1e-4 and ``eval_trial_avg_r2`` within 1e-4; then
   ``co_smoothing_eval_baseline`` on the card. Median step time (CUDA
   events), epoch and eval wall times.
7. entry_points — the four entry scripts' ``main(argv)`` on the card
   (``--synthetic --device cuda``): both baselines trained and evaluated,
   ``train_multi_modal`` (mm.yaml's bf16, MtM, mixed objectives, the
   resident path, 10 steps a dispatch) and ``eval_multi_modal`` in all six
   modes; finite metrics and results, and K1, K2, K3, K4 and Philox
   launched (the counters set to 0 before each script and read after it)
   on the training script, K1 and K3 on the eval script; wall time of each.
8. multisession — the session-stitched model at full width: 10 synthetic
   sessions of 668 + 37 i neurons (668-1001), 100 trials each (400 for
   the timing phases), padded to N_max = 1024 (13.2M stitched
   parameters), B=16, dropout 0.4, the MtM menu with the region modes and
   mixed training, f32 (the port's default LayerNorm mode) and bf16
   (``"full"``): ``multisession`` runs one epoch (50 steps) of the
   resident path with K = 10 over the stacked block as CUDA graphs
   against the same steps run eagerly (bit for bit, else the
   ``dispatch`` gates), profiles a group's launches (K1 30, K2 15, K3 62,
   K4 32 a step, Philox) and runs the per-session ``eval_epoch``;
   ``multisession_buckets`` trains ``n_buckets=2`` (two widths, a graph
   key each) and holds the stitched forward at a session's bucket width
   against N_max (f32, atol 1e-5); ``multisession_kernel_vs_plain_step``
   one stitched step kernel path vs plain path (the step gates). The
   timing-only ``multisession_time`` (the multi-session graph step
   against the single-session one at B=16 and B=256, the session-mixed
   one against the unmixed one, interleaved, with profiles and peak
   memory) is not run here: ``scripts/torch_multisession_time.py`` runs
   it.
9. multisession_mixed — session-mixed batches (per-sample session ids):
   ``session_rows_check`` holds the kernel of the gathers' fixed-order
   backward (``csrc/session_rows.cu``) against its plain version at the
   B=16 step's shapes, bit for bit, timed beside ``index_add_``;
   ``multisession_mixed`` trains one mixed epoch (50 steps, K = 10, f32
   and bf16) as CUDA graphs, eagerly and eagerly again: all three bit for
   bit, and a profiled group launches K1 30, K2 15, K3 62, K4 32 and the
   session-rows kernel 7 times a step; ``multisession_mixed_forward``
   holds a batch of one trial a session against each sample's scalar-id
   forward (f32, atol 1e-5); ``multisession_mixed_buckets`` trains
   ``n_buckets=2`` with mixed batches (a graph set a width).
10. multisession_entry — ``train_multi_session`` at its defaults but 2
   sessions (bf16, MtM, mixed objectives, resident, K = 10, 1 epoch),
   ``eval_multi_modal --multi_session`` in all six modes, then
   ``train_multi_session --mixed_session_batches``: finite rows and
   per-session results, launches by script, wall time.
11. reference_ckpt — a full-width f32 model saved in the reference's
   names as a ``state_dict``, under ``'state_dict'`` and as a whole-module
   pickle, each loaded by ``load_reference_checkpoint`` with a bit-equal
   eval forward; ``eval_multi_modal --reference_ckpt`` in all six modes;
   ``convert_checkpoint`` ``to-port`` then ``to-reference``, bit for bit.
12. real_data — the real-data path on stand-in sessions made from the seed
   (no IBL session is in the repository; nothing is downloaded): raw spike
   times of 708 clusters (668 kept by the region selection; a second
   session of 560 / 520) over 240 trials, wheel speed at 1 kHz and whisker
   motion energy at 60 Hz with NaN gaps, through the port's numpy ETL into
   the hub's CSR rows, ``_rows_to_session`` and ``load_ibl_dataset`` (its
   seams; the session count asserted), host seconds by ETL stage; bf16
   under ``"full"``: the full-width trainer (N=668) on the graph path with
   the launches a step of the synthetic step, two eval modes, multi-session
   graph steps over both sessions, the NEMO filter (narrowed on a session
   with uuids, refused on a hub session), ``decode_spikes_on_device`` bit
   for bit against the host decode (device time beside its bound), the
   ETL'd graph step against the synthetic one, and ``train_multi_modal
   --eid`` / ``eval_multi_modal --eid`` without ``--synthetic`` through a
   stand-in ``datasets`` module.
13. parallel — data and tensor parallelism, as ranks that share the card:
   K1 and K2 at a tensor-parallel rank's shape (B=8 of 16, 200 tokens, 4
   heads of 32 as column views of the rank's fused q/k/v product, draw
   offsets (8, 4)) against their plain versions and bit-equal to the same
   rows and heads of the whole call, timed beside SDPA
   (``parallel_rank_kernels_*``); the single-process step as the
   yardstick; then dp=2 and tp=2 started together, and dp=2 x tp=2 with
   the script's four ranks beside it, at full width (B=16, f32 and bf16
   under ``"full"``) as 2-4 processes each on ``cuda:0`` over gloo
   (``--parallel-worker``; the steps timed one layout at a time with
   nothing else running): the step-0 loss and every gradient (dropout 0
   with the deterministic menu, dropout 0.4 with the MtM menu; mixed
   objectives) and the parameters after three AdamW steps against the
   single process (f32 loss 1e-5 max(1, |loss|), tensors rtol 2e-3 /
   atol 1e-5; bf16 loss 1e-2, tensors 5e-2 relative L2), replicated
   gradients bit-equal over the model group, parameters over the data
   group, K1 30, K2 15, K3 62, K4 32 a step a rank and the single
   process's Philox count, the per-rank eager step and the collectives'
   time a step (``parallel`` lines); the dp2 x tp2 checkpoint's eval
   forward in one process (f32 1e-5, ``parallel_checkpoint``); NCCL at a
   world of one, and its refusal of two ranks on one card
   (``parallel_nccl``); ``train_multi_modal --dp 2 --tp 2`` as four
   torchrun ranks (``parallel_script``). In the same rank processes, the
   multi-session trainer under the mesh (``parallel_multisession``): the
   session-stitched full-width model over 5 sessions of 668 + 37 i
   neurons (N_max 1024, 20.2M parameters), B=16 global, f32 and bf16:
   host batches at dropout 0 on every layout, resident session-mixed
   batches at dropout 0.4 on every layout, and ``shard_resident_sessions``
   at dp=2 and dp=2 x tp=2 (shards of 3 and 2 sessions, 96 rows each,
   the lighter zero-padded), three eager steps each, against the single
   process (its resident steps eager too) fed the same global rows: the
   step-0 loss and gradients and the parameters after the steps at the
   gates above, each step's loss (f32 1e-5, bf16 1e-2 relative),
   replicated gradients and parameters bit-equal as above, the launches
   a step a rank the single process's (session rows 7 a resident step),
   a sharded rank's block its shard's rows, the rank's step and
   collectives timed as above; and the session-rows kernel at a rank's
   shape (8, 1024, 256) bit for bit against its plain version, timed
   with the L2 flushed (``parallel_session_rows_check``). The ranks share
   one card and gloo goes through the host: none of these times is
   scaling.
14. head_widths — K1-K4 at every width the JAX package runs: K1 (dropout,
   lse) and K2 at head widths 8, 16, 24, 64 and 128 (16, 64 and 128
   compiled, 8 and 24 through zero-padded heads; 256 // D heads, B=16, 200
   tokens, the encoder's mask), f32 and bf16, dropout 0 and 0.4, against
   their plain versions (``k1_gates``, ``k2_gates``) and timed beside them
   and SDPA (``head_widths_kernels_*``; the f32 K1 and K2 at 128 also
   beside SDPA's MATH forward and backward); the per-rank K1/K2 at D = 64 (2 of 4 heads, draw
   offsets (8, 2)) and D = 128 (1 of 2 heads, (8, 1)) bit-equal to the
   whole call's slices; K3/K4 at 3,200 rows of 48, 100, 1280, 2048 and
   4096 columns (``head_widths_ln_check``); the mm.yaml model with 2, 4
   and 16 heads (D = 128, 64 and 16), f32 and bf16: one step kernel path
   against plain path
   (``head_widths_step``, the step gates), the resident path as CUDA graphs
   against the same steps run eagerly over 80 trials (``head_widths_dispatch``,
   the ``dispatch`` gates and launches: K1 30, K2 15, K3 62, K4 32 a
   step), one eval forward against the plain path
   (``head_widths_eval_forward``: K1 15, K3 32); and ``train_multi_modal
   --synthetic`` with 4 heads for one epoch (``head_widths_script``).
   Their times at every width and the library's with each SDPA backend
   are ``scripts/torch_width_time.py``'s.
15. profile — ``scripts/profile_model.py``'s ``main`` (JAX's profiled step
   on the flagship: bf16, N=668, ratio 0.3, AdamW; a CUDA-graph replay a
   step) at B=16 and B=256, 20 timed steps and 3 traced by
   ``trace_context``: its JSON line (step ms, seq/s, the FLOPs a step,
   the peak, MFU, loss) beside the card's name and power limit. Gates: the
   FLOP count (``MFUTracker.flops_of`` of an eager step) equals the same
   step's count on the plain path (``attn_impl="xla"``, LayerNorm "off")
   and ``utils/profiling.py::step_flops`` to the FLOP; 0 < MFU < 1; a
   finite loss; the trace file holds K1 and K2 records and launches K1
   30, K2 15, K3 62, K4 32 a replayed step (kernel names; traced again, up
   to 3 times, if the profiler lost records).
16. plots — ``train_multi_modal`` (one epoch, figures every epoch),
   ``eval_multi_modal --co_smooth --save_plot`` (3 figures),
   ``train_baseline`` and ``eval_baseline --save_plot`` (encoding) at full
   width on the card, then ``scripts/launch/mask_ratio_sweep.sh
   --synthetic`` over two ratios at one epoch and ``draw_mask_ratio`` over
   its artifacts. Where matplotlib is missing (the card's machine so far)
   each leg that draws must raise ``ImportError`` naming matplotlib and
   then runs without figures (the launches, checkpoints and ``r2.npy`` /
   ``bps.npy`` are checked either way), and the phase prints ``plots:
   render not run, matplotlib not installed``.

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
import os
import re
import shutil
import subprocess
import sys
import threading
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
# the train scripts' epoch plots off (the shipped YAMLs draw every 5
# epochs; the card's machine has no matplotlib): the phases before
# ``plots`` drive the kernels, and ``plots`` draws
NO_EPOCH_PLOTS = ["--set", "training.save_plot_every_n_epochs=0"]
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


def sdpa(*args, backend: str = None, **kwargs):
    """``F.scaled_dot_product_attention`` on ``backend`` (default
    ``SDPA_BACKEND``) only (it raises if that backend cannot run the
    call)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([getattr(SDPBackend, backend or SDPA_BACKEND)]):
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
# 1.4 us draws did. ``traced`` opens each trace with the port's lead-in
# (``utils/profiling.py::profiler_lead_in``: LEAD_IN spin kernels of ~10
# us each, which ``trace_context`` opens its traces with too) that takes
# that loss, and refuses a trace that lost all of them. Rarely a trace also loses records after a caught lead-in kernel
# (in that script, once in 30 traces: all 20 draws), so each caller checks
# what it counts as well and traces again: ``device_ms_by_kernel`` (each
# kernel's count a multiple of the calls), ``device_breakdown`` (the fuller
# of two kept traces), ``dispatch_phase`` (the launches a step).
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

    from multi_modal_foundation_model_tpu_torch.utils.profiling import (
        LEAD_IN, profiler_lead_in)

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        profiler_lead_in()
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


def kernel_ms_by_name(fn, reps: int = 20) -> dict:
    """``device_ms_by_kernel`` keyed by the kernel's name with its template
    arguments and without its namespace and parameter list (say
    ``attn_bwd_dq_wg_kernel<true, 32>``); copies and other records keep
    their names."""
    out: dict = {}
    for name, ms in device_ms_by_kernel(fn, reps).items():
        m = re.search(r"(\w+_kernel(<[^>]*>)?)\(", name)
        key = m.group(1) if m else name
        out[key] = out.get(key, 0.0) + ms
    return out


def device_ms(fn, reps: int = 20) -> float:
    """``device_ms_by_kernel`` summed: device ms of every kernel a call of
    ``fn`` launches."""
    return sum(device_ms_by_kernel(fn, reps).values())


def device_breakdown(fn, top: int = 6, match=None) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler, CUPTI
    tracing), grouped as K1 / K2 / K3 / K4 / GEMM / other by kernel name,
    beside the host wall time of the same profiled call (so the idle share
    includes profiler cost); ``match`` ({label: name substrings}) adds the
    ms of the kernels whose names hold any of the substrings."""
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
    matched = {label: sum(ms for n, ms in by_name.items()
                          if any(k in n for k in keys))
               for label, keys in (match or {}).items()}
    return dict(wall_ms=wall_ms, device_busy_ms=busy, **matched,
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
    from multi_modal_foundation_model_tpu_torch.ops import session_rows as sr

    att.K1_LAUNCHES = att.K1_LSE_LAUNCHES = att.K2_LAUNCHES = 0
    ln.K3_LAUNCHES = ln.K4_LAUNCHES = 0
    rnd.PHILOX_LAUNCHES = 0
    sr.SESSION_ROWS_LAUNCHES = 0


def read_counts() -> dict:
    from multi_modal_foundation_model_tpu_torch.ops import attention as att
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    from multi_modal_foundation_model_tpu_torch.ops import random as rnd
    from multi_modal_foundation_model_tpu_torch.ops import session_rows as sr

    return dict(k1=att.K1_LAUNCHES, k1_lse=att.K1_LSE_LAUNCHES,
                k2=att.K2_LAUNCHES, k3=ln.K3_LAUNCHES, k4=ln.K4_LAUNCHES,
                philox=rnd.PHILOX_LAUNCHES,
                session_rows=sr.SESSION_ROWS_LAUNCHES)


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
             seed=0, draw_offset=(0, 0)) -> dict:
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
    kw = dict(draw_offset=draw_offset)
    ref, ref_lse = att.attention_reference(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
    if q.dtype == torch.float32:
        return dict(max_abs_err=err, lse_max_abs_err=lse_err,
                    tolerance="atol 1e-5",
                    ok=err <= 1e-5 and lse_err <= 1e-5 and finite)
    bf, bf_lse = att.attention_reference(*args, dots_dtype=torch.bfloat16,
                                         **kw)
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


def k2_gates(q, k, v, key_pad, static, g, lse, H, scale, grads, rate=0.0,
             seed=0, draw_offset=(0, 0), f32_dots_gate=True) -> dict:
    """K2's ``grads`` (dq, dk, dv) against the plain version on the same
    lse and Philox bits. f32 (3xTF32): atol 1e-5 (the same f32 products
    summed in other orders). bf16 (the tensor-core K2, with JAX's bf16
    dots): within 1e-2 (1 + |plain|) of the plain version with the same
    bf16 roundings (``dots_dtype=bf16``: f32 sums in other orders) and,
    with ``f32_dots_gate``, 2e-2 (1 + |plain|) of the f32-dots one (one
    bf16 rounding of every product operand); the bf16-dots plain version's
    own excess over that gate is reported beside it (what the bf16
    arithmetic alone moves)."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    args = (q, k, v, key_pad, static, g, lse, H, scale, rate, seed)
    ref = att.attention_bwd_reference(*args, draw_offset=draw_offset)
    gerr = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(grads, ref)]
    finite = all(bool(torch.isfinite(a).all()) for a in grads)
    if q.dtype == torch.float32:
        return dict(dq_dk_dv_max_abs_err=gerr, tolerance="atol 1e-5",
                    ok=max(gerr) <= 1e-5 and finite)
    bf = att.attention_bwd_reference(*args, dots_dtype=torch.bfloat16,
                                     draw_offset=draw_offset)
    ex_bf = max(_excess(a, b, 1e-2) for a, b in zip(grads, bf))
    ex_f32 = max(_excess(a, b, 2e-2) for a, b in zip(grads, ref))
    return dict(dq_dk_dv_max_abs_err=gerr,
                bf16_dots_max_abs_err=[(a.float() - b.float()).abs().max()
                                       .item() for a, b in zip(grads, bf)],
                bf16_dots_excess=ex_bf, f32_dots_excess=ex_f32,
                plain_bf16_dots_f32_dots_excess=max(
                    _excess(a, b, 2e-2) for a, b in zip(bf, ref)),
                tolerance=("1e-2 (1 + |plain bf16 dots|)" + (
                    " and 2e-2 (1 + |plain f32 dots|)" if f32_dots_gate
                    else "")),
                ok=ex_bf <= 0.0 and (ex_f32 <= 0.0 or not f32_dots_gate)
                and finite)


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
        # device ms of each kernel K1 launches, by name
        by_kernel = kernel_ms_by_name(lambda: att.attention_fwd(
            q, k, v, key_pad, static, H, scale))
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
             dtype=dtype_name(dtype), ms=ms, device_ms_by_kernel=by_kernel,
             route=att.k1_route(dtype, D), plain_ms=plain_ms,
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
                k2 = k2_gates(q, k, v, key_pad, static, g, lse, H, scale,
                              grads, rate, 1234)
                gerr = k2["dq_dk_dv_max_abs_err"]
                masked_dq = (grads[0][3].abs().max().item()
                             if case == "decoder_pad" else 0.0)
                ok1 = k1["ok"]
                ok2 = k2["ok"] and masked_dq == 0.0 and bit_equal
                emit(phase="k1_dropout_check", dtype=dtype_name(dtype),
                     case=case, dropout=rate, shape=[B, Tq, hidden], **k1)
                emit(phase="k2_check", dtype=dtype_name(dtype), case=case,
                     dropout=rate, shape=[B, Tq, hidden],
                     **dict(k2, ok=ok2), padded_trial_max_abs_dq=masked_dq,
                     bit_equal_across_launches=bit_equal)
                if not (ok1 and ok2):
                    raise AssertionError(
                        f"K1/K2 disagree with their plain versions ({case}, "
                        f"{dtype}, {rate}): {k1}, {k2}, "
                        f"{masked_dq}, bit-equal {bit_equal}")
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
        # device ms of each kernel K1 launches (the bf16 one's keep draws
        # with dropout, then the kernel), by name
        k1_by_kernel = {
            str(rate): kernel_ms_by_name(lambda rate=rate: att.attention_fwd(
                q, k, v, key_pad, static, H, scale, True, rate, 7))
            for rate in (DROPOUT, 0.0)}
        k1_plain = cuda_time_ms(lambda: att.attention_reference(
            q, k, v, key_pad, static, H, scale, True, DROPOUT, 7,
            dots_dtype=dtype), 5, 1)
        k2_ms = cuda_time_ms(lambda: att.attention_bwd(
            q, k, v, key_pad, static, g, lse, H, scale, DROPOUT, 7))
        k2_ms_rate0 = cuda_time_ms(lambda: att.attention_bwd(
            q, k, v, key_pad, static, g, lse, H, scale, 0.0, 7))
        # device ms of each kernel K2 launches (with dropout the keep
        # draws, then its two passes), by name
        k2_by_kernel = {
            str(rate): kernel_ms_by_name(lambda rate=rate: att.attention_bwd(
                q, k, v, key_pad, static, g, lse, H, scale, rate, 7))
            for rate in (DROPOUT, 0.0)}
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

        def lib(backend=None):
            return sdpa(qh, kh, vh, attn_mask=bias, dropout_p=DROPOUT,
                        backend=backend)

        lib_fwd = cuda_time_ms(lambda: lib().detach())
        lib_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            lib(), (qh, kh, vh), gh))
        # the f32 K2's other yardstick: SDPA's MATH backward, which beats
        # memory-efficient's in f32 at this shape
        math_bwd = None
        if dtype == torch.float32:
            math_bwd = cuda_time_ms(lambda: torch.autograd.grad(
                lib("MATH"), (qh, kh, vh), gh), 5, 1) - cuda_time_ms(
                    lambda: lib("MATH").detach(), 5, 1)
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
             ms=k1_ms, device_ms_by_kernel=k1_by_kernel,
             route=att.k1_route(dtype, D), plain_ms=k1_plain,
             library_ms=lib_fwd,
             sdpa_backend=SDPA_BACKEND, **k1_b)
        emit(phase="k2_time", dtype=dtype_name(dtype),
             shape=[B, Tq, Tk, H, D], dropout=DROPOUT, ms=k2_ms,
             ms_dropout0=k2_ms_rate0, device_ms_by_kernel=k2_by_kernel,
             route=att.k2_route(dtype, D), plain_ms=k2_plain,
             library_ms=lib_fwd_bwd - lib_fwd,
             library_fwd_bwd_ms=lib_fwd_bwd, sdpa_backend=SDPA_BACKEND,
             library_math_ms=math_bwd, **k2_b)
        k1_rows[dtype] = dict(max_abs_err=worst_k1[dtype], ms=k1_ms,
                              plain_ms=k1_plain, library_ms=lib_fwd, **k1_b)
        k2_rows[dtype] = dict(max_abs_err=worst_k2[dtype], ms=k2_ms,
                              plain_ms=k2_plain,
                              library_ms=lib_fwd_bwd - lib_fwd,
                              library_math_ms=math_bwd, **k2_b)
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


def ln_check(rows: int, width: int, dtype, phase: str = "k3_k4_check"):
    """K3 and K4 at (rows, width) in ``dtype`` against their plain
    versions, as ``ln_phase`` holds them; emits the line, raises when a
    gate fails, and returns (y's, dx's max abs error)."""
    from multi_modal_foundation_model_tpu_torch.ops import layernorm as ln

    eps, tol = 1e-5, TOL[dtype]
    x, w, b, dy = _ln_operands(rows, width, dtype, seed=rows)
    y = ln.layernorm_fwd(x, w, b, eps, dtype)
    got = ln.layernorm_bwd(x, w, dy, eps)
    again = ln.layernorm_bwd(x, w, dy, eps)
    torch.cuda.synchronize()
    y_ref = ln.layer_norm(x, w, b, eps, dtype)
    gates = k4_gates(x, w, dy, got, again, tol, eps)
    y_err = (y.float() - y_ref.float()).abs().max().item()
    ok = gates["ok"] and _excess(y, y_ref, tol) <= 0 and y.dtype == dtype
    emit(phase=phase, dtype=dtype_name(dtype), shape=[rows, width], tol=tol,
         plan=ln.ln_plan(width, dtype)._asdict(), y_max_abs_err=y_err,
         **dict(gates, ok=ok))
    if not ok:
        raise AssertionError(f"K3/K4 disagree with their plain versions "
                             f"({rows}, {width}, {dtype})")
    return y_err, gates["dx_max_abs_err"]


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

    H = GEOMETRY["hidden_size"]
    tokens = len(GEOMETRY["n_channels"]) * GEOMETRY["max_F"]
    rows_main, rows_b16 = BIG_B * tokens, TRAIN_B * tokens
    worst = {3: dict.fromkeys(DTYPES, 0.0), 4: dict.fromkeys(DTYPES, 0.0)}
    for dtype in DTYPES:
        for rows, width in ((rows_main, H), (rows_main - 1, H),
                            (rows_b16, H), (rows_b16 - 1, H), (1, H),
                            (1001, 64)):
            y_err, dx_err = ln_check(rows, width, dtype)
            worst[3][dtype] = max(worst[3][dtype], y_err)
            worst[4][dtype] = max(worst[4][dtype], dx_err)

    rows3, rows4, rows4_b16 = {}, {}, {}
    for dtype in DTYPES:
        for rows in (rows_main, rows_b16):
            t = ln_time(rows, H, dtype)
            n_sm, per_sm = ln._k4_card(ln._lib(ln.ln_plan(H, dtype).variant),
                                       torch.device("cuda", 0), H, dtype)
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


def kernel_vs_plain_step(root: Path, dtype, mode: str, cfg=None,
                         phase: str = "kernel_vs_plain_step"):
    """One training step's loss and parameter gradients, kernel path
    (``attn_impl="pallas"``, ``PALLAS_LAYERNORM = mode``) against the plain
    path (``"xla"``, ``"off"``): same weights, batch, objective, scheme and
    step seed, dropout 0.4 (the same Philox and u8 draws on both).
    f32: loss rtol 1e-5, every gradient element within 1e-6 + 1e-4 |plain|
    (f32 sums in other orders through ten layers). bf16: loss within 1e-2
    relative and every parameter's gradient within 5e-2 relative L2 (bf16
    activations rounded at other places: one bf16 step is 4e-3), except
    the attention key biases, whose exact gradient is 0 (softmax is
    shift-invariant) so that both paths hold rounding noise there. ``cfg``
    (default: the main path's at ``dtype``) and ``phase`` (the line's name)
    serve other configurations of the model."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)

    cfg = cfg or _cfg(dtype)
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
    _step_gates(phase, dtype, mode, lk, gk, lp, gp, n_heads=cfg.n_heads)


def _step_gates(phase: str, dtype, mode: str, lk: float, gk: dict,
                lp: float, gp: dict, **extra) -> None:
    """One step's loss and gradients, kernel path against plain path,
    under ``kernel_vs_plain_step``'s gates; emits the phase's line and
    raises when a gate fails."""
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
    emit(phase=phase, dtype=dtype_name(dtype), layernorm=mode,
         batch=TRAIN_B, dropout=DROPOUT, loss_kernel=lk, loss_plain=lp,
         loss_rel_err=loss_rel, grad_max_abs_err=worst, n_params=len(gk),
         ok=ok, **tol, **extra)
    if not ok:
        raise AssertionError(f"{phase} ({dtype}): loss {loss_rel}, grads "
                             f"{worst}")


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
# a kernel name (a regular expression) per launch of each wrapper: K2 and
# K4 launch two kernels each, their first is counted (K2's pass A:
# attn_bwd_dq_wg/wg128/tf/tf128_kernel); with dropout every K1 and K2
# draws its keep bits first (attn_fwd_keep_kernel, attn_bwd_keep_kernel),
# not counted
_KERNEL_GROUPS = (("k1", r"attn_fwd_(tf|wg|wg128|tf128)_kernel"),
                  ("k2", "attn_bwd_dq_"),
                  ("k3", "ln_fwd_kernel"), ("k4", "ln_bwd_dx_"),
                  ("philox", "philox_"),
                  ("session_rows", "session_rows_grad_kernel"))


def kernel_counts(prof) -> dict:
    """Launches of the port's kernels in a profile, by kernel name (graph
    replays included: the wrappers' counters see only Python calls)."""
    counts = dict.fromkeys((g for g, _ in _KERNEL_GROUPS), 0)
    for name, _ in _device_events(prof):
        for group, key in _KERNEL_GROUPS:
            if re.search(key, name):
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


def _train_loaders(B: int = TRAIN_B, n_trials: int = N_TRIALS):
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)

    T, N = GEOMETRY["max_F"], GEOMETRY["n_channels"]["ap"]
    splits = synthetic_splits(seed=SEED, n_trials=n_trials, n_neurons=N,
                              n_timesteps=T)
    kw = dict(batch_size=B, max_time_length=T, max_space_length=N)
    return (make_loader(splits.train, seed=SEED, **kw),
            make_loader(splits.val, shuffle=False, **kw))


def dispatch_phase(root: Path, dtype, mode: str, cfg=None, loaders=None,
                   phase: str = "dispatch") -> dict:
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
    Returns them. ``cfg`` (default: the main path's at ``dtype``),
    ``loaders`` (train, val) and ``phase`` (the line's name) serve other
    configurations of the model."""
    cfg = cfg or _cfg(dtype)
    train_l, val_l = loaders or _train_loaders()
    over = dict(device_resident_data=True, steps_per_dispatch=DISPATCH_K)
    want = dict(k1=2 * K1_ATTN_PER_FORWARD, k2=K1_ATTN_PER_FORWARD,
                k3=K3_PER_STEP if mode == "full" else 0,
                k4=K4_PER_STEP if mode in ("bwd", "full") else 0)
    runs = {}
    for path in ("graph", "eager"):
        log_dir = root / f"{phase}_{path}_{dtype_name(dtype)}"
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
    emit(phase=phase, dtype=dtype_name(dtype), layernorm=mode,
         batch=TRAIN_B, n_heads=cfg.n_heads, steps_per_dispatch=DISPATCH_K,
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
        raise AssertionError(f"{phase} phase: graph vs eager, replay after "
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
    once (nothing is read but the key) and the launch floor: the device
    time of a one-element ``fill_``, timed the same way, which no kernel
    launch goes under."""
    from multi_modal_foundation_model_tpu_torch.ops import random as rnd

    key = torch.tensor([2 ** 40 + 123], dtype=torch.int64, device="cuda")
    shapes = dict(u8=(TRAIN_B, 200, 256), uniform=(TRAIN_B, 100, 668))
    # the launch floor: a one-element fill_, timed the same way
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: one.fill_(1.0))
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
                         launch_floor_ms=floor_ms, shape=list(shape), **b)
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
    from multi_modal_foundation_model_tpu_torch.utils import profiling

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
        # the products of the step (its masker's dilation aside: the MtM
        # scheme varies by step)
        flops = profiling.step_flops(cfg, B)
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


# the linear baselines at trainer.yaml's width and the scripts' defaults:
# N = 668 neurons, T = 100, 2 behaviors, 400 trials split 320/40/40, B = 16
BASELINE_TRIALS, BASELINE_EPOCHS = 400, 2
BASELINE_LOSS_RTOL, BASELINE_R2_ATOL = 1e-4, 1e-4
BASELINE_FILTERS = {"encoding": {"input": ["behavior"], "output": ["ap"]},
                    "decoding": {"input": ["ap"], "output": ["behavior"]}}


def baseline_phase(root: Path) -> float:
    """``BaselineTrainer`` in each direction from one initial state_dict,
    2 epochs on the CPU and on the card (f32, TF32 off), settings from the
    port's trainer.yaml: per-step losses within rtol 1e-4 (f32 sums in
    other orders, 40 AdamW updates) and ``eval_trial_avg_r2`` within 1e-4
    absolute; then ``co_smoothing_eval_baseline`` on the card in the
    direction's mode (finite metrics). Prints the median step time (CUDA
    events over the second epoch), the epoch's wall time and the eval's.
    Returns the phase's wall seconds."""
    from multi_modal_foundation_model_tpu_torch.config import (
        default_config_path, update_config, config_from_kwargs)
    from multi_modal_foundation_model_tpu_torch.data import (
        DEFAULT_TARGETS, make_loader, synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import (
        co_smoothing_eval_baseline)
    from multi_modal_foundation_model_tpu_torch.models.baseline import (
        BaselineDecoder, BaselineEncoder)
    from multi_modal_foundation_model_tpu_torch.train import (
        BaselineTrainer, MetricLogger, OptimizerConfig, TrainerConfig)

    t_phase = time.perf_counter()
    config = update_config(default_config_path("trainer.yaml"),
                           config_from_kwargs({"model": "include:"
                                               + default_config_path(
                                                   "baseline.yaml")}))
    T = int(config.data.max_time_length)
    N = int(config.data.max_space_length)
    B = int(config.training.train_batch_size)
    n_beh = len(DEFAULT_TARGETS)
    splits = synthetic_splits(seed=SEED, n_trials=BASELINE_TRIALS,
                              n_neurons=N, n_timesteps=T)
    ocfg = OptimizerConfig.from_config(config.optimizer)
    failed = []
    for direction, modal_filter in BASELINE_FILTERS.items():
        def build(device):
            if direction == "encoding":
                return BaselineEncoder(n_beh, N, seq_len=T, device=device)
            return BaselineDecoder(N, n_beh, device=device)

        init = build("cpu").state_dict()
        runs = {}
        for device in ("cpu", "cuda"):
            model = build(device)
            model.load_state_dict(init)
            kw = dict(batch_size=B, max_time_length=T, max_space_length=N,
                      seed=SEED)
            log_dir = root / f"chip_smoke_baseline_{direction}_{device}"
            shutil.rmtree(log_dir, ignore_errors=True)
            tr = BaselineTrainer(
                model, make_loader(splits.train, **kw),
                make_loader(splits.val, shuffle=False, **kw), ocfg,
                TrainerConfig.from_config(
                    config, num_epochs=BASELINE_EPOCHS, seed=SEED,
                    save_plot_every_n_epochs=0, log_dir=str(log_dir)),
                modal_filter=modal_filter,
                logger=MetricLogger(str(log_dir), stdout=False))
            events = []
            if device == "cuda":
                inner = tr.train_step

                def timed(data, inner=inner):
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    loss = inner(data)
                    end.record()
                    events.append((start, end))
                    return loss

                tr.train_step = timed
            losses, epoch_s = [], []
            for epoch in range(BASELINE_EPOCHS):
                events.clear()
                t0 = time.perf_counter()
                losses += tr.train_epoch(epoch)["step_losses"]
                epoch_s.append(time.perf_counter() - t0)
            step_ms = [a.elapsed_time(b) for a, b in events]
            t0 = time.perf_counter()
            ev = tr.eval_epoch()
            eval_epoch_s = time.perf_counter() - t0
            runs[device] = dict(tr=tr, losses=losses, epoch_s=epoch_s,
                                step_ms=step_ms, eval=ev,
                                eval_epoch_s=eval_epoch_s)
        cpu, gpu = runs["cpu"], runs["cuda"]
        lc, lg = np.asarray(cpu["losses"]), np.asarray(gpu["losses"])
        rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
        r2_key = "eval_trial_avg_r2"
        r2_diff = abs(float(gpu["eval"][r2_key]) - float(cpu["eval"][r2_key]))

        mode = ("modal_spike" if direction == "encoding"
                else "modal_behavior")
        test_l = make_loader(splits.test, batch_size=splits.test.n_trials,
                             target=list(DEFAULT_TARGETS), max_time_length=T,
                             max_space_length=N, shuffle=False, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = co_smoothing_eval_baseline(
            gpu["tr"].model, test_l, mode, modal_filter=modal_filter,
            save_path=str(root / f"chip_smoke_baseline_{direction}_eval"),
            held_out_list=list(range(T)), avail_beh=list(DEFAULT_TARGETS),
            n_time_steps=T)
        eval_s = time.perf_counter() - t0
        flat = [v for r in res.values()
                for v in (r.values() if isinstance(r, dict) else [r])]
        finite = (all(math.isfinite(float(v)) for v in flat)
                  and bool(np.isfinite(lc).all() and np.isfinite(lg).all()))
        ok = (finite and len(lc) == len(lg) > 0
              and bool(np.allclose(lg, lc, rtol=BASELINE_LOSS_RTOL, atol=0))
              and r2_diff <= BASELINE_R2_ATOL)
        emit(phase="baseline", direction=direction, neurons=N, T=T,
             trials=BASELINE_TRIALS, batch=B, steps=len(lg),
             params=sum(p.numel() for p in gpu["tr"].model.parameters()),
             max_rel_step_loss_diff=rel, loss_rtol=BASELINE_LOSS_RTOL,
             eval_r2_cpu=float(cpu["eval"][r2_key]),
             eval_r2_cuda=float(gpu["eval"][r2_key]), eval_r2_abs_diff=r2_diff,
             r2_atol=BASELINE_R2_ATOL,
             median_step_ms=float(np.median(gpu["step_ms"])),
             epoch_wall_s=gpu["epoch_s"], cpu_epoch_wall_s=cpu["epoch_s"],
             eval_epoch_wall_s=gpu["eval_epoch_s"], harness_mode=mode,
             harness_wall_s=eval_s, metrics=res,
             device=torch.cuda.get_device_name(0), ok=ok)
        if not ok:
            failed.append(direction)
    wall = time.perf_counter() - t_phase
    emit(phase="baseline_wall", wall_s=wall)
    if failed:
        raise AssertionError(f"baseline phase failed: {failed} (see the "
                             "baseline lines)")
    return wall


def _finite_tree(v) -> bool:
    if isinstance(v, dict):
        return all(_finite_tree(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_finite_tree(x) for x in v)
    if isinstance(v, bool) or isinstance(v, str) or v is None:
        return True
    return math.isfinite(float(v))


def entry_points_phase(root: Path):
    """The four entry scripts' ``main(argv)`` in this process on the card
    (``--synthetic --device cuda --overwrite``, the default 668 neurons
    and 400 trials, results under ``build/``): both baseline directions
    trained 2 epochs and evaluated; the MultiModal trainer at mm.yaml's
    bf16 with the MtM menu, mixed objectives, the resident path and 10
    steps a dispatch for 1 epoch; its eval in all six modes. Each run's
    metrics rows and ``results.json`` must be finite, and the kernels'
    counters, set to 0 before each run and read after it, must show K1,
    K2, K3, K4 and the Philox draws on the training script and K1 and K3
    on the eval script. Returns (launch counts by script, wall seconds)."""
    from multi_modal_foundation_model_tpu_torch.scripts import (
        eval_baseline, eval_multi_modal, train_baseline, train_multi_modal)
    from multi_modal_foundation_model_tpu_torch.scripts._common import (
        DEFAULT_EID, log_dir_for)

    t_phase = time.perf_counter()
    base = root / "chip_smoke_scripts"
    shutil.rmtree(base, ignore_errors=True)
    common = ["--synthetic", "--device", "cuda", "--overwrite",
              "--base_path", str(base)]
    mm = ["--use_MtM", "--mixed_training"]
    mm_dir = log_dir_for(str(base), DEFAULT_EID,
                         {"input": ["ap", "behavior"],
                          "output": ["ap", "behavior"]},
                         "mask-temporal_ratio-0.1_mixed-True")
    runs = []
    for direction, modal_filter in BASELINE_FILTERS.items():
        d = log_dir_for(str(base), DEFAULT_EID, modal_filter, "linear")
        runs.append((f"train_baseline_{direction}", train_baseline.main,
                     common + NO_EPOCH_PLOTS + ["--direction", direction,
                                                "--num_epochs", "2"], d, ()))
        runs.append((f"eval_baseline_{direction}", eval_baseline.main,
                     common + ["--direction", direction], d, ()))
    runs.append(("train_multi_modal", train_multi_modal.main,
                 common + mm + NO_EPOCH_PLOTS + [
                     "--num_epochs", "1", "--device_resident",
                     "--set", "training.steps_per_dispatch=10"],
                 mm_dir, ("k1", "k2", "k3", "k4", "philox")))
    runs.append(("eval_multi_modal", eval_multi_modal.main,
                 common + mm + ["--co_smooth", "--forward_pred",
                                "--inter_region", "--intra_region"],
                 mm_dir, ("k1", "k3")))
    counts, walls, failed = {}, {}, []
    for name, main, argv, log_dir, need in runs:
        reset_counts()
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = read_counts()
        log_dir = Path(log_dir)
        if name.startswith("train"):
            rows = [json.loads(line) for line in
                    (log_dir / "metrics.jsonl").read_text().splitlines()]
            written = {"rows": rows}
            files = ["model_best.pt", "model_last.pt"]
        else:
            written = json.loads((log_dir / "eval" / "results.json")
                                 .read_text())
            files = ["eval/results.json"]
        present = all((log_dir / f).exists() for f in files)
        finite = _finite_tree(written)
        launched = all(counts[name][k] > 0 for k in need)
        ok = present and finite and launched
        if name.endswith("multi_modal"):
            dtype = json.loads((log_dir / "model_config.json")
                               .read_text())["compute_dtype"]
            ok = ok and dtype == "bfloat16"       # mm.yaml's default
            written = dict(written, compute_dtype=dtype)
        emit(phase="entry_point", script=name, argv=argv,
             wall_s=walls[name], launches=counts[name],
             launches_required=list(need), files_present=present,
             finite=finite, written=written, ok=ok)
        if not ok:
            failed.append(name)
    wall = time.perf_counter() - t_phase
    emit(phase="entry_points_wall", wall_s=wall, by_script=walls,
         device=torch.cuda.get_device_name(0))
    if failed:
        raise AssertionError(f"entry points failed: {failed} (see the "
                             "entry_point lines)")
    return counts, wall


# ---------------------------------------------------------------------------
# phase 8: multi-session pretraining (the session-stitched model)
# ---------------------------------------------------------------------------

# 10 synthetic sessions of 668 + 37 i neurons (668-1001), 400 trials each,
# padded to multiples of 128: one bucket of N_max = 1024
MS_SESSIONS, MS_TRIALS, MS_PAD = 10, 400, 128
MS_DEVICE = "cuda"


def ms_sessions(n_trials: int = MS_TRIALS) -> dict:
    """The phase's sessions (seed ``SEED + i``), made in threads."""
    from concurrent.futures import ThreadPoolExecutor

    from multi_modal_foundation_model_tpu_torch.data import synthetic_splits

    T, N = GEOMETRY["max_F"], GEOMETRY["n_channels"]["ap"]

    def make(i):
        eid = f"ms-{i}"
        return eid, synthetic_splits(seed=SEED + i, n_trials=n_trials,
                                     n_neurons=N + 37 * i, n_timesteps=T,
                                     eid=eid)

    with ThreadPoolExecutor(8) as ex:
        return dict(ex.map(make, range(MS_SESSIONS)))


def ms_loaders(sessions: dict, n_buckets: int = 1):
    from multi_modal_foundation_model_tpu_torch.train import (
        build_multisession_loaders)

    train, val, test, meta = build_multisession_loaders(
        sessions, batch_size=TRAIN_B, max_time_length=GEOMETRY["max_F"],
        pad_multiple=MS_PAD, n_buckets=n_buckets, seed=SEED)
    return dict(train=train, val=val, test=test, meta=meta)


def ms_model(meta: dict, dtype, **over):
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModal, MultiModalConfig)

    cfg = MultiModalConfig(**{
        **GEOMETRY, "n_channels": {"ap": meta["n_max"], "behavior": 2},
        "n_sessions": len(meta["eids"]), "compute_dtype": dtype_name(dtype),
        **over})
    return MultiModal(cfg, generator=torch.Generator().manual_seed(SEED))


def ms_trainer(loaders: dict, dtype, log_dir, tcfg_over=None, **model_over):
    """A ``MultiSessionTrainer`` on the resident path, K = 10 steps a
    dispatch, dropout 0.4, the MtM menu with the region modes and mixed
    training (trainer_mm.yaml's B=16)."""
    from multi_modal_foundation_model_tpu_torch.ops.masking import (
        RegionTable)
    from multi_modal_foundation_model_tpu_torch.train import (
        MetricLogger, MultiSessionTrainer, OptimizerConfig, TrainerConfig)

    meta = loaders["meta"]
    table = RegionTable.build(meta["per_session_region_ids"],
                              region_vocab=meta["region_vocab"],
                              device=MS_DEVICE)
    tcfg = TrainerConfig(**{**dict(
        num_epochs=1, mask_type="input", mask_mode=MTM_MENU,
        mixed_training=True, seed=SEED, log_dir=str(log_dir),
        device_resident_data=True, steps_per_dispatch=DISPATCH_K),
        **(tcfg_over or {})})
    return MultiSessionTrainer(
        ms_model(meta, dtype, **model_over), loaders["train"],
        loaders["val"], OptimizerConfig(), tcfg, region_table=table,
        eid_to_sid=meta["eid_to_sid"],
        logger=MetricLogger(str(log_dir), stdout=False))


def _ms_group(tr, B: int = TRAIN_B):
    """K steps of the resident path over the stacked block, one for each
    of the first K sessions (its first B trials), schemes in turn."""
    blocks = tr._blocks()          # one bucket: every eid shares a block
    eids = list(tr.train_loaders)
    group = []
    for k in range(DISPATCH_K):
        eid = eids[k % len(eids)]
        group.append((np.arange(B) + blocks[eid][1], np.ones(B, np.int32),
                      k % len(tr.mtm_modes), tr.eid_to_sid[eid]))
    return blocks[eids[0]][0], group


def multisession_phase(root: Path, loaders: dict, dtype, mode: str) -> dict:
    """The session-stitched model at full width (10 sessions, N_max 1024,
    13.2M stitched parameters) on the resident path, K = 10: one epoch
    (every session's batches interleaved, 50 steps at 100 trials a
    session, groups crossing sessions over one stacked block) as CUDA
    graphs and the same steps
    run eagerly, per step loss and per parameter bit for bit or within the
    ``dispatch`` gates; one group of 10 steps over 10 sessions profiled
    (launches a step of K1-K4 and Philox, by kernel name); then the
    per-session ``eval_epoch`` on the graph trainer, every metric finite.
    Returns the profiled group's launch counts."""
    want = dict(k1=2 * K1_ATTN_PER_FORWARD, k2=K1_ATTN_PER_FORWARD,
                k3=K3_PER_STEP if mode == "full" else 0,
                k4=K4_PER_STEP if mode in ("bwd", "full") else 0)
    runs = {}
    for path in ("graph", "eager"):
        log_dir = root / f"multisession_{path}_{dtype_name(dtype)}"
        shutil.rmtree(log_dir, ignore_errors=True)
        with ln_mode(mode):
            tr = ms_trainer(loaders, dtype, log_dir)
            if path == "eager":
                tr.graphs = _EagerSteps()
            t0 = time.perf_counter()
            losses = tr.train_epoch(0)["step_losses"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = dict(losses=losses, wall_s=wall, params={
                n: p.detach().clone()
                for n, p in tr.model.state_dict().items()},
                variants=sorted(map(str, tr.graphs.graphs)),
                capture_s=list(tr.graphs.capture_s.values()))
            if path == "graph":
                data, group = _ms_group(tr)
                counts = None
                for _ in range(3):
                    try:
                        with traced() as prof:
                            tr._dispatch(data, group, "token_masking")
                    except TraceLost:
                        continue
                    counts = kernel_counts(prof)
                    if _launches_ok(counts, DISPATCH_K, want):
                        break
                t0 = time.perf_counter()
                ev = tr.eval_epoch()
                torch.cuda.synchronize()
                run.update(counts=counts, eval_s=time.perf_counter() - t0,
                           eval_per_session=ev["eval_per_session"],
                           eval_loss=ev["eval_loss"],
                           stitched_params=sum(
                               p.numel() for n, p in
                               tr.model.named_parameters()
                               if "token_embed_" in n or ".ap.out." in n))
        runs[path] = run
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
    n_steps = sum(len(l) for l in loaders["train"].values())
    finite = (all(math.isfinite(x) for x in g["losses"])
              and len(g["losses"]) == n_steps
              and _finite_tree(g["eval_per_session"])
              and len(g["eval_per_session"]) == MS_SESSIONS)
    counts_ok = g["counts"] is not None and _launches_ok(
        g["counts"], DISPATCH_K, want)
    ok = finite and gate_ok and counts_ok
    meta = loaders["meta"]
    emit(phase="multisession", dtype=dtype_name(dtype), layernorm=mode,
         batch=TRAIN_B, steps_per_dispatch=DISPATCH_K,
         sessions=MS_SESSIONS, num_neurons=meta["num_neurons"],
         n_max=meta["n_max"], stitched_params=g["stitched_params"],
         steps=len(g["losses"]), graph_losses=g["losses"],
         losses_bit_equal=bit_losses, loss_max_rel_err=loss_rel,
         params_not_bit_equal=bit_params, n_params=len(g["params"]),
         param_max_abs_err=param_abs, param_max_rel_l2=param_rel, **gate,
         variants=len(g["variants"]), capture_s=g["capture_s"],
         graph_wall_s=g["wall_s"], eager_wall_s=e["wall_s"],
         launches_profiled_group=g["counts"],
         launches_per_step={k: v / DISPATCH_K
                            for k, v in (g["counts"] or {}).items()},
         launches_per_step_expected=want, eval_s=g["eval_s"],
         eval_loss=g["eval_loss"], eval_per_session=g["eval_per_session"],
         device=torch.cuda.get_device_name(0), ok=ok)
    if not ok:
        raise AssertionError("multisession phase: graph vs eager, "
                             "launches or eval off (see its line)")
    return g["counts"]


def multisession_buckets(root: Path, sessions: dict, loaders1: dict,
                         dtype, mode: str, f32_mode: str) -> None:
    """``n_buckets=2``: two bucket widths, one graph key per (width,
    variant), one epoch on the per-session K-group path (the buckets
    cannot share one block); then the width invariance of the stitched
    forward, f32 under ``f32_mode``: a session's test trials at its
    bucket width against the same trials at N_max, atol 1e-5."""
    loaders2 = ms_loaders(sessions, n_buckets=2)
    log_dir = root / "multisession_buckets"
    shutil.rmtree(log_dir, ignore_errors=True)
    with ln_mode(mode):
        tr = ms_trainer(loaders2, dtype, log_dir)
        t0 = time.perf_counter()
        losses = tr.train_epoch(0)["step_losses"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    widths = sorted(set(loaders2["meta"]["bucket_widths"].values()))
    keys = list(tr.graphs.graphs)
    key_widths = sorted({k[0] for k in keys})
    capture_s = list(tr.graphs.capture_s.values())
    finite = all(math.isfinite(x) for x in losses)
    del tr
    torch.cuda.empty_cache()

    # width invariance, f32, the kernel path
    from multi_modal_foundation_model_tpu_torch.models import ModalityInput

    meta = loaders2["meta"]
    eid = min(meta["eids"], key=lambda e: meta["bucket_widths"][e])
    w, sid = meta["bucket_widths"][eid], meta["eid_to_sid"][eid]
    with ln_mode(f32_mode):
        model = ms_model(loaders1["meta"], torch.float32)
        preds = []
        for arrays in (loaders2["test"][eid].arrays,
                       loaders1["test"][eid].arrays):
            def t(k):
                return torch.as_tensor(arrays[k][:TRAIN_B], device=MS_DEVICE)
            spikes, beh = t("spikes_data"), t("target")
            attn, ts = t("time_attn_mask"), t("spikes_timestamps")
            inputs = {m: ModalityInput(
                inputs=x, targets=x, attn_mask=attn, timestamps=ts,
                eval_mask=torch.zeros_like(x, dtype=torch.int32))
                for m, x in (("ap", spikes), ("behavior", beh))}
            with torch.no_grad():
                out = model(inputs, session_id=sid,
                            space_attn_mask=t("space_attn_mask"))
            preds.append((out.mod_preds["ap"][..., :w],
                          out.mod_preds["behavior"]))
    (ap_w, beh_w), (ap_n, beh_n) = preds
    inv_err = max((ap_w - ap_n).abs().max().item(),
                  (beh_w - beh_n).abs().max().item())
    ok = (finite and len(widths) == 2 and key_widths == widths
          and inv_err <= 1e-5)
    emit(phase="multisession_buckets", dtype=dtype_name(dtype),
         layernorm=mode, n_buckets=2, bucket_widths=meta["bucket_widths"],
         widths=widths, graph_key_widths=key_widths,
         variants_captured=[str(k) for k in keys],
         capture_s=capture_s,
         steps=len(losses), epoch_wall_s=wall,
         width_invariance=dict(eid=eid, bucket_width=w, n_max=meta["n_max"],
                               dtype="float32", preds_max_abs_err=inv_err,
                               atol=1e-5),
         ok=ok)
    if not ok:
        raise AssertionError("multisession buckets: widths, graph keys or "
                             "width invariance off (see its line)")


def multisession_step_check(root: Path, loaders: dict, dtype,
                            mode: str) -> None:
    """One stitched step's loss and gradients, kernel path against plain
    path (``kernel_vs_plain_step``'s gates): same weights, the widest
    session's first B=16 train trials, token masking with
    ``intra-region``, dropout 0.4, the same step seed."""
    results = []
    for impl, m in (("pallas", mode), ("xla", "off")):
        with ln_mode(m):
            tr = ms_trainer(loaders, dtype, root / "multisession_step",
                            attn_impl=impl)
            eid = list(tr.train_loaders)[-1]
            arrays = tr.train_loaders[eid].arrays
            batch = tr._device_batch({k: arrays[k][:TRAIN_B]
                                      for k in tr._BATCH_KEYS})
            sid = tr.eid_to_sid[eid]
            out = tr.step_loss(batch, "token_masking",
                               MTM_MENU.index("intra-region"), step=5,
                               session=sid)
            out.loss.backward()
        results.append((out.loss.item(), {
            n: p.grad.detach().clone()
            for n, p in tr.model.named_parameters()}))
        del tr
    (lk, gk), (lp, gp) = results
    _step_gates("multisession_kernel_vs_plain_step", dtype, mode, lk, gk,
                lp, gp, session=sid)


def multisession_time(root: Path, loaders: dict, dtype, mode: str) -> None:
    """Three graph steps at B=16 and B=256, one variant each (MtM
    ``temporal``, no mixed training), interleaved in this process: the
    single-session step, the multi-session step and the session-mixed
    multi-session step (one multi-session trainer: the mixed graphs are
    keyed apart), in the order single, multi, mixed, mixed, multi,
    single (4 segments each, a segment a dispatch of K = 10 replays:
    the first B trials of the single session, of the first multi-session
    session, and for the mixed step B trials strided over all ten
    sessions); medians and spreads; a profile of one segment each
    (device busy, idle share, the session-rows kernel and the gathers);
    the peak memory of each path's first step at each B (its eager run
    and capture: a replay allocates nothing, so a peak read around
    replays shows only what stays resident). Emits
    ``multisession_time`` (multi against single, the peak with both
    trainers resident) and ``multisession_mixed_time`` (mixed against
    multi)."""
    one = dict(mask_mode=("temporal",), mixed_training=False)
    loader = _step_loaders(TRAIN_B)
    match = {"session_rows_grad_ms": ("session_rows_grad",),
             "gather_ms": ("indexSelect", "index_select", "gather")}
    with ln_mode(mode):
        single = _trainer(_cfg(dtype), loader, None, 1,
                          root / "multisession_time",
                          tcfg_over=dict(one, device_resident_data=True,
                                         steps_per_dispatch=DISPATCH_K))
        s_data = single._device_data(loader)
        multi = ms_trainer(loaders, dtype, root / "multisession_time",
                           tcfg_over=one)
        eids = multi._stack_groups()[0]
        m_data, off = multi._blocks()[eids[0]]
        x_data, sids = multi._mixed_block(eids)
        for B in (TRAIN_B, BIG_B):
            valid = np.ones(B, np.int32)
            s_group = [(np.arange(B), valid, 0)] * DISPATCH_K
            m_group = [(np.arange(B) + off, valid, 0, 0)] * DISPATCH_K
            x_group = _ms_mixed_group(multi, x_data, sids, B, schemes=False)
            segs_fn = {
                "single": lambda: single._dispatch(s_data, s_group, None),
                "multi": lambda: multi._dispatch(m_data, m_group, None),
                "mixed": lambda: multi._dispatch(x_data, x_group, None)}
            peak = {}
            for name, fn in segs_fn.items():      # eager run and capture
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peak[name] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.max_memory_allocated() / 1e9
            segs = {name: [] for name in segs_fn}
            order = ("single", "multi", "mixed")
            for p in range(4):
                for name in (order if p % 2 == 0 else order[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    segs_fn[name]()
                    torch.cuda.synchronize()
                    segs[name].append((time.perf_counter() - t0) * 1e3
                                      / DISPATCH_K)
            prof = {name: device_breakdown(fn, top=6, match=match)
                    for name, fn in segs_fn.items()}
            med = {k: float(np.median(v)) for k, v in segs.items()}
            spread = {k: max(v) - min(v) for k, v in segs.items()}
            busy = {k: v["device_busy_ms"] / DISPATCH_K
                    for k, v in prof.items()}
            idle = {k: v["idle_share"] for k, v in prof.items()}
            capture = {"single": list(single.graphs.capture_s.values()),
                       "multi": [v for k, v in multi.graphs.capture_s.items()
                                 if not k[2]],
                       "mixed": [v for k, v in multi.graphs.capture_s.items()
                                 if k[2]]}
            pair = ("single", "multi")
            emit(phase="multisession_time", dtype=dtype_name(dtype),
                 layernorm=mode, batch=B, steps_per_segment=DISPATCH_K,
                 segments_ms={k: segs[k] for k in pair},
                 ms_per_step={k: med[k] for k in pair},
                 spread_ms={k: spread[k] for k in pair},
                 multi_minus_single_ms=med["multi"] - med["single"],
                 seq_per_s={k: B / med[k] * 1e3 for k in pair},
                 device_busy_ms_per_step={k: busy[k] for k in pair},
                 idle_share={k: idle[k] for k in pair},
                 capture_s={k: capture[k] for k in pair},
                 peak_mem_gb_both=resident,
                 peak_mem_gb_first_step={k: peak[k] for k in pair},
                 device=torch.cuda.get_device_name(0))
            pair = ("multi", "mixed")
            emit(phase="multisession_mixed_time", dtype=dtype_name(dtype),
                 layernorm=mode, batch=B, steps_per_segment=DISPATCH_K,
                 segments_ms={k: segs[k] for k in pair},
                 ms_per_step={k: med[k] for k in pair},
                 spread_ms={k: spread[k] for k in pair},
                 mixed_minus_unmixed_ms=med["mixed"] - med["multi"],
                 mixed_over_unmixed=med["mixed"] / med["multi"],
                 seq_per_s={k: B / med[k] * 1e3 for k in pair},
                 device_busy_ms_per_step={k: busy[k] for k in pair},
                 idle_share={k: idle[k] for k in pair},
                 session_rows_grad_ms_per_step={
                     k: prof[k]["session_rows_grad_ms"] / DISPATCH_K
                     for k in pair},
                 gather_ms_per_step={
                     k: prof[k]["gather_ms"] / DISPATCH_K for k in pair},
                 peak_mem_gb_first_step={k: peak[k] for k in pair},
                 mixed_minus_unmixed_peak_gb=peak["mixed"] - peak["multi"],
                 capture_s={k: capture[k] for k in pair},
                 device=torch.cuda.get_device_name(0))
            for name, pr in prof.items():
                emit(phase="multisession_profile", dtype=dtype_name(dtype),
                     layernorm=mode, batch=B, path=name, steps=DISPATCH_K,
                     **pr)
    del single, multi, s_data, m_data, x_data, segs_fn
    torch.cuda.empty_cache()


# the entry phase's session count: the scripts' default is 4, but the
# eval's six modes take ~10 s a session (41.7 s for 4 on an H100 80GB
# HBM3), the long pole of the phase
MS_ENTRY_SESSIONS = 2


def multisession_entry_phase(root: Path):
    """``train_multi_session`` at its defaults but ``--num_sessions 2``
    (``MS_ENTRY_SESSIONS``: synthetic sessions of 668 and 705 neurons, 400
    trials, mm.yaml's bf16) with the MtM menu, mixed objectives, the
    resident path and 10 steps a dispatch, 1 epoch; then
    ``eval_multi_modal --multi_session`` in all six modes on that
    checkpoint; then ``train_multi_session --mixed_session_batches`` (the
    same run with batches mixing the two sessions). Finite metrics rows
    and per-session results, the counters (set to 0 before each script,
    read after it) showing K1, K2, K3, K4 and Philox on the training
    scripts (and the session-rows kernel on the mixed one) and K1 and K3
    on the eval. Returns (launch counts by script, wall seconds)."""
    from multi_modal_foundation_model_tpu_torch.scripts import (
        eval_multi_modal, train_multi_session)
    from multi_modal_foundation_model_tpu_torch.scripts._common import (
        log_dir_for)

    t_phase = time.perf_counter()
    base = root / "chip_smoke_multisession_scripts"
    shutil.rmtree(base, ignore_errors=True)
    common = ["--synthetic", "--device", "cuda", "--overwrite",
              "--base_path", str(base)]
    log_dir = Path(log_dir_for(str(base), f"multi{MS_ENTRY_SESSIONS}",
                               {"input": ["ap", "behavior"],
                                "output": ["ap", "behavior"]},
                               "stitched_ratio-0.3"))
    runs = [("train_multi_session", train_multi_session.main,
             common + NO_EPOCH_PLOTS + [
                 "--use_MtM", "--mixed_training", "--num_epochs", "1",
                 "--device_resident", "--steps_per_dispatch", "10",
                 "--num_sessions", str(MS_ENTRY_SESSIONS)],
             ("k1", "k2", "k3", "k4", "philox")),
            ("eval_multi_session", eval_multi_modal.main,
             common + ["--multi_session", "--model_dir", str(log_dir),
                       "--use_MtM", "--co_smooth", "--forward_pred",
                       "--inter_region", "--intra_region"],
             ("k1", "k3")),
            # session-mixed batches (writes over the first run's dir)
            ("train_mixed_multi_session", train_multi_session.main,
             common + NO_EPOCH_PLOTS + [
                 "--use_MtM", "--mixed_training", "--num_epochs", "1",
                 "--device_resident", "--steps_per_dispatch", "10",
                 "--num_sessions", str(MS_ENTRY_SESSIONS),
                 "--mixed_session_batches"],
             ("k1", "k2", "k3", "k4", "philox", "session_rows"))]
    counts, walls, failed = {}, {}, []
    for name, main, argv, need in runs:
        reset_counts()
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = read_counts()
        if name.startswith("train"):
            written = {"rows": [json.loads(line) for line in (
                log_dir / "metrics.jsonl").read_text().splitlines()],
                "sessions": json.loads((log_dir / "sessions.json")
                                       .read_text())}
            files = ["model_best.pt", "model_last.pt", "sessions.json"]
        else:
            written = json.loads((log_dir / "eval" / "results.json")
                                 .read_text())
            eids = [e for e in written if e != "mean_over_sessions"]
            files = [f"eval/{e}/{m}/bps.npy" for e in eids
                     for m in ("per_neuron", "forward_pred", "inter_region",
                               "intra_region", "modal_spike",
                               "modal_behavior")]
        present = all((log_dir / f).exists() for f in files)
        finite = _finite_tree(written)
        launched = all(counts[name][k] > 0 for k in need)
        ok = present and finite and launched
        if name.startswith("eval"):
            ok = ok and len(eids) == MS_ENTRY_SESSIONS
        emit(phase="multisession_entry_point", script=name, argv=argv,
             wall_s=walls[name], launches=counts[name],
             launches_required=list(need), files_present=present,
             finite=finite, written=written, ok=ok)
        if not ok:
            failed.append(name)
    wall = time.perf_counter() - t_phase
    emit(phase="multisession_entry_wall", wall_s=wall, by_script=walls,
         device=torch.cuda.get_device_name(0))
    if failed:
        raise AssertionError(f"multi-session entry points failed: {failed}")
    return counts, wall


# ---------------------------------------------------------------------------
# phase 10: session-mixed batches (slice 13)
# ---------------------------------------------------------------------------

# the same ten sessions at 100 trials each (80 train): one mixed epoch of
# B = 16 is 50 steps
MS_MIXED_TRIALS = 100
# launches of the session-rows kernel a mixed step: the encoder's and the
# decoder's stitched tokenizer (kernel, bias), the head (kernel, bias) and
# the session table
SESSION_ROWS_PER_STEP = 7


def session_rows_check() -> dict:
    """The fixed-order row-sum kernel (``csrc/session_rows.cu``, the
    backward of the mixed step's per-sample gathers) against its plain
    version at the B=16 mixed step's shapes, 10 sessions: the stitched
    tokenizer kernel's gradient (16 x 1024 x 512, f32 and bf16), the
    head's (16 x 256 x 1024, f32), the biases' and the session table's.
    Bit for bit (both add each session's rows in sample order from 0),
    and bit-equal from one launch to the next. Timed at the tokenizer
    kernel's shape beside the plain version and ``index_add_`` (the
    library call for the same sums, atomics in any order); the bound is
    the bytes (the gradient read once, the sums written once)."""
    from multi_modal_foundation_model_tpu_torch.ops import session_rows as sr

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    S, B = MS_SESSIONS, TRAIN_B
    ids = torch.randint(0, S - 2, (B,), device="cuda", generator=gen)
    cases = [("tokenizer_kernel", (1024, 512), torch.float32),
             ("tokenizer_kernel", (1024, 512), torch.bfloat16),
             ("head_kernel", (256, 1024), torch.float32),
             ("tokenizer_bias", (512,), torch.float32),
             ("tokenizer_bias", (512,), torch.bfloat16),
             ("head_bias", (1024,), torch.float32),
             ("session_table", (256,), torch.float32)]
    errs, out = {}, {}
    for name, shape, dtype in cases:
        g = torch.randn((B,) + shape, device="cuda", generator=gen).to(dtype)
        got = sr.session_rows_grad(g, ids, S)
        again = sr.session_rows_grad(g, ids, S)
        want = sr.session_rows_grad_reference(g, ids, S)
        key = f"{name}_{dtype_name(dtype)}"
        errs[key] = (got - want).abs().max().item()
        if not torch.equal(got, again) or errs[key] != 0.0 \
                or (got[S - 2:] != 0).any():
            emit(phase="session_rows_check", case=key, max_abs_err=errs[key],
                 ok=False)
            raise AssertionError(f"session rows kernel {key}: not bit-equal "
                                 "to its plain version or to itself")
        if name == "tokenizer_kernel":
            g2 = g.reshape(B, -1)
            n_bytes = g.numel() * g.element_size() + S * g2.shape[1] * 4
            out[dtype] = dict(
                max_abs_err=errs[key],
                ms=device_ms(lambda: sr.session_rows_grad(g, ids, S)),
                plain_ms=cuda_time_ms(
                    lambda: sr.session_rows_grad_reference(g, ids, S), 5, 1),
                library_ms=device_ms(lambda: torch.zeros(
                    S, g2.shape[1], dtype=g.dtype, device="cuda").index_add_(
                        0, ids, g2)),
                library_call="torch.zeros(S, M).index_add_(0, ids, g) (in "
                             "g's dtype)",
                shape=[B, *shape], sessions=S,
                **_bound(n_bytes + B * 8, g.numel(), torch.float32))
    emit(phase="session_rows_check", max_abs_err_by_case=errs,
         timed={dtype_name(k): v for k, v in out.items()}, ok=True)
    return out


def _ms_mixed_group(tr, data: dict, sids: np.ndarray, B: int,
                    schemes: bool = True):
    """K mixed steps over a block: trials spread over the whole block (a
    stride through it, so every session is in each batch), schemes of
    the MtM menu in turn."""
    stride = max(1, len(sids) // B)
    group = []
    for k in range(DISPATCH_K):
        idx = (np.arange(B) * stride + k) % len(sids)
        group.append((idx, np.ones(B, np.int32),
                      k % len(tr.mtm_modes) if schemes else 0, sids[idx]))
    return group


def multisession_mixed_phase(root: Path, loaders: dict, dtype,
                             mode: str) -> dict:
    """Session-mixed batches at full width (10 sessions, N_max 1024, B=16,
    dropout 0.4, the MtM menu with the region modes and mixed training,
    resident, K = 10): one epoch (50 steps: 100 trials a session) as CUDA
    graphs, the same steps run eagerly, and run eagerly again; the graph
    run must equal the eager one and the two eager runs each other, per
    step loss and per parameter, bit for bit (the gathers' backward sums
    repeated session ids in a fixed order). A group of 10 mixed steps is
    profiled: K1 30, K2 15, K3 62, K4 32 and 7 session-rows launches a
    step, and Philox. Returns the profiled group's launch counts."""
    want = dict(k1=2 * K1_ATTN_PER_FORWARD, k2=K1_ATTN_PER_FORWARD,
                k3=K3_PER_STEP if mode == "full" else 0,
                k4=K4_PER_STEP if mode in ("bwd", "full") else 0,
                session_rows=SESSION_ROWS_PER_STEP)
    runs = {}
    for path in ("graph", "eager", "eager_again"):
        log_dir = root / f"multisession_mixed_{path}_{dtype_name(dtype)}"
        shutil.rmtree(log_dir, ignore_errors=True)
        with ln_mode(mode):
            tr = ms_trainer(loaders, dtype, log_dir,
                            tcfg_over=dict(mixed_session_batches=True))
            if path != "graph":
                tr.graphs = _EagerSteps()
            t0 = time.perf_counter()
            losses = tr.train_epoch(0)["step_losses"]
            torch.cuda.synchronize()
            run = dict(losses=losses, wall_s=time.perf_counter() - t0,
                       params={n: p.detach().clone()
                               for n, p in tr.model.state_dict().items()},
                       variants=sorted(map(str, tr.graphs.graphs)),
                       capture_s=list(tr.graphs.capture_s.values()),
                       steps_per_epoch=tr._steps_per_epoch())
            if path == "graph":
                data, sids = tr._mixed_block(tr._stack_groups()[0])
                group = _ms_mixed_group(tr, data, sids, TRAIN_B)
                counts = None
                for _ in range(3):
                    try:
                        with traced() as prof:
                            tr._dispatch(data, group, "token_masking")
                    except TraceLost:
                        continue
                    counts = kernel_counts(prof)
                    if _launches_ok(counts, DISPATCH_K, want):
                        break
                run.update(counts=counts, keys_mixed=all(
                    k[2] is True for k in tr.graphs.graphs))
        runs[path] = run
        del tr
        torch.cuda.empty_cache()
    g, e, e2 = runs["graph"], runs["eager"], runs["eager_again"]

    def same(a, b):
        return a["losses"] == b["losses"] and all(
            torch.equal(a["params"][n], b["params"][n]) for n in a["params"])

    bit_graph, bit_eager = same(g, e), same(e, e2)
    n_steps = len(g["losses"])
    counts_ok = g["counts"] is not None and _launches_ok(
        g["counts"], DISPATCH_K, want)
    finite = all(math.isfinite(x) for x in g["losses"])
    ok = (bit_graph and bit_eager and counts_ok and finite
          and n_steps == g["steps_per_epoch"] and g["keys_mixed"])
    emit(phase="multisession_mixed", dtype=dtype_name(dtype),
         layernorm=mode, batch=TRAIN_B, steps_per_dispatch=DISPATCH_K,
         sessions=MS_SESSIONS, trials_per_session=MS_MIXED_TRIALS,
         n_max=loaders["meta"]["n_max"], steps=n_steps,
         steps_per_epoch=g["steps_per_epoch"], graph_losses=g["losses"],
         graph_equals_eager_bit_for_bit=bit_graph,
         eager_equals_eager_bit_for_bit=bit_eager,
         params_not_bit_equal_graph_eager=sum(
             not torch.equal(g["params"][n], e["params"][n])
             for n in g["params"]),
         variants=len(g["variants"]), graph_keys_mixed=g["keys_mixed"],
         capture_s=g["capture_s"], graph_wall_s=g["wall_s"],
         eager_wall_s=e["wall_s"], launches_profiled_group=g["counts"],
         launches_per_step={k: v / DISPATCH_K
                            for k, v in (g["counts"] or {}).items()},
         launches_per_step_expected=want,
         device=torch.cuda.get_device_name(0), ok=ok)
    if not ok:
        raise AssertionError("multisession_mixed: graph vs eager, eager vs "
                             "eager or launches off (see its line)")
    return g["counts"]


def multisession_mixed_forward(loaders: dict, mode: str) -> None:
    """A batch of 10 test trials, one from each session, through the
    stitched model with per-sample ids, against each sample's own
    scalar-id forward of the same batch (f32, the kernel path, atol
    1e-5)."""
    from multi_modal_foundation_model_tpu_torch.models import ModalityInput

    meta = loaders["meta"]
    arrays = [loaders["test"][e].arrays for e in meta["eids"]]

    def t(k):
        return torch.as_tensor(np.stack([a[k][0] for a in arrays]),
                               device=MS_DEVICE)
    spikes, beh = t("spikes_data"), t("target")
    attn, ts, space = (t("time_attn_mask"), t("spikes_timestamps"),
                       t("space_attn_mask"))
    ap_eval = torch.zeros_like(spikes, dtype=torch.int32)
    ap_eval[:, 70:] = 1
    inputs = {m: ModalityInput(inputs=x, targets=x, attn_mask=attn,
                               timestamps=ts, eval_mask=ev)
              for m, x, ev in (("ap", spikes, ap_eval),
                               ("behavior", beh,
                                torch.zeros_like(beh, dtype=torch.int32)))}
    sids = torch.tensor([meta["eid_to_sid"][e] for e in meta["eids"]],
                        device=MS_DEVICE)
    with ln_mode(mode), torch.no_grad():
        model = ms_model(meta, torch.float32)
        mixed = model(inputs, session_id=sids,
                      space_attn_mask=space).mod_preds["ap"]
        err = max((mixed[i] - model(inputs, session_id=int(s),
                                    space_attn_mask=space).mod_preds["ap"][i]
                   ).abs().max().item()
                  for i, s in enumerate(sids.tolist()))
    ok = err <= 1e-5 and bool(torch.isfinite(mixed).all())
    emit(phase="multisession_mixed_forward", dtype="float32", layernorm=mode,
         batch=len(sids), sessions=len(sids), preds_max_abs_err=err,
         atol=1e-5, ok=ok)
    if not ok:
        raise AssertionError(f"mixed forward != scalar-id forward: {err}")


def multisession_mixed_buckets(root: Path, sessions: dict, dtype,
                               mode: str) -> None:
    """``n_buckets=2`` with mixed batches: one block and one graph set a
    bucket width, every key a mixed one; one epoch, losses finite."""
    loaders2 = ms_loaders(sessions, n_buckets=2)
    log_dir = root / "multisession_mixed_buckets"
    shutil.rmtree(log_dir, ignore_errors=True)
    with ln_mode(mode):
        tr = ms_trainer(loaders2, dtype, log_dir,
                        tcfg_over=dict(mixed_session_batches=True))
        t0 = time.perf_counter()
        losses = tr.train_epoch(0)["step_losses"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    widths = sorted(set(loaders2["meta"]["bucket_widths"].values()))
    keys = list(tr.graphs.graphs)
    ok = (len(widths) == 2 and sorted({k[0] for k in keys}) == widths
          and all(k[2] is True for k in keys)
          and len(losses) == tr._steps_per_epoch()
          and all(math.isfinite(x) for x in losses))
    emit(phase="multisession_mixed_buckets", dtype=dtype_name(dtype),
         layernorm=mode, n_buckets=2, widths=widths,
         variants_captured=[str(k) for k in keys],
         capture_s=list(tr.graphs.capture_s.values()), steps=len(losses),
         steps_per_epoch=tr._steps_per_epoch(), epoch_wall_s=wall, ok=ok)
    del tr
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("multisession_mixed_buckets: widths, keys or "
                             "losses off (see its line)")


def multisession_mixed_phases(root: Path, sessions: dict, loaders: dict,
                              default: str) -> dict:
    """Phase 10 over ``sessions`` (100 trials each) and their one-bucket
    ``loaders``; returns the profiled mixed groups' launch counts by
    dtype, the wrappers' counts over the mixed epochs and the
    session-rows kernel's row."""
    t0 = time.perf_counter()
    rows = session_rows_check()
    f32, bf16 = torch.float32, torch.bfloat16
    reset_counts()
    counts = {"f32": multisession_mixed_phase(root, loaders, f32, default),
              "bf16": multisession_mixed_phase(root, loaders, bf16, "full")}
    wrapper_counts = read_counts()
    multisession_mixed_forward(loaders, default)
    multisession_mixed_buckets(root, sessions, bf16, "full")
    emit(phase="slice_13_mixed_wall", total_s=time.perf_counter() - t0,
         wrapper_counts=wrapper_counts)
    return dict(counts=counts, rows=rows, wrapper_counts=wrapper_counts)


# ---------------------------------------------------------------------------
# phase 11: a checkpoint the PyTorch reference trained (slice 13)
# ---------------------------------------------------------------------------

def reference_ckpt_phase(root: Path) -> dict:
    """The port's full-width model (N=668 + 2 behavior, f32, random weights
    from a seed) saved in the reference's names in its file forms: a plain
    ``state_dict``, ``{'state_dict': sd}`` and the whole-module pickle
    ``{'model': <nn.Module>}`` (the port's model itself: its names are the
    reference's). Each loads through ``load_reference_checkpoint`` onto the
    card, and its eval forward (16 test trials, the last 30 bins held out)
    equals the original model's bit for bit. Then ``eval_multi_modal
    --reference_ckpt`` runs all six modes on the plain file (finite
    results; K1 and K3 launched), and ``convert_checkpoint to-port`` then
    ``to-reference`` gives back every tensor bit for bit. Returns the eval
    script's launch counts."""
    import copy
    import warnings

    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import (
        load_reference_checkpoint)
    from multi_modal_foundation_model_tpu_torch.models import (
        ModalityInput, MultiModal)
    from multi_modal_foundation_model_tpu_torch.scripts import (
        convert_checkpoint, eval_multi_modal)

    t_phase = time.perf_counter()
    base = root / "chip_smoke_reference_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    model = MultiModal(_cfg(torch.float32),
                       generator=torch.Generator().manual_seed(SEED + 7))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    forms = {"plain": sd, "state_dict": {"state_dict": sd},
             "pickle": {"model": copy.deepcopy(model).cpu(), "epoch": 0}}
    for name, obj in forms.items():
        torch.save(obj, base / f"{name}.pt")

    N, T = GEOMETRY["n_channels"]["ap"], GEOMETRY["max_F"]
    test = synthetic_splits(seed=SEED, n_trials=N_TRIALS, n_neurons=N,
                            n_timesteps=T).test
    batch = next(iter(make_loader(test, batch_size=TRAIN_B, shuffle=False,
                                  max_time_length=T, max_space_length=N)))

    def forward(m):
        def t(k):
            return torch.as_tensor(batch[k], device="cuda")
        spikes, beh = t("spikes_data"), t("target")
        ap_eval = torch.zeros_like(spikes, dtype=torch.int32)
        ap_eval[:, 70:] = 1
        inputs = {k: ModalityInput(inputs=x, targets=x,
                                   attn_mask=t("time_attn_mask"),
                                   timestamps=t("spikes_timestamps"),
                                   eval_mask=ev)
                  for k, x, ev in (("ap", spikes, ap_eval),
                                   ("behavior", beh, torch.zeros_like(
                                       beh, dtype=torch.int32)))}
        with torch.no_grad():
            out = m(inputs)
        return out.mod_preds["ap"], out.mod_preds["behavior"]

    want = forward(model)
    channels = dict(GEOMETRY["n_channels"])
    bit_equal, warned = {}, {}
    for name in forms:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loaded = load_reference_checkpoint(str(base / f"{name}.pt"),
                                               channels, max_F=T)
        warned[name] = any("weights_only=False" in str(w.message)
                           for w in caught)
        got = forward(loaded)
        bit_equal[name] = all(torch.equal(a, b) for a, b in zip(got, want))
        del loaded

    reset_counts()
    t0 = time.perf_counter()
    results = eval_multi_modal.main(
        ["--synthetic", "--device", "cuda", "--base_path", str(base),
         "--reference_ckpt", str(base / "plain.pt"), "--use_MtM",
         "--co_smooth", "--forward_pred", "--inter_region",
         "--intra_region"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = read_counts()
    modes = ("per_neuron", "forward_pred", "inter_region", "intra_region",
             "modal_spike", "modal_behavior")
    files = all((base / "reference_ckpt_eval" / "eval" / m / "bps.npy")
                .exists() for m in modes)
    finite = _finite_tree(results)

    port_dir = base / "converted"
    convert_checkpoint.main(["to-port", str(base / "plain.pt"),
                             str(port_dir), "--n-neurons", str(N),
                             "--max-F", str(T)])
    convert_checkpoint.main(["to-reference", str(port_dir / "model_best.pt"),
                             str(base / "back.pt")])
    back = torch.load(base / "back.pt", weights_only=True)
    round_trip = set(back) == set(sd) and all(
        torch.equal(back[k], sd[k]) for k in sd)
    ok = (all(bit_equal.values()) and warned == {
        "plain": False, "state_dict": False, "pickle": True}
        and files and finite and counts["k1"] > 0 and counts["k3"] > 0
        and round_trip)
    emit(phase="reference_ckpt", dtype="float32", n_channels=channels,
         forms=list(forms), forward_bit_equal=bit_equal,
         full_unpickling_warned=warned, eval_script_s=eval_s,
         eval_script_launches=counts, eval_files_present=files,
         eval_results_finite=finite, results=results,
         converter_round_trip_bit_equal=round_trip, n_tensors=len(sd),
         wall_s=time.perf_counter() - t_phase,
         device=torch.cuda.get_device_name(0), ok=ok)
    del model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("reference_ckpt: forward, eval script or "
                             "converter off (see its line)")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the real-data path (raw session -> ETL -> hub rows -> trainers)
# ---------------------------------------------------------------------------

REAL_BINSIZE, REAL_WINDOW = 0.02, (-0.5, 1.5)      # 100 bins a trial
REAL_REGIONS = ("CA1", "DG", "LP", "PO", "VISa", "VISam", "MRN", "APN")
# two stand-in sessions: 708 clusters of which the region selection keeps
# 668 (the reference width), and a narrower one
REAL_SESSIONS = {
    "etl-0": dict(seed=SEED, n_clusters=708, n_kept=668, n_trials=240),
    "etl-1": dict(seed=SEED + 1, n_clusters=560, n_kept=520, n_trials=240)}
REAL_ORG = "neurofm123"                 # load_ibl_session's default org
HUB_PACKAGES = ("pandas", "datasets", "huggingface_hub", "h5py", "one",
                "brainbox", "iblatlas")


def raw_session(seed: int, n_clusters: int, n_kept: int, n_trials: int,
                rate_hz: float = 4.0, nan_trials: int = 3) -> dict:
    """A raw IBL-like session from ``seed`` (numpy, float64 times), in the
    shapes ``prepare_data`` hands the binning: Poisson spike trains of
    ``n_clusters`` clusters (rates log-normal about ``rate_hz``, time
    sorted), of which ``n_clusters - n_kept`` sit in "root", outside
    ``REAL_REGIONS``; trials 2.5-3.5 s apart with ``stimOn_times`` and the
    trial table's scalars; ``wheel-speed`` at 1 kHz and
    ``whisker-motion-energy`` at 60 Hz (NaN for 0.3 s after stimulus onset
    in ``nan_trials`` trials); cluster depths and uuids."""
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(2.5, 3.5, n_trials)
    stim_on = 2.0 + np.cumsum(gaps) - gaps[0]
    t_end = float(stim_on[-1] + 4.0)
    regions = np.concatenate([np.full(n_clusters - n_kept, "root"),
                              rng.choice(REAL_REGIONS, n_kept)])
    rng.shuffle(regions)
    rates = rng.lognormal(np.log(rate_hz), 0.8, n_clusters)
    counts = rng.poisson(rates * t_end)
    clusters = np.repeat(np.arange(n_clusters), counts)
    times = rng.uniform(0.0, t_end, int(counts.sum()))
    order = np.argsort(times, kind="stable")
    trials = {
        "stimOn_times": stim_on,
        "choice": rng.choice([-1.0, 1.0], n_trials),
        "probabilityLeft": rng.choice([0.2, 0.5, 0.8], n_trials),
        "rewardVolume": rng.choice([0.0, 1.5], n_trials, p=[0.3, 0.7]),
        "contrastLeft": np.where(rng.random(n_trials) < 0.5, 0.25, np.nan),
        "contrastRight": np.where(rng.random(n_trials) < 0.5, 1.0, np.nan)}
    wheel_t = np.arange(0.0, t_end, 1e-3)
    wheel = np.abs(np.sin(wheel_t * rng.uniform(0.5, 2.0))
                   + 0.1 * rng.standard_normal(len(wheel_t)))
    me_t = np.arange(0.0, t_end, 1.0 / 60.0)
    me = rng.gamma(2.0, 1.0, len(me_t))
    for k in rng.choice(n_trials, nan_trials, replace=False):
        me[(me_t >= stim_on[k]) & (me_t < stim_on[k] + 0.3)] = np.nan
    return dict(spike_times=times[order], spike_clusters=clusters[order],
                cluster_regions=regions,
                cluster_depths=rng.uniform(0.0, 3840.0, n_clusters),
                cluster_uuids=np.array([f"{seed:02d}-{i:05d}"
                                        for i in range(n_clusters)]),
                trials=trials,
                signals={"wheel-speed": (wheel_t, wheel),
                         "whisker-motion-energy": (me_t, me)})


def etl_rows(raw: dict, eid: str, etl, sparse,
             window=REAL_WINDOW) -> tuple:
    """``raw`` through the ETL (``etl``/``sparse``: either package's
    modules) with ``window`` about stimulus onset in ``REAL_BINSIZE`` bins:
    ``trial_intervals``, the region selection,
    ``bin_spiking_data``, ``bin_behaviors`` (a NaN sample fails a trial),
    ``align_spike_behavior``, then the hub's splits (a permutation from
    ``SEED``: 70 / 10 / 20 %) encoded by ``dense_to_sparse_rows``
    into the hub's columns, as the dict of lists ``ds[split][:]`` returns.
    Returns (rows by split, host seconds by stage, counts)."""
    sec = {}
    t0 = time.perf_counter()
    intervals = etl.trial_intervals(raw["trials"]["stimOn_times"], window)
    keep = etl.select_brain_regions(raw["cluster_regions"],
                                    list(REAL_REGIONS))
    spikes, clu_ids = etl.bin_spiking_data(
        keep, raw["spike_times"], raw["spike_clusters"], intervals=intervals,
        binsize=REAL_BINSIZE)
    sec["binning_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    behave, _ = etl.bin_behaviors(raw["signals"], trials_df=raw["trials"],
                                  time_window=window, binsize=REAL_BINSIZE,
                                  allow_nans=False)
    sec["behaviors_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scalars, traces = ("choice", "reward", "block"), tuple(raw["signals"])
    spikes, behs = etl.align_spike_behavior(spikes, behave,
                                            beh_names=scalars + traces)
    sec["align_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    K = len(spikes)
    perm = np.random.default_rng(SEED).permutation(K)
    meta = {"cluster_regions": raw["cluster_regions"][clu_ids].tolist(),
            "cluster_depths": raw["cluster_depths"][clu_ids].tolist(),
            "cluster_uuids": raw["cluster_uuids"][clu_ids].tolist()}
    rows = {}
    for split, idx in zip(("train", "val", "test"),
                          np.split(perm, [int(0.7 * K), int(0.8 * K)])):
        idx = np.sort(idx)
        data, indices, indptr, shape = sparse.dense_to_sparse_rows(
            spikes[idx])
        n = len(idx)
        rows[split] = {
            "spikes_sparse_data": data, "spikes_sparse_indices": indices,
            "spikes_sparse_indptr": indptr,
            "spikes_sparse_shape": [list(s) for s in shape],
            **{k: behs[k][idx].tolist() for k in traces},
            **{k: behs[k][idx, 0].tolist() for k in scalars},
            "binsize": [REAL_BINSIZE] * n,
            "interval_len": [window[1] - window[0]] * n,
            "eid": [eid] * n, **{k: [v] * n for k, v in meta.items()}}
    sec["csr_encode_s"] = time.perf_counter() - t0
    counts = dict(trials=len(intervals), trials_aligned=K,
                  clusters=len(raw["cluster_regions"]),
                  clusters_kept=len(clu_ids),
                  spikes=len(raw["spike_times"]),
                  spikes_binned=int(spikes.sum()))
    return rows, sec, counts


@contextlib.contextmanager
def hub_stand_in(rows_by_name: dict):
    """For the body, ``datasets`` in ``sys.modules`` is a stand-in that
    serves rows built in this process and downloads nothing:
    ``load_dataset(name)`` returns ``{split: view}`` for a name in
    ``rows_by_name`` (``"<org>/<eid>_aligned"``), where ``view[:]`` is that
    split's dict of lists; any other name raises ``FileNotFoundError``.
    Yields the stand-in, whose ``loaded`` lists the names asked for; the
    package (or its absence) is put back after the body."""
    import types

    mod = types.ModuleType("datasets")
    mod.loaded = []

    class _Split:
        def __init__(self, rows):
            self._rows = rows

        def __getitem__(self, key):
            if key != slice(None):
                raise TypeError("the stand-in serves whole splits only")
            return self._rows

    def load_dataset(path, cache_dir=None, **_):
        mod.loaded.append(path)
        if path not in rows_by_name:
            raise FileNotFoundError(f"{path}: not in the stand-in")
        return {s: _Split(r) for s, r in rows_by_name[path].items()}

    mod.load_dataset = load_dataset
    had, old = "datasets" in sys.modules, sys.modules.get("datasets")
    sys.modules["datasets"] = mod
    try:
        yield mod
    finally:
        if had:
            sys.modules["datasets"] = old
        else:
            sys.modules.pop("datasets", None)


def _decode_check(rows: dict) -> dict:
    """``decode_spikes_on_device`` on the card over the first 16 trials of
    ``rows`` against ``sparse_rows_to_dense``: bit for bit; its device time
    (every kernel of the call, ``traced``) beside the bound of its bytes
    (the COO inputs read once, the dense f32 output written once)."""
    from multi_modal_foundation_model_tpu_torch.data import (
        decode_spikes_on_device, flatten_csr_rows, sparse_rows_to_dense)

    cols = [rows[k][:TRAIN_B] for k in (
        "spikes_sparse_data", "spikes_sparse_indices",
        "spikes_sparse_indptr", "spikes_sparse_shape")]
    T, N = (int(x) for x in cols[3][0])
    nnz = max(len(d) for d in cols[0])
    coo = [torch.as_tensor(a, device="cuda")
           for a in flatten_csr_rows(*cols, max_nnz=nnz)]
    got = decode_spikes_on_device(*coo, T=T, N=N)
    torch.cuda.synchronize()
    want = sparse_rows_to_dense(*cols).astype(np.float32)
    bit_equal = bool(np.array_equal(got.cpu().numpy(), want))
    ms = device_ms(lambda: decode_spikes_on_device(*coo, T=T, N=N))
    bytes_moved = sum(t.numel() * t.element_size() for t in coo) \
        + got.numel() * got.element_size()
    return dict(shape=[TRAIN_B, T, N], max_nnz=nnz, bit_equal=bit_equal,
                device_ms=ms, bytes=bytes_moved, **_bound(bytes_moved, 0.0))


def _real_vs_synthetic_time(root: Path, real_loader) -> dict:
    """The bf16 B=16 graph step (``"full"``, MtM ``temporal`` alone) on the
    ETL'd session against the same step on the synthetic session of the
    same width, one resident trainer each, a segment a dispatch of K = 10
    replays over the loader's first batch (``dispatch_time``'s group),
    interleaved real, synthetic, synthetic, real (4 passes); medians and
    spreads of ms a step."""
    cfg = _cfg(torch.bfloat16)
    one = dict(mask_mode=("temporal",), mixed_training=False,
               device_resident_data=True, steps_per_dispatch=DISPATCH_K)
    segs, fns = {"real": [], "synthetic": []}, {}
    with ln_mode("full"):
        for name, loader in (("real", real_loader),
                             ("synthetic", _step_loaders(TRAIN_B))):
            tr = _trainer(cfg, loader, None, 1, root / f"time_{name}",
                          tcfg_over=one)
            data = tr._device_data(loader)
            idx, valid, _ = next(loader.iter_index_batches())
            group = [(idx, valid, 0)] * DISPATCH_K
            fns[name] = (lambda tr=tr, data=data, group=group:
                         tr._dispatch(data, group, None))
            fns[name]()
            fns[name]()
        for p in range(4):
            for name in (("real", "synthetic") if p % 2 == 0
                         else ("synthetic", "real")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
                segs[name].append((time.perf_counter() - t0) * 1e3
                                  / DISPATCH_K)
    del fns
    torch.cuda.empty_cache()
    return dict(segments_ms=segs,
                ms_per_step={k: float(np.median(v)) for k, v in segs.items()},
                spread_ms={k: max(v) - min(v) for k, v in segs.items()})


def real_data_phase(root: Path) -> dict:
    """The real-data path on stand-in sessions (no IBL session is in the
    repository and nothing is downloaded): ``REAL_SESSIONS`` built from the
    seed (``raw_session``) go through the port's numpy ETL (``etl_rows``),
    ``_rows_to_session`` and ``load_ibl_dataset(split_method=
    "predefined")`` through its ``_load_session`` / ``_list_datasets``
    seams (the session count asserted: a session that fails to load is
    skipped, not raised). Then, bf16 under ``"full"``, the counters set to
    0 before and read after: ``MultiModalTrainer`` at full width (N=668) on
    the resident graph path (K = 10) for 2 epochs, epoch 1 run again after
    a restore under a profile (K1 30, K2 15, K3 62, K4 32 a step and
    Philox, as on the synthetic step), ``co_smoothing_eval`` in two modes;
    ``MultiSessionTrainer`` for one graph epoch over both sessions; the
    NEMO filter on a session with ``cluster_uuids`` set (the space axis
    narrowed) and refused on a hub session (JAX's ``_rows_to_session``
    drops the uuids); ``decode_spikes_on_device`` bit for bit against the
    host decode; the ETL'd graph step against the synthetic one;
    ``train_multi_modal --eid`` and ``eval_multi_modal --eid`` with no
    ``--synthetic`` through ``hub_stand_in``. Host seconds of each ETL
    stage are printed. Returns the single-session path's counter launches
    and its profiled kernel counts."""
    import importlib.util
    import pickle

    from multi_modal_foundation_model_tpu_torch.data import (
        SessionSplits, etl, load_ibl_dataset, make_loader, sparse)
    from multi_modal_foundation_model_tpu_torch.data.session import (
        _rows_to_session)
    from multi_modal_foundation_model_tpu_torch.eval import (
        co_smoothing_eval)
    from multi_modal_foundation_model_tpu_torch.scripts import (
        eval_multi_modal, train_multi_modal)
    from multi_modal_foundation_model_tpu_torch.train import (
        build_multisession_loaders)

    t_phase = time.perf_counter()
    base = root / "chip_smoke_real_data"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    T, N = GEOMETRY["max_F"], GEOMETRY["n_channels"]["ap"]
    have = {p: importlib.util.find_spec(p) is not None for p in HUB_PACKAGES}

    # raw sessions through the ETL into the hub's rows
    rows_by_name, sessions = {}, {}
    for eid, spec in REAL_SESSIONS.items():
        t0 = time.perf_counter()
        raw = raw_session(**spec)
        raw_s = time.perf_counter() - t0
        rows, sec, counts = etl_rows(raw, eid, etl, sparse)
        t0 = time.perf_counter()
        sessions[eid] = SessionSplits(**{
            s: _rows_to_session(r, eid) for s, r in rows.items()})
        sec["rows_to_session_s"] = time.perf_counter() - t0
        rows_by_name[f"{REAL_ORG}/{eid}_aligned"] = rows
        emit(phase="real_data_etl", eid=eid, raw_session_s=raw_s,
             host_s_by_stage=sec, **counts,
             splits={s: getattr(sessions[eid], s).n_trials
                     for s in ("train", "val", "test")},
             n_neurons=sessions[eid].n_neurons)
        del raw

    # multi-session assembly through the seams, then the loaders
    t0 = time.perf_counter()
    listed = list(rows_by_name) + [f"{REAL_ORG}/etl-0_unaligned"]
    train, _, _, meta = load_ibl_dataset(
        None, user_or_org_name=REAL_ORG, num_sessions=len(REAL_SESSIONS),
        split_method="predefined", batch_size=TRAIN_B,
        _load_session=sessions.__getitem__, _list_datasets=lambda _: listed)
    s0 = train["etl-0"]
    kw = dict(batch_size=TRAIN_B, max_time_length=T, max_space_length=N)
    train_l = make_loader(s0.train, seed=SEED, **kw)
    val_l = make_loader(s0.val, shuffle=False, **kw)
    test_l = make_loader(s0.test, shuffle=False,
                         **dict(kw, batch_size=s0.test.n_trials))
    loader_s = time.perf_counter() - t0
    assembled = (meta["num_sessions"] == len(REAL_SESSIONS)
                 and meta["eids"] == list(REAL_SESSIONS)
                 and s0.n_neurons == N
                 and all(s.train.n_trials % TRAIN_B == 0
                         for s in train.values()))

    # single session, full width, on the graph path
    cfg = _cfg(torch.bfloat16)
    want = dict(k1=2 * K1_ATTN_PER_FORWARD, k2=K1_ATTN_PER_FORWARD,
                k3=K3_PER_STEP, k4=K4_PER_STEP)
    with ln_mode("full"):
        reset_counts()
        t0 = time.perf_counter()
        tr = _trainer(cfg, train_l, val_l, 2, base / "single",
                      tcfg_over=dict(device_resident_data=True,
                                     steps_per_dispatch=DISPATCH_K))
        losses = tr.train_epoch(0)["step_losses"]
        tr.save_model("last", epoch=0)
        losses += tr.train_epoch(1)["step_losses"]
        # epoch 1 again after a restore: every variant it draws was
        # captured, so each of its steps is a replay (``dispatch_phase``)
        prof_counts, again = None, []
        for _ in range(3):
            tr.restore("last")
            try:
                with traced() as prof:
                    again = tr.train_epoch(1)["step_losses"]
            except TraceLost:
                continue
            prof_counts = kernel_counts(prof)
            if _launches_ok(prof_counts, len(again), want):
                break
        ev = tr.eval_epoch()
        evals = {mode: co_smoothing_eval(
            tr.model, test_l, mode, use_mtm=True, chunk=CHUNK,
            n_time_steps=T, held_out_list=held,
            save_path=str(base / "eval" / mode))
            for mode, held in (("modal_spike", list(range(T))),
                               ("forward_pred",
                                list(range(7 * T // 10, T))))}
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        counts = read_counts()
    del tr
    torch.cuda.empty_cache()
    single_ok = (all(math.isfinite(x) for x in losses + again)
                 and len(losses) == 2 * len(train_l) and _finite_tree(evals)
                 and math.isfinite(ev["eval_loss"])
                 and prof_counts is not None
                 and _launches_ok(prof_counts, len(again), want)
                 and all(counts[k] > 0
                         for k in ("k1", "k2", "k3", "k4", "philox")))

    # multi-session graph steps over both ETL'd sessions
    with ln_mode("full"):
        t0 = time.perf_counter()
        ms_train, ms_val, _, ms_meta = build_multisession_loaders(
            train, batch_size=TRAIN_B, max_time_length=T,
            pad_multiple=MS_PAD, seed=SEED)
        ms = ms_trainer(dict(train=ms_train, val=ms_val, meta=ms_meta),
                        torch.bfloat16, base / "multi")
        ms_losses = ms.train_epoch(0)["step_losses"]
        ms_eval = ms.eval_epoch()["eval_per_session"]
        torch.cuda.synchronize()
        ms_s = time.perf_counter() - t0
        ms_replays = ms.graphs.replays
    del ms
    torch.cuda.empty_cache()
    ms_ok = (all(math.isfinite(x) for x in ms_losses)
             and len(ms_losses) == sum(len(v) for v in ms_train.values())
             and ms_replays > 0 and _finite_tree(ms_eval)
             and sorted(ms_eval) == sorted(REAL_SESSIONS))

    # NEMO: a pickle of the phase's own, covering 3 units in 4
    rng = np.random.default_rng(SEED)
    uuids = np.asarray(rows_by_name[f"{REAL_ORG}/etl-0_aligned"]["train"]
                       ["cluster_uuids"][0])
    kept = np.flatnonzero(np.arange(len(uuids)) % 4 != 0)
    table = np.concatenate([uuids[kept], [f"absent-{i}" for i in range(16)]])
    nemo_path = base / "MtM_unit_embed.pkl"
    with open(nemo_path, "wb") as f:
        pickle.dump({"uuids": table,
                     "wvf_rep": rng.standard_normal((len(table), 32)),
                     "acg_rep": rng.standard_normal((len(table), 16))}, f)
    with_uuids = dataclasses.replace(s0.train, cluster_uuids=uuids)
    nemo_l = make_loader(with_uuids, use_nemo=True, nemo_path=str(nemo_path),
                         shuffle=False, **kw)
    nemo_ok = (nemo_l.arrays["spikes_data"].shape[-1] == len(kept)
               and nemo_l.arrays["nemo_rep"].shape == (len(kept), 48)
               and np.array_equal(nemo_l.arrays["spikes_data"],
                                  s0.train.spikes[:, :, kept]))
    try:
        make_loader(s0.train, use_nemo=True, nemo_path=str(nemo_path), **kw)
        hub_refused = False
    except AssertionError:
        hub_refused = True

    decode = _decode_check(rows_by_name[f"{REAL_ORG}/etl-0_aligned"]
                           ["train"])
    timing = _real_vs_synthetic_time(base, train_l)

    # the scripts' real-data branch, the download replaced
    scripts = {}
    argv = ["--eid", "etl-0", "--device", "cuda", "--overwrite",
            "--base_path", str(base / "scripts"), "--use_MtM",
            "--mixed_training"]
    with hub_stand_in(rows_by_name) as hub:
        emit(phase="real_data_hub_stand_in", replaces="datasets",
             serves=sorted(rows_by_name),
             real_datasets_package_present=have["datasets"])
        for name, main, extra, need in (
                ("train_multi_modal", train_multi_modal.main,
                 NO_EPOCH_PLOTS + ["--num_epochs", "1", "--device_resident",
                                   "--set", "training.steps_per_dispatch=10"],
                 ("k1", "k2", "k3", "k4", "philox")),
                ("eval_multi_modal", eval_multi_modal.main, [],
                 ("k1", "k3"))):
            reset_counts()
            t0 = time.perf_counter()
            out = main(argv + extra)
            torch.cuda.synchronize()
            c = read_counts()
            scripts[name] = dict(wall_s=time.perf_counter() - t0,
                                 launches=c, finite=_finite_tree(out),
                                 launched=all(c[k] > 0 for k in need))
        loaded = list(hub.loaded)
    scripts_ok = (all(s["finite"] and s["launched"]
                      for s in scripts.values())
                  and loaded == [f"{REAL_ORG}/etl-0_aligned"] * 2)

    checks = dict(assembled=assembled, single_session=single_ok,
                  multisession=ms_ok, nemo=nemo_ok,
                  nemo_refused_on_hub_session=hub_refused,
                  decode_bit_equal=decode["bit_equal"], scripts=scripts_ok)
    ok = all(checks.values())
    emit(phase="real_data", checks=checks, sessions=meta["eids"],
         num_neurons=meta["num_neurons"], num_sessions=meta["num_sessions"],
         assembled=assembled, loader_s=loader_s, host_packages=have,
         dtype="bfloat16", layernorm="full", batch=TRAIN_B,
         steps_per_dispatch=DISPATCH_K, single_losses=losses,
         single_s=single_s, launches_counters=counts,
         launches_profiled_epoch=prof_counts,
         launches_per_step={k: v / max(len(again), 1)
                            for k, v in (prof_counts or {}).items()},
         launches_per_step_expected=want, eval_loss=ev["eval_loss"],
         evals=evals, multisession_losses=ms_losses,
         multisession_n_max=ms_meta["n_max"], multisession_s=ms_s,
         multisession_replays=ms_replays, multisession_eval=ms_eval,
         nemo_units=len(kept), decode=decode, step_time_real_vs_synthetic=timing,
         scripts=scripts, hub_loaded=loaded,
         wall_s=time.perf_counter() - t_phase,
         device=torch.cuda.get_device_name(0), ok=ok)
    if not ok:
        raise AssertionError("real_data: assembly, training, NEMO, decode "
                             "or scripts off (see its line)")
    return dict(counters=counts, graph=prof_counts)


# ---------------------------------------------------------------------------
# phase 13: data and tensor parallelism, as ranks that share the card
# ---------------------------------------------------------------------------

# (dp, tp) layouts of the phase, each run as dp * tp processes over gloo on
# the one card (NCCL refuses two ranks on one GPU: ``nccl_checks``); the
# layouts of a group are started together, four ranks at a time
PAR_LAYOUTS = (((2, 1), (1, 2)), ((2, 2),))
PAR_STEPS, PAR_TIMED = 3, 3
# the two cases: dropout 0 with the deterministic menu, and the training
# step's dropout with the random MtM menu; mixed objectives in both
PAR_CASES = {
    "det": dict(dropout=0.0, embed_dropout=0.0,
                menu=("co-smooth", "forward-pred")),
    "drop": dict(dropout=DROPOUT, embed_dropout=0.2, menu=MTM_MENU),
}
PAR_MASK = dict(channels=tuple(range(0, 668, 7)),
                timesteps=tuple(range(70, 100)))
PAR_SPEC = dict(geometry=GEOMETRY, device="cuda", n_trials=N_TRIALS,
                batch=TRAIN_B, layernorm="full", backend="gloo")
_PAR_SPLITS: dict = {}


def par_trainer(spec: dict, dtype, case: str, mesh, log_dir: Path):
    """The phase's full-width trainer of ``case`` under ``mesh`` (None: one
    process), weights from ``SEED``, on the spec's device."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModal, MultiModalConfig)
    from multi_modal_foundation_model_tpu_torch.ops.masking import MaskParams
    from multi_modal_foundation_model_tpu_torch.train import (
        MetricLogger, MultiModalTrainer, OptimizerConfig, TrainerConfig)

    c = PAR_CASES[case]
    g = spec["geometry"]
    N, T = g["n_channels"]["ap"], g["max_F"]
    key = (spec["n_trials"], N, T)
    if key not in _PAR_SPLITS:          # every trainer of a rank: one draw
        _PAR_SPLITS[key] = synthetic_splits(seed=SEED, n_trials=key[0],
                                            n_neurons=N, n_timesteps=T)
    splits = _PAR_SPLITS[key]
    mask = MaskParams(channels=tuple(i for i in PAR_MASK["channels"]
                                     if i < N),
                      timesteps=tuple(i for i in PAR_MASK["timesteps"]
                                      if i < T) or (T - 1,))
    cfg = MultiModalConfig(**g, compute_dtype=dtype_name(dtype),
                           dropout=c["dropout"],
                           embed_dropout=c["embed_dropout"], mask_params=mask)
    kw = dict(batch_size=spec["batch"], max_time_length=T,
              max_space_length=N)
    model = MultiModal(cfg, device=spec["device"],
                       generator=torch.Generator().manual_seed(SEED))
    tcfg = TrainerConfig(num_epochs=2, mask_type="input",
                         mask_mode=c["menu"], mixed_training=True, seed=SEED,
                         log_dir=str(log_dir), eval_every=10 ** 9)
    return MultiModalTrainer(
        model, make_loader(splits.train, seed=SEED, **kw),
        make_loader(splits.val, shuffle=False, **kw), OptimizerConfig(),
        tcfg, mesh=mesh, logger=MetricLogger(str(log_dir), stdout=False))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _CollectiveClock:
    """Host seconds inside ``torch.distributed``'s ``all_reduce``,
    ``broadcast`` and ``all_gather`` (the device synchronised before each,
    so earlier work is not counted), and their count, while on."""

    NAMES = ("all_reduce", "broadcast", "all_gather")

    def __init__(self, device):
        import torch.distributed as dist

        self.dist, self.device, self.s, self.n = dist, device, 0.0, 0
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

    def __enter__(self):
        for name, fn in self.saved.items():
            def timed(*a, _fn=fn, **k):
                _sync(self.device)
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                _sync(self.device)
                self.s += time.perf_counter() - t0
                self.n += 1
                return out
            setattr(self.dist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _equal_over(tensors, group) -> bool:
    """Whether each of ``tensors`` is bit-equal on every rank of
    ``group``: one ``all_gather`` of them packed."""
    from multi_modal_foundation_model_tpu_torch.parallel.mesh import (
        all_gather_cat)

    if group is None or not tensors:
        return True
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    parts = all_gather_cat(flat[None], group)
    return bool((parts == parts[:1]).all())


def _gather_to_cpu(named, dims, mesh) -> dict:
    """``{name: tensor}`` in the single-device layout, copied to the CPU:
    the shards (``dims[name]`` not None) gathered over the model group in
    one ``all_gather`` of them packed."""
    from multi_modal_foundation_model_tpu_torch.parallel.mesh import (
        all_gather_cat)

    out = {n: t.detach().to("cpu", copy=True) for n, t in named.items()
           if mesh is None or dims.get(n) is None}
    sharded = [n for n in named if n not in out]
    if sharded:
        flat = torch.cat([named[n].detach().reshape(-1) for n in sharded])
        parts = all_gather_cat(flat[None], mesh.model_group).cpu()
        at = 0
        for n in sharded:
            t = named[n]
            cut = parts[:, at:at + t.numel()].reshape(-1, *t.shape)
            out[n] = torch.cat(list(cut), dim=dims[n])
            at += t.numel()
    return out


def _wait_for(path: Path, timeout: float = 600.0) -> None:
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no {path.name} after {timeout} s")
        time.sleep(0.05)


@contextlib.contextmanager
def _timing_turn(spec: dict, mesh):
    """Layouts run side by side (``spec["side_by_side"]``, their names in
    turn order) time their steps one at a time, and only once every one of
    them is done with its checks: no other rank runs on the card while a
    layout is timed."""
    names = spec.get("side_by_side")
    if not names:
        yield
        return
    turns, me = Path(spec["turn_dir"]), spec["name"]
    torch.distributed.barrier()
    if mesh.rank == 0:
        (turns / f"checked_{me}").touch()
    for n in names:
        _wait_for(turns / f"checked_{n}")
    for n in names[:names.index(me)]:
        _wait_for(turns / f"timed_{n}")
    yield
    _sync(spec["device"])
    torch.distributed.barrier()
    if mesh.rank == 0:
        (turns / f"timed_{me}").touch()


def par_run(spec: dict, mesh, out_dir: Path) -> dict:
    """One rank's part of the phase (every rank runs it; ``mesh`` None is
    the single-process yardstick), per dtype and case: the step-0 loss and
    gradients (summed over the data group, the shards gathered), whether
    the replicated gradients are bit-equal over the model group, the
    launches of the step's forward and backward; for ``drop`` three
    optimizer steps (their launches, the parameters after them gathered,
    bit-equal over the data group). The f32 ``drop`` run saves a ``last``
    checkpoint (gathered). Then, for each ``drop`` trainer, the eager step
    time over ``PAR_TIMED`` steps and, in another pass, the collectives'
    time a step (``_timing_turn``). ``seconds`` splits the rank's time."""
    from multi_modal_foundation_model_tpu_torch.parallel import (
        full_state_dict)
    from multi_modal_foundation_model_tpu_torch.parallel.mesh import (
        all_reduce_many_)

    dev = spec["device"]
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group
    res, to_time = {}, []
    for dtype in DTYPES:
        for case in PAR_CASES:
            key = f"{dtype_name(dtype)}_{case}"
            log_dir = out_dir / key
            secs = {}
            t0 = time.perf_counter()
            with ln_mode(spec["layernorm"]):
                tr = par_trainer(spec, dtype, case, mesh, log_dir)
                tr.train_dataloader.set_epoch(0)
                tr._reseed_host_rng(0)
                steps = [(tr._device_batch(b), tr._sample_modes())
                         for b, _ in zip(tr.train_dataloader,
                                         range(PAR_STEPS + PAR_TIMED))]
                params = dict(tr.model.named_parameters())
                dims = {n: getattr(p, "tp_dim", None)
                        for n, p in params.items()}
                batch, (mode, scheme) = steps[0]
                _sync(dev)
                secs["build"] = time.perf_counter() - t0
                reset_counts()
                out = tr.step_loss(batch, mode, scheme, step=0)
                grads = torch.autograd.grad(out.loss, list(params.values()),
                                            allow_unused=True)
                _sync(dev)
                fwd_bwd = read_counts()
                secs["fwd_bwd"] = time.perf_counter() - t0 - secs["build"]
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params.values(), grads)]
                if mesh is not None:
                    all_reduce_many_(grads, data_group)
                r = dict(loss0=float(out.loss.detach()), fwd_bwd=fwd_bwd,
                         replicated_equal=_equal_over(
                             [g for n, g in zip(params, grads)
                              if dims[n] is None], model_group),
                         grads=_gather_to_cpu(dict(zip(params, grads)),
                                              dims, mesh))
                del out, grads
                if case == "drop":
                    reset_counts()
                    r["losses"] = [float(tr.train_step(b, m, s))
                                   for b, (m, s) in steps[:PAR_STEPS]]
                    _sync(dev)
                    r["step_launches"] = read_counts()
                    r["data_equal"] = _equal_over(list(params.values()),
                                                  data_group)
                    # copies: the timed steps below move the live ones
                    r["params"] = {k: v.to("cpu", copy=True)
                                   for k, v in full_state_dict(
                                       tr.model, mesh).items()}
                    if dtype == torch.float32:
                        tr.save_model("last", epoch=0)
                    to_time.append((key, [
                        lambda tr=tr, b=b, m=m, s=s: tr.train_step(b, m, s)
                        for b, (m, s) in steps[PAR_STEPS:]]))
                _sync(dev)
                secs["checks_and_steps"] = (time.perf_counter() - t0
                                            - secs["build"]
                                            - secs["fwd_bwd"])
                r["seconds"] = secs
                res[key] = r
                del tr, steps, params
                if torch.device(dev).type == "cuda":
                    torch.cuda.empty_cache()
    par_ms_run(spec, mesh, out_dir, res, to_time)
    with _timing_turn(spec, mesh):
        for key, timed in to_time:
            r = res[key]
            with ln_mode(spec["layernorm"]):
                _sync(dev)
                t0 = time.perf_counter()
                for step in timed:
                    step()
                _sync(dev)
                r["step_ms"] = (time.perf_counter() - t0) * 1e3 / len(timed)
                with _CollectiveClock(dev) as clock:
                    for step in timed:
                        step()
            r["collectives_ms"] = clock.s * 1e3 / len(timed)
            r["collectives_a_step"] = clock.n / len(timed)
            r["seconds"]["timed"] = time.perf_counter() - t0
    return res


# multi-session pretraining under the mesh, in the same rank processes:
# five synthetic sessions of 668 + 37 i neurons (668-816), padded to
# multiples of 128: one bucket of N_max = 1024 (20.2M parameters, 10.3M of
# them stitched), 40 trials each (32 train), B=16 global. Shard assignment
# at dp=2: three sessions (96 rows) and two (64, padded to 96)
PAR_MS_SESSIONS, PAR_MS_TRIALS, PAR_MS_PAD, PAR_MS_STEPS = 5, 40, 128, 3
_MIXED = dict(device_resident_data=True, mixed_session_batches=True)
PAR_MS_CASES = {
    "host": dict(dropout=0.0, embed_dropout=0.0,
                 menu=("co-smooth", "forward-pred"), tcfg={}),
    "mixed": dict(dropout=DROPOUT, embed_dropout=0.2, menu=MTM_MENU,
                  tcfg=_MIXED),
    "sharded": dict(dropout=DROPOUT, embed_dropout=0.2, menu=MTM_MENU,
                    tcfg=dict(_MIXED, shard_resident_sessions=True)),
}
_PAR_MS_LOADERS: dict = {}


def par_ms_loaders(spec: dict):
    """The phase's multi-session loaders (made once a process)."""
    from multi_modal_foundation_model_tpu_torch.data import synthetic_splits
    from multi_modal_foundation_model_tpu_torch.train import (
        build_multisession_loaders)

    g = spec["geometry"]
    N, T = g["n_channels"]["ap"], g["max_F"]
    key = (N, T, spec["batch"])
    if key not in _PAR_MS_LOADERS:
        sessions = {f"ms-{i}": synthetic_splits(
                        seed=SEED + i, n_trials=PAR_MS_TRIALS,
                        n_neurons=N + 37 * i, n_timesteps=T, eid=f"ms-{i}")
                    for i in range(PAR_MS_SESSIONS)}
        _PAR_MS_LOADERS[key] = build_multisession_loaders(
            sessions, batch_size=spec["batch"], max_time_length=T,
            pad_multiple=PAR_MS_PAD, seed=SEED)
    return _PAR_MS_LOADERS[key]


def par_ms_trainer(spec: dict, dtype, case: str, mesh, log_dir: Path):
    """The session-stitched full-width ``MultiSessionTrainer`` of ``case``
    under ``mesh`` (None: one process, which runs the sharded case's
    global rows on the replicated block), weights from ``SEED``."""
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModal, MultiModalConfig)
    from multi_modal_foundation_model_tpu_torch.ops.masking import (
        MaskParams, RegionTable)
    from multi_modal_foundation_model_tpu_torch.train import (
        MetricLogger, MultiSessionTrainer, OptimizerConfig, TrainerConfig)
    from multi_modal_foundation_model_tpu_torch.train.cuda_graph import (
        StepGraphs)

    c = PAR_MS_CASES[case]
    train, val, _, meta = par_ms_loaders(spec)
    g = spec["geometry"]
    N, T = g["n_channels"]["ap"], g["max_F"]
    mask = MaskParams(channels=tuple(i for i in PAR_MASK["channels"]
                                     if i < N),
                      timesteps=tuple(i for i in PAR_MASK["timesteps"]
                                      if i < T) or (T - 1,))
    cfg = MultiModalConfig(**{**g, "n_channels": {"ap": meta["n_max"],
                                                  "behavior": 2}},
                           n_sessions=len(meta["eids"]),
                           compute_dtype=dtype_name(dtype),
                           dropout=c["dropout"],
                           embed_dropout=c["embed_dropout"], mask_params=mask)
    model = MultiModal(cfg, device=spec["device"],
                       generator=torch.Generator().manual_seed(SEED))
    table = RegionTable.build(meta["per_session_region_ids"],
                              region_vocab=meta["region_vocab"],
                              device=next(model.parameters()).device)
    over = dict(c["tcfg"])
    if mesh is None:
        over.pop("shard_resident_sessions", None)
    tcfg = TrainerConfig(num_epochs=2, mask_type="input", mask_mode=c["menu"],
                         mixed_training=True, seed=SEED, log_dir=str(log_dir),
                         eval_every=10 ** 9, **over)
    tr = MultiSessionTrainer(
        model, train, val, OptimizerConfig(), tcfg, region_table=table,
        eid_to_sid=meta["eid_to_sid"], mesh=mesh,
        logger=MetricLogger(str(log_dir), stdout=False))
    # the single process's resident steps eager too, as a rank's are: the
    # same launches a step, and its step time a rank's less collectives
    tr.graphs = StepGraphs(tr.device, capture=False)
    return tr


def par_ms_steps(tr, case: str, mesh, dp: int):
    """The first ``PAR_MS_STEPS`` resident steps of ``case`` as
    ``_dispatch`` calls: the session-mixed epoch's (its permutation of the
    block's trials), or the sharded epoch's (``sharded_schedule`` at
    ``dp``; a rank gathers from its own shard's block, one process the same
    global rows from the replicated block), with the epoch's host draws.
    Also the shard layout (rows a shard, pools) of the sharded case."""
    from multi_modal_foundation_model_tpu_torch.train.multisession import (
        shard_assignment, sharded_schedule)

    tr._reseed_host_rng(0)
    B = tr.train_dataloader.batch_size
    (eids,) = tr._stack_groups()
    valid = np.ones(B, np.float32)
    # the replicated block's rows on the host (a sharded rank uploads only
    # its shard's block)
    n_trials = {e: tr.train_loaders[e].n_trials for e in eids}
    starts = np.cumsum([0] + [n_trials[e] for e in eids])
    sids = np.concatenate([np.full(n_trials[e], tr.eid_to_sid[e], np.int64)
                           for e in eids])
    if case == "sharded" and mesh is not None:
        data = tr._sharded_block(eids)[0]
    else:
        data = tr._mixed_block(eids)[0]
    out, layout = [], None
    if case == "mixed":
        perm = np.random.default_rng((SEED, 0, 11)).permutation(len(sids))
        batches = [(perm[t * B:(t + 1) * B].astype(np.int64), None)
                   for t in range(PAR_MS_STEPS)]
    else:
        shards, L = shard_assignment(n_trials, eids, dp)
        pools = [sum(n_trials[e] for e in grp) for grp in shards]
        offsets = dict(zip(eids, starts[:-1]))
        rows = [np.concatenate([offsets[e] + np.arange(n_trials[e])
                                for e in grp]) for grp in shards]
        bq = B // dp
        batches = []
        for _, (idx,) in sharded_schedule([pools], B, dp, 1, SEED,
                                          0)[:PAR_MS_STEPS]:
            whole = np.concatenate([rows[s][idx[s * bq:(s + 1) * bq]]
                                    for s in range(dp)])
            batches.append((whole, idx))
        layout = dict(rows=L, pools=pools, total=len(sids))
    for whole, local in batches:
        mode, scheme = tr._sample_modes()
        idx = whole if local is None or mesh is None else local
        out.append((data, [(idx, valid, scheme, sids[whole])], mode))
    return out, layout


def par_ms_run(spec: dict, mesh, out_dir: Path, res: dict,
               to_time: list) -> None:
    """Multi-session pretraining under ``mesh`` in this rank (None: the
    single-process yardstick), per dtype and ``PAR_MS_CASES`` case: host
    batches at dropout 0 (the step-0 loss and gradients, then
    ``PAR_MS_STEPS`` steps), and at dropout 0.4 the session-mixed and (dp
    = 2) the sharded resident steps, each step eager; the losses, the
    launches, the parameters after the steps (gathered), their equality
    over the data group, and the sharded rank's resident bytes. The
    resident trainers' steps go to ``to_time``."""
    from multi_modal_foundation_model_tpu_torch.parallel import (
        full_state_dict, shard_rows)
    from multi_modal_foundation_model_tpu_torch.parallel.mesh import (
        all_reduce_many_)

    dev = spec["device"]
    dp = 2 if mesh is None else mesh.dp
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group
    for dtype in DTYPES:
        for case in PAR_MS_CASES:
            if case == "sharded" and dp != 2:
                continue
            key = f"ms_{dtype_name(dtype)}_{case}"
            t0 = time.perf_counter()
            r = {}
            with ln_mode(spec["layernorm"]):
                tr = par_ms_trainer(spec, dtype, case, mesh, out_dir / key)
                params = dict(tr.model.named_parameters())
                dims = {n: getattr(p, "tp_dim", None)
                        for n, p in params.items()}

                def step0(batch, mode, scheme, session):
                    """The step-0 loss and gradients (summed over the
                    data group, gathered), no update."""
                    reset_counts()
                    out = tr.step_loss(batch, mode, scheme, step=0,
                                       session=session)
                    grads = torch.autograd.grad(
                        out.loss, list(params.values()), allow_unused=True)
                    _sync(dev)
                    r["fwd_bwd"] = read_counts()
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params.values(), grads)]
                    if mesh is not None:
                        all_reduce_many_(grads, data_group)
                    r.update(loss0=float(out.loss.detach()),
                             replicated_equal=_equal_over(
                                 [g for n, g in zip(params, grads)
                                  if dims[n] is None], model_group),
                             grads=_gather_to_cpu(dict(zip(params, grads)),
                                                  dims, mesh))

                if case == "host":
                    tr._reseed_host_rng(0)
                    order = tr._epoch_schedule(0)[:PAR_MS_STEPS]
                    iters = {}
                    for e in set(order):
                        tr.train_loaders[e].set_epoch(0)
                        iters[e] = iter(tr.train_loaders[e])
                    steps = [(e, tr._device_batch(next(iters[e])),
                              tr._sample_modes()) for e in order]
                    e, batch, (mode, scheme) = steps[0]
                    step0(batch, mode, scheme, tr.eid_to_sid[e])
                    reset_counts()
                    r["losses"] = [float(tr.train_step(
                        b, m, s, tr.eid_to_sid[e]))
                        for e, b, (m, s) in steps]
                else:
                    steps, layout = par_ms_steps(tr, case, mesh, dp)
                    data, [(idx, valid, scheme, ids)], mode = steps[0]
                    step0(tr._gather_batch(data, *(
                        torch.from_numpy(shard_rows(x, mesh)).to(dev)
                        for x in (idx, valid))), mode, scheme, ids)
                    reset_counts()
                    r["losses"] = [float(tr._dispatch(*st)[0])
                                   for st in steps]
                    if layout is not None:
                        block = steps[0][0]
                        r["resident"] = dict(
                            layout, block_rows=int(
                                block["spikes_data"].shape[0]),
                            bytes=sum(t.numel() * t.element_size()
                                      for t in block.values()),
                            replicated_uploaded=bool(tr._stacked_cache))
                    to_time.append((key, [
                        lambda tr=tr, st=st: tr._dispatch(*st)
                        for st in steps]))
                _sync(dev)
                r["step_launches"] = read_counts()
                r["data_equal"] = _equal_over(list(params.values()),
                                              data_group)
                r["params"] = {k: v.to("cpu", copy=True) for k, v in
                               full_state_dict(tr.model, mesh).items()}
                r["seconds"] = dict(checks_and_steps=time.perf_counter()
                                    - t0)
                res[key] = r
                del tr, params
                if case == "host" and torch.device(dev).type == "cuda":
                    torch.cuda.empty_cache()


def parallel_worker(spec_path: str, rank: str, world: str, port: str
                    ) -> None:
    """``--parallel-worker``: one rank of the phase; rank 0 writes the
    result beside the spec."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from multi_modal_foundation_model_tpu_torch.ops import build
    from multi_modal_foundation_model_tpu_torch.parallel import (
        build_mesh, initialize_multihost, rank_device)

    spec = json.loads(Path(spec_path).read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.device(spec["device"]).type == "cuda":
        build.build(build.kernel_sources())     # built: loads them
        rank_device("cuda:0")
    initialize_multihost(f"localhost:{port}", int(world), int(rank),
                         backend=spec["backend"], device=spec["device"])
    mesh = build_mesh(spec["dp"], spec["tp"])
    startup_s = time.time() - spec["spawn_t"]
    out_dir = Path(spec["out"]).parent
    res = par_run(spec, mesh, out_dir)
    res["mesh"] = [mesh.dp, mesh.tp]
    res["startup_s"] = startup_s
    if int(rank) == 0:
        torch.save(res, spec["out"])
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(argv_of, world: int, timeout: float, port: int = None):
    """``world`` processes (``argv_of(rank, port)``), waited for; returns
    (return codes, outputs, seconds). Every process is ended."""
    port = _free_port() if port is None else port
    procs = [subprocess.Popen(argv_of(r, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                outs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed at timeout]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ([p.returncode for p in procs], outs,
            time.perf_counter() - t0)


def par_layouts(spec: dict, layouts, out: Path, beside=None):
    """The phase's ranks of ``layouts``, all started together, and
    ``beside()`` run here meanwhile: each layout's rank 0 result, and
    ``beside``'s. The layouts time their steps one at a time, after every
    layout's checks and after ``beside`` has ended (``_timing_turn``). A
    rank that fails fails the phase, with its output."""
    from concurrent.futures import ThreadPoolExecutor

    names = [f"dp{dp}_tp{tp}" for dp, tp in layouts]
    turns = names if beside is None else ["beside"] + names
    ports = set()
    while len(ports) < len(layouts):
        ports.add(_free_port())
    script = str(Path(__file__).resolve())

    def run(name, layout, port):
        dp, tp = layout
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        path = d / "spec.json"
        path.write_text(json.dumps(dict(
            spec, dp=dp, tp=tp, out=str(d / "rank0.pt"), name=name,
            side_by_side=turns if len(turns) > 1 else None,
            turn_dir=str(out), spawn_t=time.time())))
        return spawn_ranks(
            lambda r, port: [sys.executable, script, "--parallel-worker",
                             str(path), str(r), str(dp * tp), str(port)],
            dp * tp, timeout=600, port=port)

    other = None
    with ThreadPoolExecutor(len(layouts)) as pool:
        runs = pool.map(run, names, layouts, sorted(ports))
        if beside is not None:
            try:
                other = beside()
            finally:               # ended, even failed: the layouts go on
                for stage in ("checked", "timed"):
                    (out / f"{stage}_beside").touch()
        runs = list(runs)
    results = []
    for name, (rcs, outs, secs) in zip(names, runs):
        if any(rcs):
            bad = [i for i, rc in enumerate(rcs) if rc]
            raise AssertionError(f"parallel {name}: ranks {bad} exited "
                                 f"{rcs}:\n{outs[bad[0]][-6000:]}")
        res = torch.load(out / name / "rank0.pt", weights_only=False)
        res["wall_s"] = secs
        results.append(res)
    return results, other


def _par_gates(dtype, loss, want_loss, got: dict, want: dict) -> dict:
    """Loss and per-tensor gates, against the single process: f32 loss
    within 1e-5 max(1, |loss|), each tensor within rtol 2e-3 / atol 1e-5
    (JAX's ``test_tp_matches_single_device``); bf16 loss within 1e-2
    relative, each tensor within 5e-2 relative L2. The attention key biases
    are left out: their exact gradient is 0 (softmax is shift-invariant),
    so both sides hold rounding noise there, which AdamW's steps scale up
    (as the trainer lockstep tests leave them out)."""
    loss_err = abs(loss - want_loss)
    names = [n for n in want if not n.endswith("key.bias")]
    if dtype == torch.float32:
        loss_ok = loss_err <= 1e-5 * max(1.0, abs(want_loss))
        excess = max(((got[n].float() - want[n].float()).abs() - 1e-5
                      - 2e-3 * want[n].float().abs()).max().item()
                     for n in names)
        return dict(loss_abs_err=loss_err, excess=excess,
                    ok=loss_ok and excess <= 0.0)
    rel, worst = max(
        (((got[n].float() - want[n].float()).norm()
          / want[n].float().norm().clamp_min(1e-30)).item(), n)
        for n in names)
    loss_ok = loss_err <= 1e-2 * abs(want_loss)
    return dict(loss_abs_err=loss_err, rel_l2_worst=rel, worst=worst,
                ok=loss_ok and rel <= 5e-2)


def _par_launches_ok(launches: dict, want: dict, steps: int) -> bool:
    return all(launches[k] == want[k] * steps for k in ("k1", "k2", "k3",
                                                        "k4"))


def par_compare(spec: dict, layout, got: dict, ref: dict) -> dict:
    """Every gate of one layout against the single process; emits a line
    per dtype and case, raises when a gate fails. Returns rank 0's
    launches by dtype."""
    dp, tp = layout
    on_card = torch.device(spec["device"]).type == "cuda"
    want_step = dict(k1=2 * K1_ATTN_PER_FORWARD, k2=K1_ATTN_PER_FORWARD,
                     k3=K3_PER_STEP, k4=K4_PER_STEP)
    launches = {}
    for dtype in DTYPES:
        for case in PAR_CASES:
            key = f"{dtype_name(dtype)}_{case}"
            g, w = got[key], ref[key]
            grads = _par_gates(dtype, g["loss0"], w["loss0"], g["grads"],
                               w["grads"])
            ok = grads["ok"] and g["replicated_equal"]
            line = dict(phase="parallel", dp=dp, tp=tp,
                        dtype=dtype_name(dtype), case=case,
                        dropout=PAR_CASES[case]["dropout"],
                        loss=g["loss0"], loss_single=w["loss0"],
                        grads=grads,
                        replicated_grads_equal=g["replicated_equal"],
                        fwd_bwd_launches=g["fwd_bwd"])
            if on_card:
                fb_ok = (_par_launches_ok(g["fwd_bwd"], want_step, 1)
                         and g["fwd_bwd"]["philox"]
                         == w["fwd_bwd"]["philox"])
                line["fwd_bwd_launches_ok"] = fb_ok
                ok = ok and fb_ok
            if case == "drop":
                params = _par_gates(dtype, g["losses"][-1], w["losses"][-1],
                                    g["params"], w["params"])
                step_ok = (params["ok"] and g["data_equal"]
                           and all(math.isfinite(x) for x in g["losses"]))
                line.update(losses=g["losses"], losses_single=w["losses"],
                            params_after_steps=params,
                            params_equal_over_data=g["data_equal"],
                            step_launches=g["step_launches"],
                            step_ms_per_rank=g["step_ms"],
                            step_ms_single=w["step_ms"],
                            collectives_ms_a_step=g["collectives_ms"],
                            collectives_a_step=g["collectives_a_step"])
                if on_card:
                    st_ok = (_par_launches_ok(g["step_launches"], want_step,
                                              PAR_STEPS)
                             and g["step_launches"]["philox"]
                             == w["step_launches"]["philox"])
                    line["step_launches_ok"] = st_ok
                    step_ok = step_ok and st_ok
                ok = ok and step_ok
                launches[dtype] = g["step_launches"]
            line["ok"] = ok
            emit(**line)
            if not ok:
                raise AssertionError(f"parallel dp={dp} tp={tp} {key}: a "
                                     "gate failed (see the parallel line)")
    return launches


def par_ms_compare(spec: dict, layout, got: dict, ref: dict) -> dict:
    """Every gate of the multi-session cases of one layout against the
    single process fed the same global rows (``_par_gates`` after the
    steps; on host batches the step-0 loss and gradients too), the
    replicated gradients bit-equal over the model group and the
    parameters over the data group, the launches a step a rank those of
    the single process (K1 30, K2 15, K3 62, K4 32, its Philox count, the
    session-rows kernel 7 a resident mixed step), and a sharded rank's
    block its shard's ``L`` rows (not the replicated block's); emits a
    ``parallel_multisession`` line a case, raises when a gate fails.
    Returns rank 0's launches by dtype, summed over the cases."""
    dp, tp = layout
    on_card = torch.device(spec["device"]).type == "cuda"
    want_step = dict(k1=2 * K1_ATTN_PER_FORWARD, k2=K1_ATTN_PER_FORWARD,
                     k3=K3_PER_STEP, k4=K4_PER_STEP)
    launches = {}
    for dtype in DTYPES:
        total: dict = {}
        for case, c in PAR_MS_CASES.items():
            key = f"ms_{dtype_name(dtype)}_{case}"
            if key not in got:
                continue
            g, w = got[key], ref[key]
            grads = _par_gates(dtype, g["loss0"], w["loss0"], g["grads"],
                               w["grads"])
            params = _par_gates(dtype, g["losses"][-1], w["losses"][-1],
                                g["params"], w["params"])
            rel = 1e-5 if dtype == torch.float32 else 1e-2
            losses_ok = all(abs(a - b) <= rel * max(1.0, abs(b))
                            for a, b in zip(g["losses"], w["losses"]))
            ok = (grads["ok"] and g["replicated_equal"] and losses_ok
                  and params["ok"] and g["data_equal"]
                  and all(math.isfinite(x) for x in g["losses"]))
            line = dict(phase="parallel_multisession", dp=dp, tp=tp,
                        dtype=dtype_name(dtype), case=case,
                        dropout=c["dropout"], steps=PAR_MS_STEPS,
                        loss=g["loss0"], loss_single=w["loss0"],
                        grads=grads,
                        replicated_grads_equal=g["replicated_equal"],
                        losses=g["losses"], losses_single=w["losses"],
                        losses_ok=losses_ok, params_after_steps=params,
                        params_equal_over_data=g["data_equal"],
                        fwd_bwd_launches=g["fwd_bwd"],
                        step_launches=g["step_launches"],
                        step_launches_single=w["step_launches"])
            if "resident" in g:
                rr = g["resident"]
                row_bytes = rr["bytes"] / rr["block_rows"]
                res_ok = (rr["block_rows"] == rr["rows"] == max(rr["pools"])
                          < rr["total"] and not rr["replicated_uploaded"])
                line["resident"] = dict(
                    rr, replicated_block_bytes=row_bytes * rr["total"],
                    share_of_replicated=rr["rows"] / rr["total"], ok=res_ok)
                ok = ok and res_ok
            if on_card:
                sl, wl = g["step_launches"], w["step_launches"]
                rows = 0 if case == "host" else SESSION_ROWS_PER_STEP
                l_ok = (_par_launches_ok(sl, want_step, PAR_MS_STEPS)
                        and sl["philox"] == wl["philox"]
                        and sl["session_rows"] == wl["session_rows"]
                        == rows * PAR_MS_STEPS)
                line["step_launches_ok"] = l_ok
                ok = ok and l_ok
            if "step_ms" in g:
                line.update(step_ms_per_rank=g["step_ms"],
                            step_ms_single=w.get("step_ms"),
                            collectives_ms_a_step=g["collectives_ms"],
                            collectives_a_step=g["collectives_a_step"])
            line["ok"] = ok
            emit(**line)
            if not ok:
                raise AssertionError(f"parallel multi-session dp={dp} tp={tp}"
                                     f" {key}: a gate failed (see its line)")
            for k, v in g["step_launches"].items():
                total[k] = total.get(k, 0) + v
        launches[dtype] = total
    return launches


def session_rows_rank_check() -> dict:
    """The session-rows kernel at a dp 2 x tp 2 rank's shape of the
    multi-session mesh phase: the stitched tokenizer kernel's gradient of
    B=8 samples (16 global over dp=2) at N_max 1024 and 256 of its 512
    columns (tp=2), 5 sessions, f32 and bf16; bit for bit against its
    plain version and from one launch to the next, timed beside the plain
    version and ``index_add_`` with the L2 flushed before each launch
    (and warm, as a second reading), with the byte bound."""
    from multi_modal_foundation_model_tpu_torch.ops import session_rows as sr

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S, B, shape = PAR_MS_SESSIONS, TRAIN_B // 2, (1024, 256)
    ids = torch.randint(0, S - 1, (B,), device="cuda", generator=gen)
    # its 13.6 MB (f32) fit the 50 MB L2: a 64 MB copy before each timed
    # launch sends them back to HBM, and the copy's own time (a device
    # "Memcpy DtoD") is left out
    src = torch.empty(1 << 24, device="cuda")
    dst = torch.empty_like(src)

    def cold_ms(fn) -> float:
        by = device_ms_by_kernel(lambda: (dst.copy_(src), fn()))
        return sum(ms for name, ms in by.items()
                   if "memcpy" not in name.lower())

    out = {}
    for dtype in DTYPES:
        g = torch.randn((B,) + shape, device="cuda", generator=gen).to(dtype)
        got = sr.session_rows_grad(g, ids, S)
        again = sr.session_rows_grad(g, ids, S)
        want = sr.session_rows_grad_reference(g, ids, S)
        err = (got - want).abs().max().item()
        ok = torch.equal(got, again) and err == 0.0
        g2 = g.reshape(B, -1)
        n_bytes = g.numel() * g.element_size() + S * g2.shape[1] * 4
        out[dtype] = dict(
            max_abs_err=err,
            ms=cold_ms(lambda: sr.session_rows_grad(g, ids, S)),
            plain_ms=cuda_time_ms(
                lambda: sr.session_rows_grad_reference(g, ids, S), 5, 1),
            library_ms=cold_ms(lambda: torch.zeros(
                S, g2.shape[1], dtype=g.dtype, device="cuda").index_add_(
                    0, ids, g2)),
            **_bound(n_bytes + B * 8, g.numel(), torch.float32))
        emit(phase="parallel_session_rows_check", dtype=dtype_name(dtype),
             shape=[B, *shape], sessions=S, **out[dtype],
             warm_l2_ms=device_ms(lambda: sr.session_rows_grad(g, ids, S)),
             library_call="torch.zeros(S, M).index_add_(0, ids, g)", ok=ok)
        if not ok:
            raise AssertionError(f"session rows kernel at the rank shape "
                                 f"({dtype}): not bit-equal ({err})")
    return out


def par_checkpoint(spec: dict, out: Path) -> dict:
    """The dp 2 x tp 2 run's f32 checkpoint, loaded into a one-process eval
    model, against the single process's after the same steps: the eval
    forward of one test batch within 1e-5."""
    from multi_modal_foundation_model_tpu_torch.data import synthetic_splits
    from multi_modal_foundation_model_tpu_torch.eval import (
        load_model_data_local)
    from multi_modal_foundation_model_tpu_torch.models import ModalityInput

    g, dev = spec["geometry"], spec["device"]
    N, T = g["n_channels"]["ap"], g["max_F"]
    test = synthetic_splits(seed=SEED, n_trials=spec["n_trials"],
                            n_neurons=N, n_timesteps=T).test
    preds = []
    for side in ("single", "dp2_tp2"):
        model, loader = load_model_data_local(
            model_dir=str(out / side / "float32_drop"),
            test_session=test, checkpoint_name="last", max_time_length=T,
            max_space_length=N, batch_size=spec["batch"], device=dev)
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in next(iter(loader)).items()
                 if k in ("spikes_data", "target", "time_attn_mask",
                          "spikes_timestamps")}

        def mi(x):
            ev = torch.zeros(x.shape, dtype=torch.int32, device=dev)
            ev[:, :, :2] = 1            # the first two channels held out
            return ModalityInput(inputs=x, targets=x,
                                 attn_mask=batch["time_attn_mask"],
                                 timestamps=batch["spikes_timestamps"],
                                 eval_mask=ev)

        with torch.no_grad(), ln_mode(spec["layernorm"]):
            o = model({"ap": mi(batch["spikes_data"]),
                       "behavior": mi(batch["target"])})
        preds.append({m: v.float().cpu() for m, v in o.mod_preds.items()})
    err = max((preds[0][m] - preds[1][m]).abs().max().item()
              for m in preds[0])
    ok = err <= 1e-5
    emit(phase="parallel_checkpoint", dtype="float32", layout=[2, 2],
         eval_forward_max_abs_err=err, tolerance="atol 1e-5", ok=ok)
    if not ok:
        raise AssertionError("the dp 2 x tp 2 checkpoint's eval forward is "
                             f"off by {err}")
    return dict(max_abs_err=err)


def nccl_collectives(rank: int, world: int, port: int) -> dict:
    """``all_reduce``, ``broadcast`` and ``all_gather`` of f32 and bf16
    tensors on ``cuda:0`` over NCCL in a world of ``world``; returns what
    came back (rank + 1 summed, rank world - 1's value, every rank's)."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    got = {}
    try:
        for dt in (torch.float32, torch.bfloat16):
            t = torch.full((1 << 20,), float(rank + 1), device="cuda",
                           dtype=dt)
            dist.all_reduce(t)
            b = torch.full((8,), float(rank), device="cuda", dtype=dt)
            dist.broadcast(b, src=world - 1)
            parts = [torch.empty(4, device="cuda", dtype=dt)
                     for _ in range(world)]
            dist.all_gather(parts, torch.full((4,), float(rank),
                                              device="cuda", dtype=dt))
            torch.cuda.synchronize()
            got[dtype_name(dt)] = [float(t[0]), float(b[0]),
                                   [float(p[0]) for p in parts]]
    finally:
        dist.destroy_process_group()
    return got


def nccl_checks() -> dict:
    """NCCL on the card: a world of one (this process) runs
    ``all_reduce``, ``broadcast`` and ``all_gather`` on card tensors (the
    path a rank a card takes); two ranks on the one card, as the gloo
    layouts run, are refused (recorded, not gated: the finding that sends
    them to gloo)."""
    t0 = time.perf_counter()
    one = nccl_collectives(0, 1, _free_port())
    secs = time.perf_counter() - t0
    ok = all(v[0] == 1.0 and v[1] == 0.0 and v[2] == [0.0]
             for v in one.values())
    script = str(Path(__file__).resolve())
    rcs2, outs2, secs2 = spawn_ranks(
        lambda r, port: [sys.executable, script, "--nccl-worker", str(r),
                         "2", str(port)], 2, timeout=120)
    dup = ["Duplicate GPU detected" in o for o in outs2]
    emit(phase="parallel_nccl", world_1=dict(results=one, seconds=secs,
                                             ok=ok),
         world_2_one_card=dict(rcs=rcs2, seconds=secs2,
                               duplicate_gpu_refused=dup,
                               tail=[o[-600:] for o in outs2]))
    if not ok:
        raise AssertionError(f"NCCL at a world of one gave {one}")
    return dict(world_1_ok=ok, two_ranks_refused=all(dup))


def par_script(root: Path) -> dict:
    """``train_multi_modal --dp 2 --tp 2`` as four ranks on the card
    (torchrun, gloo): one epoch at its defaults on 60 synthetic trials (3
    steps of 16 and the eval); the loss finite, the checkpoint loading into
    one process."""
    from multi_modal_foundation_model_tpu_torch.data import synthetic_splits
    from multi_modal_foundation_model_tpu_torch.eval import (
        load_model_data_local)

    base = root / "chip_smoke_parallel_script"
    shutil.rmtree(base, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", "-m",
           "multi_modal_foundation_model_tpu_torch.scripts.train_multi_modal",
           "--synthetic", "--use_MtM", "--mixed_training", "--dp", "2",
           "--tp", "2", "--backend", "gloo", "--n_trials", "60",
           "--num_epochs", "1", "--base_path", str(base), *NO_EPOCH_PLOTS]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=str(Path(__file__).resolve().parent),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError("train_multi_modal --dp 2 --tp 2 failed:\n"
                             + (out.stdout + out.stderr)[-6000:])
    (metrics,) = base.rglob("metrics.jsonl")
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    epochs = [r for r in rows if "epoch" in r]
    finite = len(epochs) == 1 and math.isfinite(epochs[0]["train_loss"])
    model, _ = load_model_data_local(
        model_dir=str(metrics.parent), checkpoint_name="last",
        test_session=synthetic_splits(seed=42, n_trials=60,
                                      n_neurons=668).test,
        max_time_length=100)
    whole = model.encoder[0].attn.n_heads == GEOMETRY["n_heads"]
    emit(phase="parallel_script", argv=cmd[6:], wall_s=wall,
         train_loss=epochs[-1]["train_loss"] if epochs else None,
         finite=finite, checkpoint_loads_whole=whole, ok=finite and whole)
    if not (finite and whole):
        raise AssertionError("train_multi_modal --dp 2 --tp 2: loss or "
                             "checkpoint off")
    return dict(wall_s=wall)


def attn_train_times(q, k, v, key_pad, static, g, H, draw_offset=(0, 0),
                     timer=cuda_time_ms, math: bool = False) -> tuple:
    """K1 (dropout 0.4, lse) and K2 at the operands' shape, timed beside
    their plain versions (with the dots of q's dtype) and SDPA
    (``SDPA_BACKEND``) with the same additive bias and dropout_p, K2's its
    backward ((fwd + bwd) - fwd), and with ``math`` SDPA's MATH backward
    too (``library_math_ms`` of both rows, the f32 kernels' other
    yardstick: the forward's, and the backward's (fwd + bwd) - fwd); with the
    bounds: each input read once, each output written once, the products
    as ``_tc_bound`` counts them at the operands' head width.
    ``timer(fn, reps, warmup)``: CUDA events (``cuda_time_ms``: at B=16 the
    wrappers' host path is part of what they read) or profiler device time
    (``device_ms``). Returns the K1 and K2 rows, without their errors."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    dtype = q.dtype
    B, Tq, hidden = q.shape
    Tk, D = k.shape[1], hidden // H
    scale = D ** -0.5
    off = draw_offset
    _, lse = att.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                               DROPOUT, 7, draw_offset=off)
    k1_ms = timer(lambda: att.attention_fwd(
        q, k, v, key_pad, static, H, scale, True, DROPOUT, 7,
        draw_offset=off))
    k2_ms = timer(lambda: att.attention_bwd(
        q, k, v, key_pad, static, g, lse, H, scale, DROPOUT, 7,
        draw_offset=off))
    k1_plain = timer(lambda: att.attention_reference(
        q, k, v, key_pad, static, H, scale, True, DROPOUT, 7,
        dots_dtype=dtype, draw_offset=off), 5, 1)
    k2_plain = timer(lambda: att.attention_bwd_reference(
        q, k, v, key_pad, static, g, lse, H, scale, DROPOUT, 7,
        dots_dtype=dtype, draw_offset=off), 5, 1)
    bias = att.mask_to_bias(static.bool()[None]
                            | key_pad.bool()[:, None])[:, None].to(dtype)
    qh, kh, vh = (x.detach().unflatten(-1, (H, D)).transpose(1, 2)
                  .requires_grad_(True) for x in (q, k, v))
    gh = g.unflatten(-1, (H, D)).transpose(1, 2)

    def lib(backend=None):
        return sdpa(qh, kh, vh, attn_mask=bias, dropout_p=DROPOUT,
                    backend=backend)

    lib_fwd = timer(lambda: lib().detach())
    lib_fwd_bwd = timer(lambda: torch.autograd.grad(
        lib(), (qh, kh, vh), gh))
    extra, extra1 = {}, {}
    if math:
        extra1["library_math_ms"] = timer(lambda: lib("MATH").detach())
        extra["library_math_ms"] = timer(lambda: torch.autograd.grad(
            lib("MATH"), (qh, kh, vh), gh)) - extra1["library_math_ms"]
    elem = q.element_size()
    masks = key_pad.numel() * 4 + static.numel() * 4
    lse_bytes = B * H * Tq * 4
    # K1: q, k, v in, out and lse out; two products. K2: q, g, k, v, lse
    # in; dq, dk, dv out; five products
    k1_b = _tc_bound(B * (2 * Tq + 2 * Tk) * hidden * elem + lse_bytes
                     + masks, 4 * B * H * Tq * Tk * D, dtype)
    k2_b = _tc_bound(B * (3 * Tq + 4 * Tk) * hidden * elem + lse_bytes
                     + masks, 10 * B * H * Tq * Tk * D, dtype)
    return (dict(ms=k1_ms, plain_ms=k1_plain, library_ms=lib_fwd, **extra1,
                 **k1_b),
            dict(ms=k2_ms, plain_ms=k2_plain,
                 library_ms=lib_fwd_bwd - lib_fwd,
                 library_fwd_bwd_ms=lib_fwd_bwd, **extra, **k2_b))


def rank_kernels_check(D: int = 32, H: int = 4, timed: bool = True) -> dict:
    """K1 (dropout, lse) and K2 at a tensor-parallel rank's shape under
    tp=2 at B=16 and dp=2: (B=8, 200, H D), H heads of D (the parallel
    phase: 4 of 32), the q/k/v column views of the rank's (8, 200, 3 H D)
    fused product, the draw offsets of rank (d, m) = (1, 1), (8, H). Each
    against its plain version with the same offsets (``k1_gates``,
    ``k2_gates``), and bit-equal to the same rows and heads of the whole
    (16, 200, 2 H D) call; with ``timed``, timed beside the plain version
    and SDPA at the same shape, with the bound (``attn_train_times``)."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    rows = {}
    B, T, off = 8, 200, (8, H)
    for dtype in DTYPES:
        g = torch.Generator(device="cuda").manual_seed(11)
        qkv = torch.randn(2 * B, T, 3 * 2 * H * D, device="cuda",
                          generator=g).to(dtype)
        go = torch.randn(2 * B, T, 2 * H * D, device="cuda",
                         generator=g).to(dtype)
        pad = torch.ones(2 * B, T, dtype=torch.int32, device="cuda")
        pad[::5, T - 30:] = 0
        static = torch.eye(T, dtype=torch.int32, device="cuda")
        scale = D ** -0.5
        # the whole call, and rank (1, 1)'s slice of its fused product
        wq, wk, wv = qkv.split(2 * H * D, dim=-1)
        whole_o, whole_lse = att.attention_fwd(wq, wk, wv, pad, static,
                                               2 * H, scale, True, DROPOUT,
                                               77)
        whole_g = att.attention_bwd(wq, wk, wv, pad, static, go, whole_lse,
                                    2 * H, scale, DROPOUT, 77)
        cols = torch.cat([x[B:, :, H * D:] for x in (wq, wk, wv)], dim=-1)
        q, k, v = cols.split(H * D, dim=-1)            # column views
        key_pad = pad[B:].contiguous()
        gr = go[B:, :, H * D:].contiguous()
        worst1 = worst2 = 0.0
        for rate in (0.0, DROPOUT):
            o, lse = att.attention_fwd(q, k, v, key_pad, static, H, scale,
                                       True, rate, 77, draw_offset=off)
            grads = att.attention_bwd(q, k, v, key_pad, static, gr, lse, H,
                                      scale, rate, 77, draw_offset=off)
            k1 = k1_gates(q, k, v, key_pad, static, H, scale, o, lse, rate,
                          77, off)
            k2 = k2_gates(q, k, v, key_pad, static, gr, lse, H, scale,
                          grads, rate, 77, off)
            gerr = k2["dq_dk_dv_max_abs_err"]
            sliced = True
            if rate == DROPOUT:
                sl = (slice(B, None), slice(None), slice(H * D, None))
                sliced = (torch.equal(o, whole_o[sl])
                          and torch.equal(lse, whole_lse[B:, H:])
                          and all(torch.equal(a, b[sl])
                                  for a, b in zip(grads, whole_g)))
            ok = k1["ok"] and k2["ok"] and sliced
            emit(phase="parallel_rank_kernels_check",
                 dtype=dtype_name(dtype), shape=[B, T, H * D], heads=H,
                 head_width=D, draw_offset=list(off), dropout=rate, k1=k1,
                 k2_dq_dk_dv_max_abs_err=gerr,
                 bit_equal_to_the_whole_call=sliced, ok=ok)
            if not ok:
                raise AssertionError(f"per-rank K1/K2 ({dtype}, {rate}, "
                                     f"D {D}) off (see the line)")
            worst1 = max(worst1, k1["max_abs_err"])
            worst2 = max(worst2, *gerr)
        if not timed:
            continue
        # timings at dropout 0.4, the training step's
        t1, t2 = attn_train_times(q, k, v, key_pad, static, gr, H, off)
        emit(phase="parallel_rank_kernels_time", dtype=dtype_name(dtype),
             shape=[B, T, T, H, D], dropout=DROPOUT, k1_ms=t1["ms"],
             k1_plain_ms=t1["plain_ms"], k1_library_ms=t1["library_ms"],
             k1_bound={k: t1[k] for k in t1 if k.startswith("bound")},
             k2_ms=t2["ms"], k2_plain_ms=t2["plain_ms"],
             k2_library_ms=t2["library_ms"],
             k2_bound={k: t2[k] for k in t2 if k.startswith("bound")},
             sdpa_backend=SDPA_BACKEND)
        rows[dtype] = (dict(max_abs_err=worst1, **t1),
                       dict(max_abs_err=worst2, **t2))
    return rows


def parallel_phase(root: Path, spec: dict = PAR_SPEC) -> dict:
    """Phase 13 (module docstring): the per-rank kernels, the single-process
    yardstick, the three layouts as ranks over gloo on the card, the
    checkpoint, NCCL, and the script as four ranks. Returns the launches by
    path and the per-rank kernel rows for the kernels line."""
    t0 = time.perf_counter()
    on_card = torch.device(spec["device"]).type == "cuda"
    rank_rows = rank_kernels_check() if on_card else None
    rows_rank = session_rows_rank_check() if on_card else None
    split = dict(rank_kernels=time.perf_counter() - t0)
    out = root / "chip_smoke_parallel"
    shutil.rmtree(out, ignore_errors=True)
    (out / "single").mkdir(parents=True)
    ref = par_run(spec, None, out / "single")
    split["single"] = time.perf_counter() - t0 - sum(split.values())
    launches, script = {}, None
    for group in PAR_LAYOUTS:
        # the script's four ranks run beside the last group's checks
        beside = (lambda: par_script(root)) if (
            on_card and group == PAR_LAYOUTS[-1]) else None
        results, other = par_layouts(spec, group, out, beside)
        script = other if beside is not None else script
        for (dp, tp), got in zip(group, results):
            emit(phase="parallel_layout", dp=dp, tp=tp, ranks=dp * tp,
                 started_with=[list(x) for x in group],
                 script_beside=beside is not None, wall_s=got["wall_s"],
                 rank0_startup_s=got["startup_s"],
                 rank0_seconds={k: v["seconds"] for k, v in got.items()
                                if isinstance(v, dict) and "seconds" in v},
                 backend=spec["backend"],
                 card=nvidia_smi() if on_card else "cpu",
                 note="the ranks share one card and gloo goes through the "
                      "host: these times are not scaling; layouts started "
                      "together are timed one at a time, after the script")
            for dtype, c in par_compare(spec, (dp, tp), got, ref).items():
                launches[f"parallel_dp{dp}_tp{tp}_{dtype_name(dtype)}"] = c
            for dtype, c in par_ms_compare(spec, (dp, tp), got,
                                           ref).items():
                launches[f"parallel_multisession_dp{dp}_tp{tp}_"
                         f"{dtype_name(dtype)}"] = c
    split["layouts_and_script"] = time.perf_counter() - t0 - sum(
        split.values())
    ckpt = par_checkpoint(spec, out)
    nccl = nccl_checks() if on_card else None
    wall = time.perf_counter() - t0
    split["checkpoint_nccl"] = wall - sum(split.values())
    emit(phase="parallel_phase_wall", wall_s=wall, split_s=split,
         single_seconds={k: v["seconds"] for k, v in ref.items()},
         nccl=nccl, script=script, checkpoint=ckpt)
    return dict(launches=launches, rank_rows=rank_rows,
                session_rows_rank=rows_rank)


def multisession_phases(root: Path, default: str):
    """Phases 8-10 over the ten sessions at 100 trials
    (``MS_MIXED_TRIALS``: 50-step epochs); the timing phase at 400 trials
    (320 train, so a B=256 batch fits one session) runs in
    ``scripts/torch_multisession_time.py``. Returns (graph launch counts
    by dtype, phase 10's results, entry launch counts by script, wall
    seconds)."""
    t0 = time.perf_counter()
    short = ms_sessions(MS_MIXED_TRIALS)
    short_loaders = ms_loaders(short)
    emit(phase="multisession_data", sessions=MS_SESSIONS,
         trials=[MS_MIXED_TRIALS],
         num_neurons=short_loaders["meta"]["num_neurons"],
         n_max=short_loaders["meta"]["n_max"],
         wall_s=time.perf_counter() - t0)
    f32, bf16 = torch.float32, torch.bfloat16
    counts = {"f32": multisession_phase(root, short_loaders, f32, default),
              "bf16": multisession_phase(root, short_loaders, bf16, "full")}
    multisession_buckets(root, short, short_loaders, bf16, "full", default)
    multisession_step_check(root, short_loaders, f32, default)
    multisession_step_check(root, short_loaders, bf16, "full")
    # multisession_time (timing only) runs in
    # scripts/torch_multisession_time.py
    mixed = multisession_mixed_phases(root, short, short_loaders, default)
    del short, short_loaders
    entry, entry_s = multisession_entry_phase(root)
    wall = time.perf_counter() - t0
    emit(phase="slice_12_13_phases_wall", total_s=wall, entry_s=entry_s)
    return counts, mixed, entry, wall


# ---------------------------------------------------------------------------
# phase 14: K1-K4 at every width the JAX package runs
# ---------------------------------------------------------------------------

# head widths held against the plain versions: 16, 64 and 128 compiled
# (csrc/attention_{fwd,bwd}_d*.cu), 8 and 24 through zero-padded heads; the
# hidden size near the model's 256 (256 // D heads)
HW_WIDTHS = (8, 16, 24, 64, 128)
# the widths the mm.yaml model runs with 16, 4 and 2 heads: timed here
# (``scripts/torch_width_time.py`` times every width)
HW_TIMED = (16, 64, 128)
# LayerNorm widths: not multiples of 32, and above 1024 (a row a block)
HW_LN_WIDTHS = (48, 100, 1280, 2048, 4096)
HW_LN_ROWS = 3200                 # the B=16 step's tokens
# the mm.yaml model with 2, 4 and 16 heads (D = 128, 64 and 16)
HW_HEADS = (2, 4, 16)
# the graph-vs-eager runs' trials: 64 train trials, 4 steps an epoch
HW_TRIALS = 80


def head_width_kernels() -> dict:
    """K1 (dropout, lse) and K2 at every head width of ``HW_WIDTHS``, B=16,
    T=200, the encoder's mask (eye + key pad), f32 and bf16, dropout 0 and
    0.4, against their plain versions (``k1_gates``; ``k2_gates`` with the
    bf16 K2 held to its contract, the bf16-dots plain version: at D = 8
    the f32-dots one moves past 2e-2 (1 + |plain|) by the bf16 rounding of
    8-term products alone, which the line reports); the widths of
    ``HW_TIMED`` then timed by profiler device time (``attn_train_times``;
    at B=16 a wrapper's host path takes about as long as its kernel, which
    CUDA events would time). Every width is checked before a failure
    raises. Returns {(D, dtype): (K1 row, K2 row)}, the rows of the other
    widths with their errors only."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    rows, failed = {}, []
    for D in HW_WIDTHS:
        H = GEOMETRY["hidden_size"] // D
        for dtype in DTYPES:
            q, k, v, spec, _ = k1_inputs("encoder_eye_pad", dtype, B=TRAIN_B,
                                         T=200, H=H, D=D, seed=D)
            B, Tq, hidden = q.shape
            key_pad, static = att.spec_operands(spec, B, Tq, k.shape[1],
                                                q.device)
            scale = 1.0 / math.sqrt(D)
            g = torch.randn(q.shape, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(D)).to(dtype)
            worst1 = worst2 = 0.0
            for rate in (0.0, DROPOUT):
                out, lse = att.attention_fwd(q, k, v, key_pad, static, H,
                                             scale, True, rate, 99)
                grads = att.attention_bwd(q, k, v, key_pad, static, g, lse,
                                          H, scale, rate, 99)
                torch.cuda.synchronize()
                k1 = k1_gates(q, k, v, key_pad, static, H, scale, out, lse,
                              rate, 99)
                k2 = k2_gates(q, k, v, key_pad, static, g, lse, H, scale,
                              grads, rate, 99, f32_dots_gate=False)
                ok = k1["ok"] and k2["ok"] and out.shape == q.shape
                emit(phase="head_widths_kernels_check", head_width=D,
                     heads=H, compiled_width=att.kernel_head_dim(D),
                     dtype=dtype_name(dtype), dropout=rate,
                     shape=[B, Tq, hidden], k1=k1, k2=k2, ok=ok)
                if not ok:
                    failed.append((D, dtype_name(dtype), rate))
                worst1 = max(worst1, k1["max_abs_err"])
                worst2 = max(worst2, *k2["dq_dk_dv_max_abs_err"])
            t1 = t2 = {}
            if D in HW_TIMED:
                t1, t2 = attn_train_times(
                    q, k, v, key_pad, static, g, H,
                    timer=lambda fn, reps=20, warmup=3: device_ms(fn, reps),
                    math=D == 128 and dtype == torch.float32)
                emit(phase="head_widths_kernels_time", head_width=D,
                     heads=H, dtype=dtype_name(dtype),
                     shape=[B, Tq, Tq, H, D], dropout=DROPOUT, k1=t1, k2=t2,
                     timer="profiler device time", sdpa_backend=SDPA_BACKEND)
            rows[D, dtype] = (dict(max_abs_err=worst1, **t1),
                              dict(max_abs_err=worst2, **t2))
    if failed:
        raise AssertionError(f"K1/K2 off at (head width, dtype, dropout) "
                             f"{failed} (see the lines)")
    return rows


def head_width_eval_forward(cfg, dtype, mode: str) -> dict:
    """One eval forward of ``cfg``'s model over the synthetic test split,
    kernel path (``mode``) against the plain path (``"xla"``, ``"off"``):
    f32 atol 1e-4, bf16 relative L2 2e-2 (``eval_phase``'s gates), K1 15
    and K3 32 (under "full") a forward. Returns the launch counts."""
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval import EvalForward
    from multi_modal_foundation_model_tpu_torch.models import MultiModal

    T, N = cfg.max_F, cfg.n_channels["ap"]
    model = MultiModal(cfg, generator=torch.Generator().manual_seed(SEED))
    plain = MultiModal(dataclasses.replace(cfg, attn_impl="xla"))
    plain.load_state_dict(model.state_dict())
    test = synthetic_splits(seed=SEED, n_trials=HW_TRIALS, n_neurons=N,
                            n_timesteps=T).test
    batch = next(iter(make_loader(test, batch_size=test.n_trials,
                                  max_time_length=T, max_space_length=N,
                                  shuffle=False)))
    reset_counts()
    with ln_mode(mode):
        ap_k, beh_k = EvalForward(model, batch, chunk=CHUNK).forward()
    torch.cuda.synchronize()
    counts = read_counts()
    with ln_mode("off"):
        ap_p, beh_p = EvalForward(plain, batch, chunk=CHUNK).forward()
    err = max(np.abs(ap_k - ap_p).max(), np.abs(beh_k - beh_p).max())
    rel = max(_rel(ap_k, ap_p), _rel(beh_k, beh_p))
    want = dict(k1=K1_ATTN_PER_FORWARD,
                k3=K3_PER_FORWARD if mode == "full" else 0)
    ok = bool((err <= 1e-4 if dtype == torch.float32 else rel <= 2e-2)
              and np.isfinite(ap_k).all() and np.isfinite(beh_k).all()
              and all(counts[k] == n for k, n in want.items()))
    emit(phase="head_widths_eval_forward", dtype=dtype_name(dtype),
         layernorm=mode, n_heads=cfg.n_heads,
         head_width=cfg.hidden_size // cfg.n_heads,
         batch=int(batch["n_real"]), preds_max_abs_err=float(err),
         preds_rel_l2=rel, launches=counts, launches_expected=want,
         tolerance=("atol 1e-4" if dtype == torch.float32
                    else "relative L2 2e-2"), ok=ok)
    if not ok:
        raise AssertionError(f"eval forward at {cfg.n_heads} heads off "
                             "(see the line)")
    return counts


def head_width_script(root: Path) -> dict:
    """``train_multi_modal --synthetic`` (mm.yaml, bf16, the resident path)
    with 4 heads in the encoder and the decoder (``--set
    model.{en,de}coder.transformer.n_heads=4``) for one epoch: finite
    metrics rows, the model config's 4 heads, and K1, K2, K3, K4 launched.
    Returns the launch counts."""
    from multi_modal_foundation_model_tpu_torch.scripts import (
        train_multi_modal)
    from multi_modal_foundation_model_tpu_torch.scripts._common import (
        DEFAULT_EID, log_dir_for)

    base = root / "chip_smoke_head_widths_script"
    shutil.rmtree(base, ignore_errors=True)
    argv = ["--synthetic", "--device", "cuda", "--overwrite", "--base_path",
            str(base), "--use_MtM", "--mixed_training", "--num_epochs", "1",
            "--n_trials", "160", "--device_resident", *NO_EPOCH_PLOTS,
            "--set", "training.steps_per_dispatch=10",
            "--set", "model.encoder.transformer.n_heads=4",
            "--set", "model.decoder.transformer.n_heads=4"]
    log_dir = Path(log_dir_for(str(base), DEFAULT_EID,
                               {"input": ["ap", "behavior"],
                                "output": ["ap", "behavior"]},
                               "mask-temporal_ratio-0.1_mixed-True"))
    reset_counts()
    t0 = time.perf_counter()
    train_multi_modal.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rows = [json.loads(line) for line in
            (log_dir / "metrics.jsonl").read_text().splitlines()]
    model_cfg = json.loads((log_dir / "model_config.json").read_text())
    ok = (bool(rows) and _finite_tree(rows)
          and model_cfg["n_heads"] == 4
          and all(counts[k] > 0 for k in ("k1", "k2", "k3", "k4")))
    emit(phase="head_widths_script", script="train_multi_modal", argv=argv,
         wall_s=wall, launches=counts, rows=len(rows), finite=_finite_tree(
             rows), n_heads=model_cfg["n_heads"], ok=ok)
    if not ok:
        raise AssertionError("train_multi_modal at 4 heads off (see the "
                             "line)")
    return counts


def head_width_rows(hw: dict, src: str, attn_py: str, ln_py: str,
                    kernels: list) -> list:
    """The kernels line's rows of phase 14: K1 and K2 at head widths 16, 64
    and 128, the mm.yaml model's with 16, 4 and 2 heads (f32, bf16 beside
    it; launches on its paths, and the f32 paths' apart; times by profiler
    device time; the f32 K1 and K2 at 128 also beside SDPA's MATH forward
    and backward); the widths no model path runs
    (8 and 24 zero-padded) in the width-64 rows, and the new LayerNorm
    widths in the K3 and K4 rows of ``kernels``, each with its error,
    launched on no main path (their times:
    ``scripts/torch_width_time.py``)."""
    from multi_modal_foundation_model_tpu_torch.ops import attention as att

    f32, bf16 = torch.float32, torch.bfloat16
    rows, paths = hw["rows"], hw["paths"]
    out = []
    for i, (kname, short, line, lib) in enumerate((
            ("k1", "attention_fwd (K1; timed as the training step's: "
             "dropout 0.4, lse)", ":144", "attention_fwd"),
            ("k2", "attention_bwd (K2)", ":221", "attention_bwd"))):
        for D in HW_TIMED:
            heads = GEOMETRY["hidden_size"] // D
            mine = {k: v[kname] for k, v in paths.items()
                    if k.split("_heads")[0].endswith(f"_{heads}")}
            f32_src = (f"{src}{lib}_f32_d128.cuh" if D == 128
                       else f"{src}{lib}_d{D}.cu")
            row = dict(
                name=f"{short} at head width {D}: the mm.yaml model with "
                     f"{heads} heads (B=16, 200 tokens), f32 (3xTF32); bf16 "
                     "beside it", route="cuda",
                source=f32_src, replaces=attn_py + line,
                launches=sum(mine.values()), launches_by_path=mine,
                f32_launches=sum(n for k, n in mine.items()
                                 if k.endswith("float32")),
                bf16=_row(rows[D, bf16][i]), **_row(rows[D, f32][i]))
            if D == 128:
                row["bf16_kernel"] = (
                    "wgmma (rows of two 128-byte swizzle atoms, TMA-fed "
                    "tiles; o over all of D, the halves exchanged): "
                    "attn_fwd_keep_kernel + attn_fwd_wg128_kernel, "
                    f"{src}attention_fwd_bf16_d128.cuh" if kname == "k1" else
                    "wgmma (rows of two 128-byte swizzle atoms, TMA-fed "
                    "tiles; pass B's output products each warpgroup half "
                    "of D): attn_bwd_keep_kernel + attn_bwd_dq_wg128_kernel"
                    " + attn_bwd_dkdv_wg128_kernel, "
                    f"{src}attention_bwd_bf16_d128.cuh")
            else:
                row["bf16_kernel"] = (
                    "wgmma: attn_fwd_wg_kernel (+ attn_fwd_keep_kernel), "
                    f"{src}attention_fwd_bf16.cuh" if kname == "k1" else
                    "wgmma: attn_bwd_*_wg_kernel, "
                    f"{src}attention_bwd_bf16.cuh")
            if kname == "k1" and D == 128:
                row["f32_kernel"] = (
                    "wgmma (3xTF32; chunks of 128 keys, 64 a warpgroup, "
                    "q split in registers, o taken transposed, each "
                    "warpgroup half of D): attn_fwd_keep_kernel + "
                    f"attn_fwd_tf128_kernel, {f32_src}")
                row["library_math_ms"] = rows[D, f32][i]["library_math_ms"]
            elif kname == "k2" and D == 128:
                row["f32_kernel"] = (
                    "wgmma (3xTF32; A operands split in registers, the "
                    "output products transposed, each warpgroup half of "
                    "D): attn_bwd_keep_kernel + attn_bwd_dq_tf128_kernel + "
                    f"attn_bwd_dkdv_tf128_kernel, {f32_src}")
                row["library_math_ms"] = rows[D, f32][i]["library_math_ms"]
            elif kname == "k2":
                row["f32_kernel"] = ("wgmma (3xTF32): attn_bwd_*_tf_kernel, "
                                     f"{src}attention_bwd_f32.cuh")
            else:
                row["f32_kernel"] = (
                    "wgmma (3xTF32; s as the f32 K2 recomputes it, v's "
                    "transposed planes): attn_fwd_keep_kernel + "
                    f"attn_fwd_tf_kernel, {src}attention_fwd_f32.cuh")
            if D == 64:
                row["off_path_widths"] = {}
                for w in HW_WIDTHS:
                    width = att.kernel_head_dim(w)
                    if w in HW_TIMED:
                        continue
                    row["off_path_widths"][str(w)] = dict(
                        source=src + (f"{lib}.cu" if width == 32
                                      else f"{lib}_d{width}.cu"),
                        compiled_width=width, launches=0,
                        max_abs_err={dtype_name(dt): rows[w, dt][i][
                            "max_abs_err"] for dt in DTYPES})
            out.append(row)
    for row in kernels:
        if row["name"].startswith(("layernorm_fwd", "layernorm_bwd")):
            idx = 0 if row["name"].startswith("layernorm_fwd") else 1
            row["widths"] = {
                str(w): dict(
                    rows=HW_LN_ROWS, launches=0,
                    source=src + ("layernorm.cu" if w <= 1024
                                  else "layernorm_wide.cu"),
                    max_abs_err={dtype_name(dt): hw["ln_err"][w, dt][idx]
                                 for dt in DTYPES})
                for w in HW_LN_WIDTHS}
    return out


def head_widths_phase(root: Path, default: str) -> dict:
    """Phase 14 (module docstring). Returns the kernel rows and the launch
    counts of the paths at 4 and 16 heads."""
    t0 = time.perf_counter()
    rows = head_width_kernels()
    rank_kernels_check(D=64, H=2, timed=False)
    rank_kernels_check(D=128, H=1, timed=False)
    ln_err = {}
    for width in HW_LN_WIDTHS:
        for dtype in DTYPES:
            ln_err[width, dtype] = ln_check(HW_LN_ROWS, width, dtype,
                                            phase="head_widths_ln_check")
    paths = {}
    loaders = _train_loaders(n_trials=HW_TRIALS)
    for heads in HW_HEADS:
        for dtype in DTYPES:
            mode = default if dtype == torch.float32 else "full"
            cfg = dataclasses.replace(_cfg(dtype), n_heads=heads)
            tag = f"{heads}_heads_{dtype_name(dtype)}"
            kernel_vs_plain_step(root, dtype, mode, cfg,
                                 phase="head_widths_step")
            paths[f"graph_{tag}"] = dispatch_phase(
                root, dtype, mode, cfg, loaders,
                phase="head_widths_dispatch")
            paths[f"eval_forward_{tag}"] = head_width_eval_forward(
                cfg, dtype, mode)
    paths["train_multi_modal_4_heads_bfloat16"] = head_width_script(root)
    emit(phase="head_widths_wall", wall_s=time.perf_counter() - t0)
    return dict(rows=rows, ln_err=ln_err, paths=paths)


# ---------------------------------------------------------------------------
# phase 15: profile_model (step time, the FLOP count, MFU, a trace)
# ---------------------------------------------------------------------------

PROFILE_STEPS = 20
PROFILE_WANT = dict(k1=30, k2=15, k3=62, k4=32)    # launches a step


def _trace_kernels(trace_dir: Path) -> dict:
    """Kernel records by ``_KERNEL_GROUPS`` (and the lead-in's) in the one
    ``tensorboard_trace_handler`` file under ``trace_dir``."""
    (path,) = trace_dir.glob("*.pt.trace.json")
    counts = dict.fromkeys([g for g, _ in _KERNEL_GROUPS] + ["lead_in"], 0)
    for evt in json.loads(path.read_text())["traceEvents"]:
        if evt.get("cat") != "kernel":
            continue
        name = evt.get("name", "")
        if LEAD_IN_KERNEL in name:
            counts["lead_in"] += 1
        for group, key in _KERNEL_GROUPS:
            if re.search(key, name):
                counts[group] += 1
    return dict(counts, file=str(path), bytes=path.stat().st_size)


def profile_phase(root: Path) -> tuple:
    """Phase 15 (module docstring). Returns the wrappers' launch counts by
    path (the step's three Python runs: the counted step, the eager run
    before the capture, the capture) and the traced replays' by kernel
    name."""
    from multi_modal_foundation_model_tpu_torch.scripts import profile_model
    from multi_modal_foundation_model_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    smi = nvidia_smi()
    counts, graph = {}, {}
    for B in (TRAIN_B, BIG_B):
        tag = f"profile_b{B}_bf16"
        for attempt in range(3):      # a trace that lost records: again
            trace_dir = root / f"chip_smoke_profile_trace_b{B}"
            shutil.rmtree(trace_dir, ignore_errors=True)
            reset_counts()
            rec = profile_model.main(["--batch_size", str(B), "--n_steps",
                                      str(PROFILE_STEPS), "--trace_dir",
                                      str(trace_dir)])
            counts[tag] = read_counts()
            traced = _trace_kernels(trace_dir)
            per_step = {k: traced[k] / 3 for k in PROFILE_WANT}
            if traced["lead_in"] and per_step == PROFILE_WANT:
                break
        with ln_mode("off"):
            plain_step = profile_model.FlagshipStep(B, 668, "cuda",
                                                    attn_impl="xla")
            plain = plain_step.count_flops()
        cfg = plain_step.model.config
        del plain_step
        want = profiling.step_flops(cfg, B, temporal_masks=2)
        graph[f"profile_graph_b{B}_bf16"] = dict(traced, steps=3)
        ok = (rec["flops_per_step"] == plain
              == want["step_flops_with_remat"]
              and 0 < rec["mfu"] < 1 and math.isfinite(rec["loss"])
              and per_step == PROFILE_WANT
              and {k: counts[tag][k] for k in PROFILE_WANT}
              == {k: 3 * v for k, v in PROFILE_WANT.items()}
              and counts[tag]["philox"] > 0
              and traced["k1"] > 0 and traced["k2"] > 0)
        emit(phase="profile", batch=B, dtype="bfloat16", **rec,
             plain_path_flops=plain, analytic_flops=want,
             launches_a_step=per_step, wrapper_launches=counts[tag],
             trace=traced, trace_attempts=attempt + 1, nvidia_smi=smi,
             ok=ok)
        if not ok:
            raise AssertionError(f"profile B={B} failed (see the line)")
        torch.cuda.empty_cache()
    emit(phase="profile_wall", wall_s=time.perf_counter() - t0)
    return counts, graph


# ---------------------------------------------------------------------------
# phase 16: the plots (trainers, harnesses, the mask-ratio sweep)
# ---------------------------------------------------------------------------

SWEEP_RATIOS = ("0.1", "0.3")
# every leg's device and session size (the sweep's too)
PLOTS_ARGS = ["--device", "cuda", "--n_trials", "160"]


def _needs_matplotlib(fn, argv) -> bool:
    """Whether ``fn(argv)`` raised ``ImportError`` naming matplotlib (any
    other exception propagates); False if it ran."""
    try:
        fn(argv)
    except ImportError as err:
        if "matplotlib" not in str(err):
            raise
        return True
    return False


def plots_phase(root: Path) -> dict:
    """Phase 16 (module docstring). Returns the wrappers' launch counts by
    leg."""
    from multi_modal_foundation_model_tpu_torch.scripts import (
        draw_mask_ratio, eval_baseline, eval_multi_modal, train_baseline,
        train_multi_modal)
    from multi_modal_foundation_model_tpu_torch.scripts._common import (
        DEFAULT_EID, log_dir_for)

    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    t0 = time.perf_counter()
    base = root / "chip_smoke_plots"
    shutil.rmtree(base, ignore_errors=True)
    common = ["--synthetic", "--overwrite", "--base_path", str(base),
              *PLOTS_ARGS]
    mm = ["--use_MtM", "--mixed_training"]
    mm_dir = Path(log_dir_for(str(base), DEFAULT_EID,
                              {"input": ["ap", "behavior"],
                               "output": ["ap", "behavior"]},
                              "mask-temporal_ratio-0.1_mixed-True"))
    enc_dir = Path(log_dir_for(str(base), DEFAULT_EID,
                               {"input": ["behavior"], "output": ["ap"]},
                               "linear"))
    plot_epochs = ["--set", "training.save_plot_every_n_epochs=1"]
    # (name, main, argv with plots, argv without, kernels, where figures go)
    legs = [
        ("train_multi_modal", train_multi_modal.main,
         common + mm + ["--num_epochs", "1"] + plot_epochs,
         common + mm + ["--num_epochs", "1"] + NO_EPOCH_PLOTS,
         ("k1", "k2", "k3", "k4", "philox"), mm_dir),
        ("eval_multi_modal", eval_multi_modal.main,
         common + mm + ["--co_smooth", "--save_plot", "--max_plots", "3"],
         common + mm + ["--co_smooth"], ("k1", "k3"),
         mm_dir / "eval" / "per_neuron"),
        ("train_baseline", train_baseline.main,
         common + ["--direction", "encoding", "--num_epochs", "1"]
         + plot_epochs,
         common + ["--direction", "encoding", "--num_epochs", "1"]
         + NO_EPOCH_PLOTS, (), enc_dir),
        ("eval_baseline", eval_baseline.main,
         common + ["--direction", "encoding", "--save_plot", "--max_plots",
                   "3"], common + ["--direction", "encoding"], (),
         enc_dir / "eval" / "modal_spike")]
    counts, failed = {}, []
    for name, main, with_plots, without, need, fig_dir in legs:
        reset_counts()
        t_leg = time.perf_counter()
        raised = _needs_matplotlib(main, with_plots)
        if raised:
            main(without)
        torch.cuda.synchronize()
        counts[f"plots_{name}"] = c = read_counts()
        figures = sorted(p.name for p in fig_dir.glob("*.png"))
        artifacts = (["eval/results.json"] if name.startswith("eval")
                     else ["model_best.pt", "metrics.jsonl"])
        root_dir = mm_dir if "multi_modal" in name else enc_dir
        ok = (all((root_dir / a).exists() for a in artifacts)
              and all(c[k] > 0 for k in need)
              and (bool(figures) if have else raised and not figures))
        emit(phase="plots_leg", leg=name, matplotlib=have,
             raised_import_error=raised, figures=figures[:8],
             n_figures=len(figures), launches=c, launches_required=list(need),
             wall_s=time.perf_counter() - t_leg, ok=ok)
        if not ok:
            failed.append(name)
    # the mask-ratio sweep: the port's launcher over two ratios, one epoch
    launcher = (Path(__file__).resolve().parent
                / "multi_modal_foundation_model_tpu_torch" / "scripts"
                / "launch" / "mask_ratio_sweep.sh")
    env = dict(os.environ, RATIOS=" ".join(SWEEP_RATIOS),
               BASE_PATH=str(base / "sweep"), PYTHON=sys.executable)
    cmd = ["bash", str(launcher), "--synthetic", "--num_epochs", "1",
           "--overwrite", *PLOTS_ARGS, *([] if have else NO_EPOCH_PLOTS)]
    t_sweep = time.perf_counter()
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    out_dir = base / "sweep" / "sweep-synthetic"
    artifacts = all((out_dir / f"ratio-{r}" / mode / f).exists()
                    for r in SWEEP_RATIOS
                    for mode, f in (("modal_behavior", "r2.npy"),
                                    ("modal_spike", "bps.npy")))
    figure = out_dir / "mask_ratio_vs_decoding_r2_encoding_bps.png"
    draw_argv = ["--result_dir", str(out_dir), "--mask_ratios",
                 *SWEEP_RATIOS, "--out", str(base / "drawn.png")]
    draw_raised = _needs_matplotlib(draw_mask_ratio.main, draw_argv)
    if have:
        sweep_ok = run.returncode == 0 and figure.exists() and \
            (base / "drawn.png").exists()
    else:
        # the launcher's last step, the figure, is what fails
        sweep_ok = (run.returncode != 0 and "matplotlib" in run.stderr
                    and draw_raised)
    sweep_ok = sweep_ok and artifacts
    emit(phase="plots_sweep", ratios=list(SWEEP_RATIOS), matplotlib=have,
         returncode=run.returncode, artifacts=artifacts,
         figure=figure.exists(), draw_raised_import_error=draw_raised,
         stderr_tail=run.stderr[-300:], wall_s=time.perf_counter() - t_sweep,
         ok=sweep_ok)
    if not sweep_ok:
        failed.append("mask_ratio_sweep")
    if not have:
        print("plots: render not run, matplotlib not installed", flush=True)
    emit(phase="plots_wall", wall_s=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"plots failed: {failed} (see the lines)")
    return counts


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


def _in_background(fn, *args):
    """Start ``fn(*args)`` in a thread; returns a function that waits for
    it and gives its result or raises its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as err:        # re-raised by the waiter
            box["err"] = err

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return wait


def main() -> int:
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(*sys.argv[2:6])
        return 0
    if sys.argv[1:2] == ["--nccl-worker"]:
        print(json.dumps(nccl_collectives(*map(int, sys.argv[2:5]))))
        return 0
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
    # the libraries of head width 128, which only phase 14 runs and which
    # take the longest to build, build beside the first phases
    late = [n for n in build.kernel_sources() if n.endswith("_d128")]
    late_build = _in_background(build.build, late)
    build_s = build.build([n for n in build.kernel_sources()
                           if n not in late])
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s,
         build_wall_s=time.perf_counter() - t0, building_beside=late,
         tf32=False, layernorm_default=ln.PALLAS_LAYERNORM)

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
    kernel_vs_plain_step(out, f32, "bwd")
    disp_f32 = dispatch_phase(out, f32, default)
    disp_bf16 = dispatch_phase(out, bf16, "full")
    prefetch_check(out)
    philox = philox_check()
    baseline_s = baseline_phase(out)
    entry, entry_s = entry_points_phase(out)
    emit(phase="slice_11_phases_wall", baseline_s=baseline_s,
         entry_points_s=entry_s, total_s=baseline_s + entry_s)
    ms_counts, mixed, ms_entry, _ = multisession_phases(out, default)
    ref_counts = reference_ckpt_phase(out)
    real = real_data_phase(out)
    par = parallel_phase(out)
    emit(phase="device_late_build", build_s=late_build())
    hw = head_widths_phase(out, default)
    prof_counts, prof_graph = profile_phase(out)
    plot_counts = plots_phase(out)
    paths = dict(eval_f32=eval_f32, eval_bf16=eval_bf16,
                 train_f32=train_f32, train_bf16=train_bf16,
                 real_data_bf16=real["counters"], **par["launches"],
                 **prof_counts, **plot_counts)
    par_f32 = tuple(k for k in par["launches"] if k.endswith("float32"))
    par_bf16 = tuple(k for k in par["launches"] if k.endswith("bfloat16"))
    # the graph path's launches, counted by kernel name in a profile of
    # one epoch of replays (the wrappers' counters see only Python calls)
    graph_paths = dict(dispatch_graph_f32=disp_f32,
                       dispatch_graph_bf16=disp_bf16,
                       multisession_graph_f32=ms_counts["f32"],
                       multisession_graph_bf16=ms_counts["bf16"],
                       multisession_mixed_graph_f32=mixed["counts"]["f32"],
                       multisession_mixed_graph_bf16=mixed["counts"]["bf16"],
                       real_data_graph_bf16=real["graph"], **prof_graph)

    def by_path(group, names):
        got = {k: paths[k][group] for k in names if k in paths}
        got.update({k: graph_paths[k][group] for k in names
                    if k in graph_paths})
        return got

    src = "multi_modal_foundation_model_tpu_torch/csrc/"
    attn_py = "multi_modal_foundation_model_tpu/ops/attention.py"
    ln_py = "multi_modal_foundation_model_tpu/ops/layernorm.py"
    kernels = [
        dict(name="attention_fwd (K1, eval: no dropout, no lse), f32: Hopper "
             "wgmma in 3xTF32 (one warpgroup a block over chunks of 104 "
             "keys, two blocks an SM, each k-step from zero then added in "
             "f32, s as the f32 K2 recomputes it; v split into transposed "
             "hi/lo planes; pd as register A fragments), TMA tiles on an "
             "mbarrier: attn_fwd_tf_kernel",
             route="cuda", source=src + "attention_fwd_f32.cuh",
             replaces=attn_py + ":144", launches=eval_f32["k1"],
             **_row(k1[f32])),
        dict(name="attention_fwd (K1, eval), bf16: Hopper wgmma (s one "
             "m64n104k16 wgmma over half the key row a warpgroup, two "
             "warpgroups, a one-sweep softmax; pd as register A fragments "
             "of the pd . v product), TMA tiles on an mbarrier: "
             "attn_fwd_wg_kernel", route="cuda",
             source=src + "attention_fwd_bf16.cuh",
             replaces=attn_py + ":144",
             launches=eval_bf16["k1"], **_row(k1[bf16])),
        dict(name="attention_fwd (K1, training: dropout 0.4, lse), f32: "
             "Hopper wgmma in 3xTF32, TMA tiles, chunks of 104 keys "
             "(attn_fwd_tf_kernel), the keep bits drawn first by "
             "attn_fwd_keep_kernel and read by TMA", route="cuda",
             source=src + "attention_fwd_f32.cuh",
             replaces=attn_py + ":144", launches=train_f32["k1"],
             launches_by_path=by_path("k1", ("train_f32",
                                             "dispatch_graph_f32",
                                             "multisession_graph_f32",
                                             "multisession_mixed_graph_f32",
                                             *par_f32)),
             **_row(k1_train[f32])),
        dict(name="attention_fwd (K1, training: dropout 0.4, lse), bf16: "
             "Hopper wgmma, TMA tiles, one sweep (attn_fwd_wg_kernel), the "
             "keep bits drawn first by attn_fwd_keep_kernel and read by "
             "TMA", route="cuda",
             source=src + "attention_fwd_bf16.cuh",
             replaces=attn_py + ":144",
             launches=train_bf16["k1"],
             launches_by_path=by_path("k1", ("train_bf16",
                                             "dispatch_graph_bf16",
                                             "multisession_graph_bf16",
                                             "multisession_mixed_graph_bf16",
                                             "real_data_bf16",
                                             "real_data_graph_bf16",
                                             *par_bf16, *prof_counts,
                                             *prof_graph,
                                             "plots_train_multi_modal")),
             **_row(k1_train[bf16])),
        dict(name="attention_bwd (K2), f32: Hopper wgmma in 3xTF32 (s and "
             "dP over half the key row a warpgroup, two warpgroups, each "
             "k-step from zero then added in f32; landed tiles split into "
             "hi/lo planes, natural and transposed; ds and pd as register "
             "A fragments), TMA tiles on an mbarrier, keep bits from "
             "attn_bwd_keep_kernel: attn_bwd_dq_tf_kernel + "
             "attn_bwd_dkdv_tf_kernel", route="cuda",
             source=src + "attention_bwd_f32.cuh", replaces=attn_py + ":221",
             launches=train_f32["k2"],
             launches_by_path=by_path("k2", ("train_f32",
                                             "dispatch_graph_f32",
                                             "multisession_graph_f32",
                                             "multisession_mixed_graph_f32",
                                             *par_f32)),
             library_math_ms=k2[f32]["library_math_ms"],
             **_row(k2[f32])),
        dict(name="attention_bwd (K2), bf16: Hopper wgmma (s and dP one "
             "m64n104k16 wgmma each over half the key row a warpgroup, two "
             "warpgroups; ds and pd as register A fragments of the dq, dk, "
             "dv products), TMA tiles on an mbarrier, one sweep: "
             "attn_bwd_dq_wg_kernel + attn_bwd_dkdv_wg_kernel", route="cuda",
             source=src + "attention_bwd_bf16.cuh",
             replaces=attn_py + ":221",
             launches=train_bf16["k2"],
             launches_by_path=by_path("k2", ("train_bf16",
                                             "dispatch_graph_bf16",
                                             "multisession_graph_bf16",
                                             "multisession_mixed_graph_bf16",
                                             "real_data_bf16",
                                             "real_data_graph_bf16",
                                             *par_bf16, *prof_counts,
                                             *prof_graph,
                                             "plots_train_multi_modal")),
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
             uniform=philox["uniform"],
             launch_floor_ms=philox["u8"]["launch_floor_ms"],
             **_row(philox["u8"])),
        dict(name="session_rows_grad: the fixed-order backward of the "
             "session-mixed step's per-sample gathers of the stitched "
             "stacks, f32 sums in sample order, at 16 x 1024 x 512 f32 "
             "(the tokenizer kernel's gradient at B=16)", route="cuda",
             source=src + "session_rows.cu",
             replaces="multi_modal_foundation_model_tpu/models/layers.py"
             ":651-658 (no Pallas source: XLA's scatter-add, the transpose "
             "of jnp.take)",
             launches=mixed["wrapper_counts"]["session_rows"],
             launches_by_path=by_path("session_rows", tuple(graph_paths)),
             bf16=_row(mixed["rows"][bf16]),
             **_row(mixed["rows"][f32])),
    ]
    # the MultiModal entry scripts' launches (the multi-session ones too),
    # on the rows of what they ran:
    # mm.yaml's bf16 (entry_points_phase checks it), the training K1 (with
    # lse) apart from the eval K1. Counters, so the graph replays of the
    # resident training script are not in them: its first eager step and
    # capture are. The f32 rows get none: the scripts ran no f32 kernel.
    by_kind = {
        "eval_k1": lambda c: c["k1"] - c["k1_lse"],
        "train_k1": lambda c: c["k1_lse"],
        **{k: (lambda c, k=k: c[k])
           for k in ("k2", "k3", "k4", "philox", "session_rows")}}
    for row, kind in zip(kernels, (None, "eval_k1", None, "train_k1", None,
                                   "k2", "k3", "k4", "philox",
                                   "session_rows"),
                          strict=True):
        if kind is not None:
            row["launches_by_entry_point"] = {
                name: by_kind[kind](c)
                for name, c in {**entry, **ms_entry,
                            "reference_ckpt_eval_multi_modal":
                                ref_counts}.items()
                if name.endswith(("multi_modal", "multi_session"))}
    # the session-rows kernel at a dp 2 x tp 2 rank's shape, its launches
    # on the multi-session layouts' ranks 0
    ms_par = tuple(k for k in par["launches"]
                   if k.startswith("parallel_multisession"))
    rows_rank = par["session_rows_rank"]
    kernels.append(dict(
        name="session_rows_grad at a data- and tensor-parallel rank's "
             "shape of the multi-session mesh phase (8 of 16 samples under "
             "dp=2, the stitched tokenizer kernel's 1024 x 256 columns of "
             "512 under tp=2, 5 sessions), f32; bf16 beside it",
        route="cuda", source=src + "session_rows.cu",
        replaces="multi_modal_foundation_model_tpu/models/layers.py"
        ":651-658 (no Pallas source: XLA's scatter-add, the transpose of "
        "jnp.take; per shard under the model axis)",
        launches=sum(paths[k]["session_rows"] for k in ms_par),
        launches_by_path={k: paths[k]["session_rows"] for k in ms_par},
        bf16=_row(rows_rank[bf16]), **_row(rows_rank[f32])))
    # K1 and K2 at a tensor-parallel rank's shape (tp=2: 4 heads), their
    # launches on the tp > 1 layouts' ranks 0 (three steps a layout)
    tp_paths = tuple(k for k in par["launches"] if "_tp1_" not in k)
    rank_rows = par["rank_rows"]
    for i, (kname, short, line, cu, wg) in enumerate((
            ("k1", "attention_fwd (K1)", ":144", "attention_fwd_f32.cuh",
             "attention_fwd_bf16.cuh"),
            ("k2", "attention_bwd (K2)", ":221", "attention_bwd_f32.cuh",
             "attention_bwd_bf16.cuh"))):
        kernels.append(dict(
            name=f"{short} at a tensor-parallel rank's shape under tp=2 "
                 "(B=8 of 16 under dp=2, 200 tokens, 4 heads of 32: 128 "
                 "columns of the rank's fused q/k/v product), draw offsets "
                 "(8, 4), f32 (3xTF32); bf16 beside it",
            route="cuda", source=src + cu,
            replaces=attn_py + f"{line} (per shard under _flash_mha_tp, "
                     ":528-555)",
            launches=sum(paths[k][kname] for k in tp_paths),
            launches_by_path={k: paths[k][kname] for k in tp_paths},
            bf16_kernel=f"wgmma: {src}{wg}",
            bf16=_row(rank_rows[bf16][i]), **_row(rank_rows[f32][i])))
    kernels += head_width_rows(hw, src, attn_py, ln_py, kernels)
    from multi_modal_foundation_model_tpu_torch.utils.profiling import (
        LEAD_IN)

    emit(phase="profiler_lead_in", traces=len(TRACE_LOSSES),
         lead_in=LEAD_IN, lost_by_trace=TRACE_LOSSES)
    if any(k["launches"] == 0 or k.get("f32_launches", 1) == 0
           for k in kernels):
        raise AssertionError("a kernel of the main paths never launched")
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
