"""Profiling: torch.profiler traces, step timing, MFU accounting.

Port of ``multi_modal_foundation_model_tpu/utils/profiling.py``:

- :func:`chip_peak_flops` — one peak dense rate a device, by its name;
- :func:`trace_context` — a ``torch.profiler`` trace of the body, CPU and
  CUDA, written as ``tensorboard_trace_handler`` JSON (TensorBoard's
  profiler plugin and ``chrome://tracing`` read it);
- :class:`StepTimer` — wall-clock step timing with warm-up exclusion;
- :class:`MFUTracker` — model-FLOPs utilisation. JAX reads XLA's cost
  analysis of the compiled step; here ``MFUTracker.flops_of`` runs the
  step once eagerly under ``torch.utils.flop_counter.FlopCounterMode``
  (a CUDA-graph replay dispatches nothing, so it counts nothing);
- :func:`step_flops` — the same count from the model's shapes.

The count is the model's products: every GEMM the step runs, and the
attention's two products forward and four backward
(``ops/attention.py``: K1 and K2 count the same as their plain versions,
not the backward's recompute of the scores, and at the model's head
width, not a padded one). The backward is twice the forward, less the
input gradient of each tokenizer's first GEMM (the data needs none).
Remat's recompute of the layers is counted, as it runs (and as XLA counts
it in JAX); elementwise work, norms and the optimizer are not.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

# peak dense product rate of one device, FLOP/s: one number a chip, read
# against every step whatever its dtype, as JAX reads its chips
CHIP_PEAK_FLOPS = {
    "nvidia h100 80gb hbm3": 989.4e12,   # H100 SXM, dense bf16 (NVIDIA)
    "cpu": 1e11,                         # nominal, keeps MFU finite in tests
}

# torch.profiler loses the first device records of a trace, more the
# longer the process has run (on an H100 80GB HBM3 with torch 2.11: none
# of 20 short kernels at 3 s, up to 19 at 255 s; a count of records, not
# a span of time). A trace therefore opens with LEAD_IN spin kernels
# (``torch.cuda._sleep``'s ``spin_kernel``) of about 10 us each, which take
# that loss.
LEAD_IN = 256
LEAD_IN_CYCLES = 20_000


def chip_peak_flops(device=None) -> float:
    """The peak of ``device``: a CUDA device's is the entry whose key is
    in its ``torch.cuda.get_device_name``; a CPU device, no device and an
    unknown card read the CPU entry, as JAX's unknown chips do."""
    if device is None or torch.device(device).type != "cuda":
        return CHIP_PEAK_FLOPS["cpu"]
    kind = torch.cuda.get_device_name(device).lower()
    for key, peak in CHIP_PEAK_FLOPS.items():
        if key in kind:
            return peak
    return CHIP_PEAK_FLOPS["cpu"]


def profiler_lead_in() -> None:
    """The lead-in on the current stream, then a synchronize."""
    for _ in range(LEAD_IN):
        torch.cuda._sleep(LEAD_IN_CYCLES)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace_context(log_dir: str):
    """``with trace_context('trace'): ...`` -> a trace of the body in
    ``log_dir`` (``<worker>.<time>.pt.trace.json``); on a card the trace
    opens with the lead-in and ends after a synchronize."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        if cuda:
            profiler_lead_in()
        yield prof
        if cuda:
            torch.cuda.synchronize()


class StepTimer:
    """Accumulates per-step wall times; first ``warmup`` steps excluded.
    The caller synchronizes inside the ``with`` (JAX's blocks on the
    loss)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean_step_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def steps_per_sec(self) -> float:
        m = self.mean_step_s
        return 1.0 / m if m else 0.0


class MFUTracker:
    """MFU = (FLOPs of a step) / (step time x peak x devices).

    ``flops_or_count``: the step's FLOPs, e.g. ``MFUTracker.flops_of`` of
    one run of it. ``peak_flops`` defaults to ``chip_peak_flops()``, the
    CPU entry: a caller on the card passes its device's.
    """

    def __init__(self, flops_or_count, n_devices: int = 1,
                 peak_flops: Optional[float] = None):
        self.flops_per_step = float(flops_or_count)
        self.n_devices = n_devices
        self.peak = (peak_flops if peak_flops is not None
                     else chip_peak_flops())

    def mfu(self, step_time_s: float) -> float:
        if step_time_s <= 0:
            return 0.0
        return self.flops_per_step / (step_time_s * self.peak
                                      * self.n_devices)

    @staticmethod
    def flops_of(fn, *args, **kwargs) -> float:
        """FLOPs of one eager call ``fn(*args, **kwargs)``, counted by
        ``FlopCounterMode`` (the call runs, with its side effects)."""
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        return float(counter.get_total_flops())


def step_flops(cfg, batch: int, temporal_masks: int = 0) -> dict:
    """The count of the module docstring from the shapes of a
    single-session ``MultiModalConfig`` at batch ``batch``:
    ``forward_flops`` (an eval forward), ``step_flops`` (forward and
    backward) and ``step_flops_with_remat`` (and the layers' forward
    again). ``temporal_masks``: the modalities whose masker draws a
    temporal mask this step (its dilation is a (B, T) x (T, T) product,
    forward only)."""
    if getattr(cfg, "n_sessions", 1) != 1:
        raise ValueError("step_flops counts the single-session model")
    H, T, I, B = cfg.hidden_size, cfg.max_F, cfg.inter_size, batch
    M = len(cfg.avail_mod)
    tokens = B * T * M
    chans = [cfg.n_channels[m] for m in cfg.avail_mod]
    # encoder and decoder tokenizers: Dense(C -> C mult), Dense(-> H)
    tok_in = sum(2 * 2 * B * T * c * c * cfg.mult for c in chans)
    tok = tok_in + sum(2 * 2 * B * T * c * cfg.mult * H for c in chans)
    attn_proj = 2 * tokens * 4 * H * H                 # qkv + out
    cross_proj = 2 * tokens * 4 * H * H                # q, kv, out
    mlp = 2 * tokens * 2 * H * I
    attn = 4 * B * (M * T) ** 2 * H                    # two products
    enc = cfg.n_enc_layers * (attn_proj + mlp + attn)
    dec = cfg.n_dec_layers * (attn_proj + cross_proj + mlp + 2 * attn)
    context = 2 * tokens * H * H
    heads = sum(2 * B * T * H * c for c in chans)
    masker = temporal_masks * 2 * B * T * T
    fwd = tok + enc + dec + context + heads
    step = 3 * fwd - tok_in + masker
    return dict(forward_flops=fwd + masker, step_flops=step,
                step_flops_with_remat=step + enc + dec)
