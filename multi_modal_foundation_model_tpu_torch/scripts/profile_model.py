"""Profile the flagship training step: step time, seq/s, MFU, a trace.

    python -m multi_modal_foundation_model_tpu_torch.scripts.profile_model \\
        [--batch_size 16] [--n_neurons 668] [--n_steps 30] \\
        [--trace_dir DIR] [--device cuda]

The port of the JAX package's ``scripts/profile_model.py``: the flagship
model (``_flagship``: bf16, ``MaskParams(ratio=0.3)``, the default
geometry, random weights from seed 0) on one fixed batch
(``_example_batch``, the same numpy draws), trained step by step: the
training forward, the loss's backward and AdamW from ``OptimizerConfig()``
over a 10,000-step schedule, each step's random draws keyed by the step
number folded into seed 0. It prints one JSON line with JAX's keys:
``step_time_ms``, ``seq_per_sec``, ``flops_per_step``, ``chip_peak_flops``,
``mfu`` and ``loss``.

The step runs as the trainer's graph path runs it (``train/cuda_graph.py``:
its inputs in a device row, one CUDA graph of the step replayed each
step), the port's fastest form of JAX's compiled step on one card; on
the CPU it runs eagerly. Step 0 runs eagerly under
``MFUTracker.flops_of`` (a replay dispatches nothing to count), then 3
warm-up steps (the first one captures the graph) and ``--n_steps`` timed
ones, each ending in a synchronize, as JAX's end in
``block_until_ready``; ``--trace_dir`` traces 3 more (``trace_context``),
which the timer also reads, as JAX's does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.multimodal import (ModalityInput, MultiModal,
                                 MultiModalConfig, StepSeeds)
from ..ops.masking import MaskParams, n_draws
from ..train.cuda_graph import StepGraphs, StepInputs
from ..train.schedule import Optimizer, OptimizerConfig
from ..train.trainer import _RowLayout
from ..utils.device import resolve_device
from ..utils.profiling import (MFUTracker, StepTimer, chip_peak_flops,
                               trace_context)
from ..utils.rng import fold_in
from ._common import warn_unsupported


def _flagship(n_neurons: int = 668, max_F: int = 100, device=None,
              **overrides) -> MultiModal:
    """The JAX package's ``__graft_entry__._flagship``: the reference
    geometry at bf16 with the masker at ratio 0.3."""
    kw = dict(n_channels={"ap": n_neurons, "behavior": 2}, max_F=max_F,
              mask_params=MaskParams(ratio=0.3), compute_dtype="bfloat16",
              attn_impl="pallas")
    kw.update(overrides)
    return MultiModal(MultiModalConfig(**kw), device=device,
                      generator=torch.Generator().manual_seed(0))


def _example_batch(rng: np.random.Generator, batch_size: int, max_F: int,
                   n_neurons: int):
    """The JAX package's ``__graft_entry__._example_batch``: the same
    draws in the same order."""
    spikes = rng.poisson(0.3, (batch_size, max_F, n_neurons)).astype(
        "float32")
    behavior = rng.normal(size=(batch_size, max_F, 2)).astype("float32")
    attn = np.ones((batch_size, max_F), dtype="int64")
    ts = np.tile(np.arange(max_F, dtype="int64"), (batch_size, 1))
    return spikes, behavior, attn, ts


class FlagshipStep:
    """JAX's profiled training step on the port, at ``batch_size`` and
    ``n_neurons`` on ``device`` (``overrides`` go to ``_flagship``): the
    model, its fixed batch, AdamW, and the step's row buffer and graph.
    ``count_flops()`` runs the next step eagerly under
    ``MFUTracker.flops_of``; calling it runs the next step (a graph replay
    on the card; the first call runs it eagerly and captures it) and
    synchronizes."""

    def __init__(self, batch_size: int, n_neurons: int, device,
                 **overrides):
        self.device = torch.device(device)
        B, T, N = batch_size, 100, n_neurons
        self.model = _flagship(n_neurons=N, max_F=T, device=self.device,
                               **overrides)
        arrays = _example_batch(np.random.default_rng(0), B, T, N)
        spikes, behavior, attn, ts = (torch.from_numpy(a).to(self.device)
                                      for a in arrays)
        self.inputs = {mod: ModalityInput(inputs=x, targets=x,
                                          attn_mask=attn, timestamps=ts,
                                          eval_mask=None)
                       for mod, x in (("ap", spikes), ("behavior", behavior))}
        self.opt = Optimizer(self.model.parameters(), OptimizerConfig(),
                             10_000)
        self.plan = self.model.mask_plan([False, False], training=True)
        mc = self.model.config
        self.layout = _RowLayout(len(self.model.seed_paths),
                                 len(mc.avail_mod), n_draws(mc.mask_params),
                                 B)
        self.buf = StepInputs(1, self.layout.width, self.device)
        self.graphs = StepGraphs(self.device)

    def _body(self):
        table, hyper, draws, *_ = self.layout.views(self.buf.current_row())
        out = self.model(self.inputs, training=True,
                         seed=StepSeeds(table, draws))
        grads = torch.autograd.grad(out.loss, self.opt.params,
                                    allow_unused=True)
        self.opt.apply(hyper, True, grads)
        self.buf.finish_step(out.loss)

    def _upload(self):
        """The next step's row: its seed table and masker draws (the step
        number folded into seed 0) and the optimizer's scalars."""
        table, draws = self.model.host_seeds(fold_in(0, self.opt.count),
                                             self.plan)
        self.buf.upload(self.layout.pack(table, self.opt.host_hyper(),
                                         draws)[None])
        self.opt.advance()

    def count_flops(self) -> float:
        self._upload()
        return MFUTracker.flops_of(self._body)

    def __call__(self) -> None:
        self._upload()
        self.graphs.run("step", self._body)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def loss(self) -> float:
        """The last step's loss."""
        return float(self.buf.losses[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--n_neurons", type=int, default=668)
    ap.add_argument("--n_steps", type=int, default=30)
    ap.add_argument("--trace_dir", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "card) or cpu")
    ap.add_argument("--dp", type=int, default=-1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device_resident", action="store_true")
    args = ap.parse_args(argv)
    warn_unsupported(args, "dp", "tp", "device_resident")

    device = resolve_device(args.device)
    B = args.batch_size
    step = FlagshipStep(B, args.n_neurons, device)
    mfu = MFUTracker(step.count_flops(),
                     peak_flops=chip_peak_flops(device))
    timer = StepTimer(warmup=3)

    def run(n):
        for _ in range(n):
            with timer:
                step()

    run(3 + args.n_steps)
    if args.trace_dir:
        with trace_context(args.trace_dir):
            run(3)

    step_s = timer.mean_step_s
    record = {
        "step_time_ms": round(step_s * 1e3, 3),
        "seq_per_sec": round(B / step_s, 1),
        "flops_per_step": mfu.flops_per_step,
        "chip_peak_flops": mfu.peak,
        "mfu": round(mfu.mfu(step_s), 4),
        "loss": step.loss,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
