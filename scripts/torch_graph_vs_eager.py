#!/usr/bin/env python3
"""Where a captured training step's numbers part from the eager step's.

    python3 scripts/torch_graph_vs_eager.py [--full] [--dtype bfloat16]

On one card: one training forward of the port's model (toy geometry, or
the full width with ``--full``), dropout 0.4, MtM ``temporal`` scheme,
the same batch and seed table, run four ways: eagerly on the current
stream, again there, eagerly on a side stream, and as a CUDA graph
captured on that side stream and replayed. Forward hooks keep every
module's output; the script prints, for each pair of runs, how many
module outputs differ and the first that does (module order), with the
largest difference. A second table does the same for every Linear of the
model alone (``F.linear`` on the recorded input), which separates cuBLAS
from the port's kernels. One JSON line per comparison.

    python3 scripts/torch_graph_vs_eager.py --trainer

compares the trainer's first step on the host-batch path (eager, current
stream) with its first step on the resident path (eager on a side stream,
then captured): the batch, the step's input row and every module output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--trainer", action="store_true")
    args = ap.parse_args()
    if args.trainer:
        return trainer_first_steps()
    from multi_modal_foundation_model_tpu_torch.data import (make_loader,
                                                             synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.models import (
        MultiModal, MultiModalConfig)
    from multi_modal_foundation_model_tpu_torch.ops.masking import RegionSets

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.full:
        geom = dict(n_channels={"ap": 668, "behavior": 2}, max_F=100,
                    hidden_size=256, n_heads=8, n_enc_layers=5,
                    n_dec_layers=5, inter_size=512)
    else:
        geom = dict(n_channels={"ap": 24, "behavior": 2}, max_F=20,
                    hidden_size=64, n_heads=2, n_enc_layers=2,
                    n_dec_layers=2, inter_size=128)
    cfg = MultiModalConfig(**geom, dropout=0.4, embed_dropout=0.2,
                           compute_dtype=args.dtype)
    model = MultiModal(cfg, generator=torch.Generator().manual_seed(0))
    N, T = geom["n_channels"]["ap"], geom["max_F"]
    split = synthetic_splits(seed=0, n_trials=64, n_neurons=N,
                             n_timesteps=T).train
    loader = make_loader(split, batch_size=16, shuffle=False,
                         max_time_length=T, max_space_length=N)
    host = next(iter(loader))
    arrays = loader.arrays
    regions = RegionSets.build(arrays["region_ids"], device="cuda",
                               region_vocab=arrays["region_vocab"])
    from multi_modal_foundation_model_tpu_torch.models.multimodal import (
        ModalityInput)

    batch = {k: torch.as_tensor(host[k]).cuda() for k in
             ("spikes_data", "target", "time_attn_mask", "spikes_timestamps")}
    inputs = {m: ModalityInput(inputs=x, targets=x,
                               attn_mask=batch["time_attn_mask"],
                               timestamps=batch["spikes_timestamps"])
              for m, x in (("ap", batch["spikes_data"]),
                           ("behavior", batch["target"]))}
    plan = model.mask_plan([False, False], 0, ("temporal",), regions, True)
    seeds = model.step_seeds(7, plan, regions, "cuda")

    names = {m: n for n, m in model.named_modules()}
    record: dict = {}
    linear_in: dict = {}

    def hook(mod, inp, out):
        if isinstance(out, torch.Tensor):
            record[names[mod]] = out.detach().clone()
        if isinstance(mod, torch.nn.Linear):
            linear_in[names[mod]] = inp[0].detach().clone()

    for m in model.modules():
        m.register_forward_hook(hook)

    def forward():
        record.clear()
        linear_in.clear()
        out = model(inputs, masking_mode=0, mtm_modes=("temporal",),
                    regions=regions, training=True, seed=seeds)
        record["loss"] = out.loss.detach().clone()
        return dict(record), dict(linear_in)

    runs = {}
    runs["current"] = forward()
    runs["current_again"] = forward()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs["side"] = forward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = forward()
    graph.replay()
    torch.cuda.synchronize()
    runs["graph"] = captured

    order = list(runs["current"][0])
    for a, b in (("current", "current_again"), ("current", "side"),
                 ("side", "graph"), ("current", "graph")):
        ra, rb = runs[a][0], runs[b][0]
        diff = [n for n in order if not torch.equal(ra[n], rb[n])]
        first = diff[0] if diff else None
        print(json.dumps(dict(
            table="module_outputs", a=a, b=b, n_modules=len(order),
            n_differ=len(diff), first_differing=first,
            first_max_abs=((ra[first].float() - rb[first].float()).abs()
                           .max().item() if first else 0.0),
            loss_a=ra["loss"].item(), loss_b=rb["loss"].item())),
            flush=True)

    # each Linear alone on the current stream's recorded input
    lin = {n: m for n, m in model.named_modules()
           if isinstance(m, torch.nn.Linear)}
    ins = runs["current"][1]
    for name, x in ins.items():
        m = lin[name]
        dt = getattr(m, "compute_dtype", None) or x.dtype

        def f():
            return F.linear(x.to(dt), m.weight.to(dt),
                            None if m.bias is None else m.bias.to(dt))

        y0 = f()
        with torch.cuda.stream(side):
            y1 = f()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            y2 = f()
        g.replay()
        torch.cuda.synchronize()
        print(json.dumps(dict(
            table="linear_alone", module=name, shape=list(x.shape),
            out_features=m.out_features, dtype=str(dt),
            side_equal=torch.equal(y0, y1), graph_equal=torch.equal(y0, y2),
            graph_max_abs=(y0.float() - y2.float()).abs().max().item())),
            flush=True)
    print(np.__version__, torch.cuda.get_device_name(0))
    return 0


def trainer_first_steps() -> int:
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_kernels import _toy_trainer

    out, kernels = {}, {}
    for name, over in (("host", {}),
                       ("resident", dict(device_resident_data=True,
                                         steps_per_dispatch=2))):
        tr = _toy_trainer(Path("build") / f"graph_vs_eager_{name}", "cuda",
                          **over)
        names = {m: n for n, m in tr.model.named_modules()}
        rec: dict = {}

        def hook(mod, inp, o, rec=rec, names=names):
            if isinstance(o, torch.Tensor) and names[mod] not in rec:
                rec[names[mod]] = o.detach().clone()
                for i, x in enumerate(inp):
                    if isinstance(x, torch.Tensor):
                        rec[f"{names[mod]}.in{i}"] = x.detach().clone()

        handles = [m.register_forward_hook(hook)
                   for m in tr.model.modules()]
        loader = tr.train_dataloader
        loader.set_epoch(0)
        tr._reseed_host_rng(0)
        idx, valid, _ = next(loader.iter_index_batches())
        mode, scheme = tr._sample_modes()
        import chip_smoke as cs

        if name == "host":
            loader.set_epoch(0)
            batch = tr._device_batch(next(iter(loader)))
        else:
            data = tr._device_data(loader)
        # traced: a plain torch.profiler trace can lose its first kernels
        with cs.traced() as prof:
            if name == "host":
                loss = tr.train_step(batch, mode, scheme)
            else:
                loss = tr._dispatch(data, [(idx, valid, scheme)], mode)[0]
        kernels[name] = [e.name for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and cs.LEAD_IN_KERNEL not in e.name),
            key=lambda e: e.time_range.start)]
        for h in handles:
            h.remove()
        layout, buf = tr._step_buffers(16)
        rec["row"] = buf.rows[0].clone()
        rec["loss"] = loss.detach().reshape(()).clone()
        out[name] = rec
    a, b = out["host"], out["resident"]
    keys = [k for k in a if k in b]
    diff = [k for k in keys
            if a[k].shape != b[k].shape or not torch.equal(a[k], b[k])]
    print(json.dumps(dict(table="trainer_first_step", n_compared=len(keys),
                          n_differ=len(diff), differ=diff[:12],
                          loss_host=a["loss"].item(),
                          loss_resident=b["loss"].item())), flush=True)
    ka, kb = kernels["host"], kernels["resident"]
    at = next((i for i, (x, y) in enumerate(zip(ka, kb)) if x != y), None)
    print(json.dumps(dict(
        table="trainer_first_step_kernels", n_host=len(ka),
        n_resident=len(kb), first_differing_position=at,
        host=ka[at - 1:at + 3] if at is not None else None,
        resident=kb[at - 1:at + 3] if at is not None else None,
        gemm_kernels_host=sorted({k[:80] for k in ka if "gemm" in k.lower()
                                  or "sm90" in k or "nvjet" in k}),
        gemm_kernels_resident=sorted({k[:80] for k in kb
                                      if "gemm" in k.lower() or "sm90" in k
                                      or "nvjet" in k}))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
