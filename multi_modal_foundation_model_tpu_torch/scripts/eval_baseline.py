"""Evaluate a trained linear baseline checkpoint.

    python -m multi_modal_foundation_model_tpu_torch.scripts.eval_baseline \\
        --synthetic --direction encoding [--device cpu]

The port of the JAX package's ``scripts/eval_baseline.py``: the mode the
baseline supports (``modal_spike`` for an encoder, ``modal_behavior`` for
a decoder) over the full test split, ``bps.npy``/``r2.npy`` under
``<model_dir>/eval/<mode>/`` and the metrics in
``<model_dir>/eval/results.json``. The model is rebuilt from
``baseline_config.json`` and the port's checkpoint (``model_<name>.pt``).
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.loader import make_loader
from ..data.session import DEFAULT_TARGETS
from ..eval.baseline_harness import co_smoothing_eval_baseline
from ..models.baseline import BaselineDecoder, BaselineEncoder
from ..train import restore_checkpoint
from ..utils.device import resolve_device
from ._common import (add_common_args, get_session, log_dir_for,
                      warn_unsupported)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    ap.add_argument("--direction", choices=["encoding", "decoding"],
                    default="decoding")
    ap.add_argument("--model_dir", type=str, default=None)
    ap.add_argument("--checkpoint", type=str, default="best")
    ap.add_argument("--n_time_steps", type=int, default=100)
    ap.add_argument("--save_plot", action="store_true",
                    help="per-neuron diagnostic figures (modal_spike; "
                         "needs matplotlib)")
    ap.add_argument("--max_plots", type=int, default=20,
                    help="figures at most with --save_plot")
    args = ap.parse_args(argv)
    warn_unsupported(args, "dp", "tp", "device_resident")
    device = resolve_device(args.device)
    splits = get_session(args)

    if args.direction == "encoding":
        modal_filter = {"input": ["behavior"], "output": ["ap"]}
    else:
        modal_filter = {"input": ["ap"], "output": ["behavior"]}
    model_dir = args.model_dir or log_dir_for(
        args.base_path, args.eid, modal_filter, "linear")

    with open(os.path.join(model_dir, "baseline_config.json")) as f:
        bcfg = json.load(f)
    if bcfg["direction"] == "encoding":
        model = BaselineEncoder(in_channel=bcfg["n_behaviors"],
                                out_channel=bcfg["n_neurons"],
                                seq_len=bcfg["seq_len"], device=device)
    else:
        model = BaselineDecoder(in_channel=bcfg["n_neurons"],
                                out_channel=bcfg["n_behaviors"],
                                device=device)
    model.load_state_dict(restore_checkpoint(
        model_dir, args.checkpoint, map_location=device)["model"])

    T = args.n_time_steps
    test_loader = make_loader(
        splits.test, batch_size=splits.test.n_trials,
        target=list(DEFAULT_TARGETS), max_time_length=T,
        max_space_length=splits.n_neurons, shuffle=False, seed=args.seed)

    mode = "modal_spike" if "ap" in modal_filter["output"] else "modal_behavior"
    res = co_smoothing_eval_baseline(
        model, test_loader, mode,
        modal_filter=modal_filter,
        save_path=os.path.join(model_dir, "eval", mode),
        held_out_list=list(range(T)),
        avail_beh=list(DEFAULT_TARGETS), n_time_steps=T,
        save_plot=args.save_plot, max_plots=args.max_plots)
    print(json.dumps(res, indent=1, default=float))
    with open(os.path.join(model_dir, "eval", "results.json"), "w") as f:
        json.dump(res, f, indent=1, default=float)
    return res


if __name__ == "__main__":
    main()
