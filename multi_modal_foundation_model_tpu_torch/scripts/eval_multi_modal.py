"""Evaluate a trained MultiModal checkpoint.

    python -m multi_modal_foundation_model_tpu_torch.scripts.eval_multi_modal \\
        --synthetic --use_MtM --mixed_training --co_smooth --forward_pred \\
        --inter_region --intra_region [--device cpu]
    python -m multi_modal_foundation_model_tpu_torch.scripts.eval_multi_modal \\
        --synthetic --multi_session --model_dir DIR --co_smooth ...
    python -m multi_modal_foundation_model_tpu_torch.scripts.eval_multi_modal \\
        --synthetic --reference_ckpt model_best.pt [--reference_src SRC] ...

The port of the JAX package's ``scripts/eval_multi_modal.py``:
``modal_spike`` and ``modal_behavior`` by default, the other co-smoothing
modes by flag, ``bps.npy``/``r2.npy`` per mode under
``<model_dir>/eval/<mode>/`` (``eval_unaligned`` with ``--unaligned``) and
the metrics in ``results.json`` there. ``--multi_session`` evaluates a
session-stitched checkpoint (``train_multi_session``): every mode once per
trained session, artifacts under ``<model_dir>/eval/<eid>/<mode>/`` and
``results.json`` keyed by eid with the mean over sessions; the sessions
come from the checkpoint's ``sessions.json``, regenerated with the train
script's synthetic convention (``--synthetic``) or loaded from the hub by
eid. Without ``--synthetic`` the session is the IBL session ``--eid``
(``<eid>_unaligned`` with ``--unaligned``), loaded through
``load_ibl_session`` (``datasets`` and the hub or a warm cache).
``--reference_ckpt`` evaluates a checkpoint the PyTorch reference trained
(``load_reference_checkpoint``) on the session's test split, artifacts
under ``<base_path>/reference_ckpt_eval`` unless ``--model_dir`` is given.
``--save_plot`` also saves the per-neuron figures of the co-smoothing
modes (``--max_plots`` a mode, 20 by default) beside each mode's
artifacts; it needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.loader import make_loader
from ..data.session import (DEFAULT_TARGETS, load_ibl_session,
                             synthetic_splits)
from ..eval import (co_smoothing_eval, load_model_data_local,
                    load_multisession_model_data_local,
                    load_reference_checkpoint)
from ..utils.device import resolve_device
from ._common import (add_common_args, get_session, log_dir_for,
                      warn_unsupported)


def build_modes(args, T):
    """The eval modes the flags ask for (modal_spike and modal_behavior
    on by default, the co-smoothing modes opt-in)."""
    modes = []
    if args.co_smooth:
        modes.append(("per_neuron", {}))
    if args.forward_pred:
        modes.append(("forward_pred",
                      {"held_out_list": list(range(int(0.7 * T), T))}))
    if args.inter_region:
        modes.append(("inter_region", {}))
    if args.intra_region:
        modes.append(("intra_region", {}))
    if not args.no_modal_spike:
        modes.append(("modal_spike", {"held_out_list": list(range(T))}))
    if not args.no_modal_behavior:
        modes.append(("modal_behavior", {"held_out_list": list(range(T))}))
    return modes


def eval_multi_session(args, device):
    """Every mode over every session of a stitched checkpoint (JAX
    :43-140). Synthetic sessions are regenerated as the train script made
    them: seed ``--seed + g`` for the eid's generation suffix ``-g``; real
    sessions are loaded from the hub by eid (aligned, as JAX :75 loads
    them)."""
    with open(os.path.join(args.model_dir, "sessions.json")) as f:
        meta = json.load(f)
    test_sessions = {}
    for i, eid in enumerate(meta["eids"]):
        if not args.synthetic:
            test_sessions[eid] = load_ibl_session(eid).test
            continue
        # meta["eids"] is sorted ("x-10" < "x-2"): the suffix, not the
        # position, is the generation index
        gen = eid.rsplit("-", 1)[-1]
        g = int(gen) if gen.isdigit() else i
        test_sessions[eid] = synthetic_splits(
            seed=args.seed + g, n_trials=args.n_trials,
            n_neurons=int(meta["num_neurons"][i]), eid=eid).test

    model, loaders, eid_to_sid = load_multisession_model_data_local(
        model_dir=args.model_dir, test_sessions=test_sessions,
        checkpoint_name=args.checkpoint, max_time_length=args.n_time_steps,
        seed=args.seed, device=device)
    T = args.n_time_steps
    results = {}
    for eid, loader in loaders.items():
        per_eid = {}
        for mode, kw in build_modes(args, T):
            res = co_smoothing_eval(
                model, loader, mode=mode, use_mtm=args.use_MtM,
                save_path=os.path.join(args.model_dir, "eval", eid, mode),
                n_time_steps=T, save_plot=args.save_plot,
                max_plots=args.max_plots, is_aligned=not args.unaligned,
                avail_beh=list(DEFAULT_TARGETS),
                session_id=eid_to_sid[eid], **kw)
            per_eid.update({k: (v if isinstance(v, dict) else float(v))
                            for k, v in res.items()})
            print(f"[{eid}][{mode}]",
                  json.dumps(per_eid, default=float)[:300])
        results[eid] = per_eid

    # the mean over sessions of each scalar
    summary = {}
    for per_eid in results.values():
        for k, v in per_eid.items():
            if isinstance(v, dict):
                for bk, bv in v.items():
                    summary.setdefault(f"{k}.{bk}", []).append(float(bv))
            else:
                summary.setdefault(k, []).append(float(v))
    results["mean_over_sessions"] = {k: float(np.nanmean(v))
                                     for k, v in summary.items()}
    out = os.path.join(args.model_dir, "eval", "results.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1, default=float)
    print("saved:", out)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    ap.add_argument("--mask_ratio", type=float, default=0.1)
    ap.add_argument("--mask_mode", type=str, default="temporal")
    ap.add_argument("--mixed_training", action="store_true")
    ap.add_argument("--use_MtM", action="store_true",
                    help="mask model inputs at eval (co-smoothing proper)")
    ap.add_argument("--model_dir", type=str, default=None,
                    help="checkpoint dir; default derives from the train layout")
    ap.add_argument("--checkpoint", type=str, default="best")
    ap.add_argument("--reference_ckpt", type=str, default=None,
                    help="evaluate a checkpoint the PyTorch reference "
                         "trained (a state_dict .pt or its whole-module "
                         "pickle)")
    ap.add_argument("--reference_src", type=str, default=None,
                    help="reference source root for --reference_ckpt")
    ap.add_argument("--co_smooth", action="store_true")
    ap.add_argument("--forward_pred", action="store_true")
    ap.add_argument("--inter_region", action="store_true")
    ap.add_argument("--intra_region", action="store_true")
    ap.add_argument("--no_modal_spike", action="store_true")
    ap.add_argument("--no_modal_behavior", action="store_true")
    ap.add_argument("--n_time_steps", type=int, default=100)
    ap.add_argument("--save_plot", action="store_true",
                    help="per-neuron diagnostic figures of the co-smoothing "
                         "modes (needs matplotlib)")
    ap.add_argument("--max_plots", type=int, default=20,
                    help="figures at most a mode with --save_plot")
    ap.add_argument("--unaligned", action="store_true",
                    help="the unaligned (chunked) session <eid>_unaligned "
                         "from the hub, and plain R² instead of "
                         "task-condition PSTHs (harness is_aligned=False); "
                         "results under eval_unaligned/")
    ap.add_argument("--multi_session", action="store_true",
                    help="evaluate a session-stitched checkpoint "
                         "(train_multi_session): every mode once per "
                         "trained session, artifacts under "
                         "<model_dir>/eval/<eid>/<mode>/; needs "
                         "--model_dir")
    args = ap.parse_args(argv)
    warn_unsupported(args, "dp", "tp", "device_resident")
    device = resolve_device(args.device)
    if args.multi_session:
        if not args.model_dir:
            raise ValueError("--multi_session requires --model_dir")
        return eval_multi_session(args, device)

    modal_filter = {"input": ["ap", "behavior"], "output": ["ap", "behavior"]}
    model_dir = args.model_dir or log_dir_for(
        args.base_path, args.eid, modal_filter,
        f"mask-{args.mask_mode}_ratio-{args.mask_ratio}"
        f"_mixed-{args.mixed_training}")

    splits = get_session(args)
    if args.reference_ckpt:                       # JAX :178-193
        model = load_reference_checkpoint(
            args.reference_ckpt,
            n_channels={"ap": splits.n_neurons,
                        "behavior": len(DEFAULT_TARGETS)},
            max_F=args.n_time_steps, reference_src=args.reference_src,
            device=device)
        test_loader = make_loader(
            splits.test, batch_size=splits.test.n_trials,
            max_time_length=args.n_time_steps,
            max_space_length=splits.n_neurons, shuffle=False)
        model_dir = args.model_dir or os.path.join(args.base_path,
                                                   "reference_ckpt_eval")
    else:
        model, test_loader = load_model_data_local(
            model_dir=model_dir, test_session=splits.test,
            checkpoint_name=args.checkpoint,
            max_time_length=args.n_time_steps,
            max_space_length=splits.n_neurons, seed=args.seed,
            device=device)

    T = args.n_time_steps
    sub = "eval_unaligned" if args.unaligned else "eval"
    results = {}
    for mode, kw in build_modes(args, T):
        res = co_smoothing_eval(
            model, test_loader, mode=mode, use_mtm=args.use_MtM,
            save_path=os.path.join(model_dir, sub, mode), n_time_steps=T,
            save_plot=args.save_plot, max_plots=args.max_plots,
            is_aligned=not args.unaligned,
            avail_beh=list(DEFAULT_TARGETS), **kw)
        results.update({k: (v if isinstance(v, dict) else float(v))
                        for k, v in res.items()})
        print(f"[{mode}]", json.dumps(results, default=float)[:400])

    os.makedirs(os.path.join(model_dir, sub), exist_ok=True)
    with open(os.path.join(model_dir, sub, "results.json"), "w") as f:
        json.dump(results, f, indent=1, default=float)
    print("saved:", os.path.join(model_dir, sub, "results.json"))
    return results


if __name__ == "__main__":
    main()
