"""Shared plumbing of the entry scripts: flags, sessions, log dirs.

The port's counterpart of the JAX package's ``scripts/_common.py``: the
same flags and defaults (``add_common_args``) plus ``--device`` (default
``cuda``: the scripts run on the card unless asked for the CPU, and with
no card ``cuda`` raises), ``--set`` overrides, the reference's results
layout (``log_dir_for``) and the overwrite guard. Sessions come from the
offline synthetic generator (``--synthetic``) or, without it, from the
hub: ``load_ibl_session(--eid)`` (``<eid>_aligned``, or ``<eid>_unaligned``
with an ``--unaligned`` flag), which needs ``datasets`` and the hub or a
warm Hugging Face cache. DP/TP meshes are not ported: ``--dp`` and
``--tp`` take their single-device values only.
"""

from __future__ import annotations

import os
import warnings

from ..config import config_from_kwargs, update_config
from ..data.session import SessionSplits, load_ibl_session, synthetic_splits
from ..train.checkpoint import checkpoint_path

DEFAULT_EID = "db4df448-e449-4a6f-a0e7-288711e7a75a"


def apply_config_overrides(config, pairs):
    """Dotted command-line overrides (``--set a.b.c=1``) merged into a
    loaded config."""
    if not pairs:
        return config
    kwargs = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        if value == "":
            raise ValueError(f"--set expects key=value, got {pair!r}")
        kwargs[key] = value
    return update_config(config, config_from_kwargs(kwargs))


def add_common_args(ap):
    ap.add_argument("--set", dest="config_overrides", action="append",
                    default=[], metavar="KEY=VALUE",
                    help="dotted config override, e.g. --set optimizer.lr=3e-4")
    ap.add_argument("--eid", type=str, default=DEFAULT_EID)
    ap.add_argument("--base_path", type=str, default="results")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--synthetic", action="store_true",
                    help="use an offline synthetic session instead of the "
                         "IBL session --eid from the hub")
    ap.add_argument("--n_neurons", type=int, default=668,
                    help="synthetic session size (ignored with real data)")
    ap.add_argument("--n_trials", type=int, default=400)
    ap.add_argument("--num_epochs", type=int, default=None,
                    help="override config num_epochs")
    ap.add_argument("--dp", type=int, default=-1,
                    help="data-parallel devices; -1 = all, 1 = single "
                         "(the port runs on one device)")
    ap.add_argument("--device_resident", action="store_true",
                    help="keep each split resident on the card and gather "
                         "batches there (removes the per-batch host->device "
                         "copy from the training loop)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size (the port runs tp=1 only)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: cuda (default; raises "
                         "without a card) or cpu")
    return ap


def warn_unsupported(args, *flags: str) -> None:
    """Warn for common flags this entry point does not honor instead of
    dropping them silently."""
    defaults = {"device_resident": False, "tp": 1, "dp": -1}
    for f in flags:
        if getattr(args, f, defaults.get(f)) != defaults.get(f):
            warnings.warn(f"--{f} is not supported by this script and is "
                          "ignored", stacklevel=2)


def get_session(args) -> SessionSplits:
    """The synthetic session (``--synthetic``) or the IBL session ``--eid``
    from the hub, aligned unless the script has ``--unaligned`` set (JAX
    ``scripts/_common.py:102-110``)."""
    if args.synthetic:
        # synthetic "unaligned" sessions are the same generator; the
        # distinction is in the eval path (harness is_aligned=False)
        return synthetic_splits(seed=args.seed, n_trials=args.n_trials,
                                n_neurons=args.n_neurons, eid=args.eid)
    unaligned = bool(getattr(args, "unaligned", False))
    return load_ibl_session(args.eid, aligned=not unaligned)


def build_mesh(dp: int, tp: int = 1):
    """None (one device) for ``dp`` in (-1, 1) with ``tp == 1``; DP/TP
    meshes are not ported and raise."""
    if dp in (-1, 1) and tp == 1:
        return None
    raise NotImplementedError(
        f"--dp {dp} --tp {tp}: DP/TP meshes are not ported yet; the port "
        "runs on one device (--dp -1 or 1, --tp 1)")


def log_dir_for(base_path: str, eid: str, modal_filter, model_name: str) -> str:
    """The reference's results layout (``train_baseline.py:60-67``)."""
    return os.path.join(
        base_path, "results", f"ses-{eid}", "set-train",
        f"inModal-{'-'.join(modal_filter['input'])}",
        f"outModal-{'-'.join(modal_filter['output'])}",
        model_name)


def guard_overwrite(log_dir: str, overwrite: bool) -> None:
    marker = checkpoint_path(log_dir, "last")
    if os.path.exists(marker) and not overwrite:
        raise FileExistsError(
            f"checkpoint exists at {marker} and --overwrite not set")


def no_epoch_plots(config) -> None:
    """Epoch plots are not ported: a config that asks for them
    (``training.save_plot_every_n_epochs``, 5 in the shipped trainer
    YAMLs) runs without them, with a warning."""
    every = config.training.get("save_plot_every_n_epochs", 0) or 0
    if every:
        warnings.warn(
            f"training.save_plot_every_n_epochs={every}: epoch plots are "
            "not ported; training without them", stacklevel=2)
        config.training["save_plot_every_n_epochs"] = 0
