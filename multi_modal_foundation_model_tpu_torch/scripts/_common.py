"""Shared plumbing of the entry scripts: flags, sessions, log dirs.

The port's counterpart of the JAX package's ``scripts/_common.py``: the
same flags and defaults (``add_common_args``) plus ``--device`` (default
``cuda``: the scripts run on the card unless asked for the CPU, and with
no card ``cuda`` raises), ``--set`` overrides, the reference's results
layout (``log_dir_for``) and the overwrite guard. Sessions come from the
offline synthetic generator (``--synthetic``) or, without it, from the
hub: ``load_ibl_session(--eid)`` (``<eid>_aligned``, or ``<eid>_unaligned``
with an ``--unaligned`` flag), which needs ``datasets`` and the hub or a
warm Hugging Face cache.

Data and tensor parallelism (``--dp``, ``--tp``; ``train_multi_modal`` and
``train_baseline``): each rank is a process, started by torchrun::

    torchrun --nproc_per_node 4 -m \
        multi_modal_foundation_model_tpu_torch.scripts.train_multi_modal \
        --synthetic --dp 2 --tp 2 [--device cpu] [--backend gloo]

``start_ranks`` joins the process group torchrun describes
(``WORLD_SIZE`` set; NCCL on the card, gloo on the CPU, or ``--backend``:
ranks that share one card need gloo) and picks
the rank's device (card ``LOCAL_RANK % device_count``);
``parallel.build_mesh`` needs ``dp * tp`` to be the world, ``--dp -1``
filling it.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist

from ..config import config_from_kwargs, update_config
from ..data.session import SessionSplits, load_ibl_session, synthetic_splits
from ..parallel import initialize_multihost, rank_device
from ..train.checkpoint import checkpoint_path
from ..utils.device import resolve_device

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
                    help="data-parallel ranks; -1 = every rank not taken by "
                         "--tp (dp * tp must be the torchrun world)")
    ap.add_argument("--device_resident", action="store_true",
                    help="keep each split resident on the card and gather "
                         "batches there (removes the per-batch host->device "
                         "copy from the training loop)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks (the 'model' axis: "
                         "attention heads, MLP and tokenizer widths split)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--backend", type=str, default=None,
                    choices=("nccl", "gloo"),
                    help="torch.distributed backend under torchrun "
                         "(default: nccl on cuda, gloo on cpu; ranks "
                         "sharing one card need gloo)")
    return ap


def start_ranks(args) -> torch.device:
    """This process's device: under torchrun (``WORLD_SIZE`` set) after
    joining its process group (``--backend``), card ``LOCAL_RANK %
    device_count`` or the CPU; alone, ``--device``."""
    if "WORLD_SIZE" not in os.environ:
        return resolve_device(args.device)
    initialize_multihost(backend=args.backend, device=args.device)
    return rank_device(args.device)


def is_main_rank() -> bool:
    """Rank 0, or no process group: the process that prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


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

