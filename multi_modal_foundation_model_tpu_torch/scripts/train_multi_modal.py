"""Train the MultiModal model on one session.

    python -m multi_modal_foundation_model_tpu_torch.scripts.train_multi_modal \\
        --synthetic --use_MtM --mixed_training [--device_resident] \\
        [--set training.steps_per_dispatch=10] [--device cpu]
    torchrun --nproc_per_node 4 -m \\
        multi_modal_foundation_model_tpu_torch.scripts.train_multi_modal \\
        --synthetic --dp 2 --tp 2 [--device cpu] [--backend gloo]

The port of the JAX package's ``scripts/train_multi_modal.py``: the same
flags and defaults, settings from the port's copies of ``mm.yaml`` and
``trainer_mm.yaml`` (bf16 compute by default) with ``--set`` overrides
(every trainer knob, ``steps_per_dispatch`` and ``prefetch_depth``
included, reads from ``training:``), the same log dir, checkpoints as the
port's ``.pt`` files beside ``model_config.json``. Under torchrun the
ranks train one model data- and tensor-parallel (``--dp``, ``--tp``; with
``--device_resident`` each rank runs its steps eagerly from the resident
split, no CUDA graph), rank 0 logging and writing (``scripts/_common.py``).
"""

from __future__ import annotations

import argparse

import torch

from ..config import config_from_kwargs, default_config_path, update_config
from ..data.loader import make_loader
from ..data.session import DEFAULT_TARGETS
from ..models.multimodal import MultiModal, MultiModalConfig
from ..parallel import build_mesh
from ..train import (MetricLogger, MultiModalTrainer, OptimizerConfig,
                     TrainerConfig)
from ._common import (add_common_args, apply_config_overrides, get_session,
                      guard_overwrite, is_main_rank, log_dir_for,
                      start_ranks)

MTM_MENU = ("inter-region", "intra-region", "neuron", "temporal")


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    ap.add_argument("--mask_ratio", type=float, default=0.1)
    ap.add_argument("--mask_mode", type=str, default="temporal")
    ap.add_argument("--use_MtM", action="store_true")
    ap.add_argument("--mixed_training", action="store_true")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore model_last from log_dir and continue")
    args = ap.parse_args(argv)
    device = start_ranks(args)
    mesh = build_mesh(args.dp, args.tp)

    config = config_from_kwargs(
        {"model": f"include:{default_config_path('multi_modal/mm.yaml')}"})
    config = update_config(default_config_path("multi_modal/trainer_mm.yaml"),
                           config)
    config = apply_config_overrides(config, args.config_overrides)
    config.model.masker["mode"] = args.mask_mode
    config.model.masker["ratio"] = args.mask_ratio
    if args.num_epochs is not None:
        config.training["num_epochs"] = args.num_epochs
    if args.batch_size is not None:
        config.training["train_batch_size"] = args.batch_size

    splits = get_session(args)
    n_neurons = splits.n_neurons
    avail_beh = list(DEFAULT_TARGETS)
    modal_filter = {"input": ["ap", "behavior"],
                    "output": ["ap", "behavior"]}
    log_dir = log_dir_for(
        args.base_path, args.eid, modal_filter,
        f"mask-{args.mask_mode}_ratio-{args.mask_ratio}"
        f"_mixed-{args.mixed_training}")
    guard_overwrite(log_dir, args.overwrite or args.resume)

    T = int(config.data.max_time_length)
    bs = int(config.training.train_batch_size)
    lkw = dict(batch_size=bs, target=avail_beh, max_time_length=T,
               max_space_length=n_neurons, seed=args.seed)
    train_loader = make_loader(splits.train, **lkw)
    region_vocab = train_loader.arrays["region_vocab"]
    val_loader = make_loader(splits.val, shuffle=False,
                             region_vocab=region_vocab, **lkw)

    mm_config = MultiModalConfig.from_config(
        config.model, n_channels={"ap": n_neurons, "behavior": len(avail_beh)})
    model = MultiModal(mm_config, device=device,
                       generator=torch.Generator().manual_seed(args.seed))

    # the MtM scheme menu: --use_MtM selects the four-scheme menu with
    # masking on the inputs; otherwise the trainer YAML's mask_type/mode
    if args.use_MtM:
        mask_type, mask_mode = "input", MTM_MENU
    else:
        mask_type = str(config.training.mask_type)
        mask_mode = tuple(config.training.mask_mode)

    # the YAML sets every trainer knob; flags override only when given
    overrides = dict(mask_type=mask_type, mask_mode=mask_mode,
                     seed=args.seed, log_dir=log_dir)
    if args.mixed_training:
        overrides["mixed_training"] = True
    if args.device_resident:
        overrides["device_resident_data"] = True
    tcfg = TrainerConfig.from_config(config, **overrides)
    ocfg = OptimizerConfig.from_config(config.optimizer)
    logger = MetricLogger(log_dir, use_wandb=bool(config.wandb.use),
                          wandb_project=config.wandb.project,
                          config=config.to_dict())

    trainer = MultiModalTrainer(
        model, train_loader, val_loader, ocfg, tcfg,
        modal_filter=modal_filter, mesh=mesh, logger=logger)
    start_epoch = 0
    if args.resume:
        start_epoch = trainer.restore("last") + 1
        print(f"resumed from epoch {start_epoch - 1}")
    summary = trainer.train(start_epoch=start_epoch)
    if is_main_rank():
        print("best:", {k: v for k, v in summary.items() if k != "history"})
    return summary


if __name__ == "__main__":
    main()
