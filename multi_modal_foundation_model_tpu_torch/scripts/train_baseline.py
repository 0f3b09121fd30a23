"""Train a linear baseline (encoding: behavior -> spikes; decoding:
spikes -> behavior).

    python -m multi_modal_foundation_model_tpu_torch.scripts.train_baseline \\
        --synthetic --direction encoding [--device cpu]
    torchrun --nproc_per_node 2 -m \\
        multi_modal_foundation_model_tpu_torch.scripts.train_baseline \\
        --synthetic --dp 2 [--device cpu]      # data parallel

The port of the JAX package's ``scripts/train_baseline.py``: the same
flags and defaults, the same log dir (``<base_path>/results/ses-<eid>/
set-train/inModal-.../outModal-.../linear``), ``baseline_config.json``
beside the checkpoints (``model_best.pt``, ``model_last.pt``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import config_from_kwargs, default_config_path, update_config
from ..data.loader import make_loader
from ..data.session import DEFAULT_TARGETS
from ..models.baseline import BaselineDecoder, BaselineEncoder
from ..parallel import build_mesh
from ..train import (BaselineTrainer, MetricLogger, OptimizerConfig,
                     TrainerConfig)
from ._common import (add_common_args, apply_config_overrides, get_session,
                      guard_overwrite, is_main_rank, log_dir_for,
                      start_ranks, warn_unsupported)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    ap.add_argument("--direction", choices=["encoding", "decoding"],
                    default="decoding",
                    help="encoding: behavior->spikes; decoding: spikes->behavior")
    ap.add_argument("--resume", action="store_true",
                    help="restore model_last from log_dir and continue")
    args = ap.parse_args(argv)
    warn_unsupported(args, "device_resident")
    device = start_ranks(args)
    mesh = build_mesh(args.dp, args.tp)

    config = config_from_kwargs(
        {"model": f"include:{default_config_path('baseline.yaml')}"})
    config = update_config(default_config_path("trainer.yaml"), config)
    config = apply_config_overrides(config, args.config_overrides)
    if args.num_epochs is not None:
        config.training["num_epochs"] = args.num_epochs

    splits = get_session(args)
    n_neurons = splits.n_neurons
    avail_beh = list(DEFAULT_TARGETS)
    generator = torch.Generator().manual_seed(args.seed)

    if args.direction == "encoding":
        modal_filter = {"input": ["behavior"], "output": ["ap"]}
        model = BaselineEncoder(in_channel=len(avail_beh),
                                out_channel=n_neurons,
                                seq_len=int(config.data.max_time_length),
                                device=device, generator=generator)
    else:
        modal_filter = {"input": ["ap"], "output": ["behavior"]}
        model = BaselineDecoder(in_channel=n_neurons,
                                out_channel=len(avail_beh),
                                device=device, generator=generator)

    log_dir = log_dir_for(args.base_path, args.eid, modal_filter, "linear")
    guard_overwrite(log_dir, args.overwrite or args.resume)

    T = int(config.data.max_time_length)
    bs = int(config.training.train_batch_size)
    lkw = dict(batch_size=bs, target=avail_beh, max_time_length=T,
               max_space_length=n_neurons, seed=args.seed)
    train_loader = make_loader(splits.train, **lkw)
    val_loader = make_loader(splits.val, shuffle=False, **lkw)

    tcfg = TrainerConfig.from_config(config, seed=args.seed,
                                     log_dir=log_dir)
    ocfg = OptimizerConfig.from_config(config.optimizer)
    logger = MetricLogger(log_dir, use_wandb=bool(config.wandb.use),
                          wandb_project=config.wandb.project,
                          config=config.to_dict())

    trainer = BaselineTrainer(model, train_loader, val_loader, ocfg, tcfg,
                              modal_filter=modal_filter, mesh=mesh,
                              logger=logger)
    start_epoch = 0
    if args.resume:
        start_epoch = trainer.restore("last") + 1
        print(f"resumed from epoch {start_epoch - 1}")
    summary = trainer.train(start_epoch=start_epoch)

    if is_main_rank():
        # what eval needs to rebuild the model
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "baseline_config.json"), "w") as f:
            json.dump({"direction": args.direction, "n_neurons": n_neurons,
                       "n_behaviors": len(avail_beh), "seq_len": T,
                       "modal_filter": modal_filter}, f)
        print("best:", {k: v for k, v in summary.items() if k != "history"})
    return summary


if __name__ == "__main__":
    main()
