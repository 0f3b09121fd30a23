"""Checkpoint conversion between the PyTorch reference and the port.

    python -m multi_modal_foundation_model_tpu_torch.scripts.convert_checkpoint \\
        to-port ref/model_best.pt OUT_DIR --n-neurons 668 \\
        [--reference-src SRC] [--name best] [--device cpu]
    python -m multi_modal_foundation_model_tpu_torch.scripts.convert_checkpoint \\
        to-reference OUT_DIR/model_best.pt state_dict.pt

The port of the JAX package's ``scripts/convert_checkpoint.py``, in the
port's own formats:

- ``to-port`` (JAX ``to-flax``): a reference checkpoint (a ``state_dict``
  .pt, or the reference's whole-module pickle) through
  ``load_reference_checkpoint`` into ``OUT_DIR/model_<name>.pt`` and
  ``model_config.json``, which ``load_model_data_local`` and
  ``eval_multi_modal --model_dir OUT_DIR`` read. The tree holds the model
  only: the reference's file has no optimizer state to convert.
- ``to-reference`` (JAX ``to-torch``): a port checkpoint
  (``model_<name>.pt``, its ``model_config.json`` beside it) to a
  ``state_dict`` .pt in the reference's names, which the reference's
  ``load_state_dict`` takes. The port keeps those names, so this writes
  the model's tensors as they are. A session-stitched checkpoint is
  refused: the reference has no names for its stacks.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..eval.loading import (load_model_config, load_reference_checkpoint,
                            save_model_config)
from ..train.checkpoint import save_checkpoint
from ..utils.device import resolve_device


def to_port(args):
    model = load_reference_checkpoint(
        args.src, n_channels={"ap": args.n_neurons,
                              "behavior": args.n_behaviors},
        max_F=args.max_F, reference_src=args.reference_src,
        device=resolve_device(args.device))
    os.makedirs(args.dst, exist_ok=True)
    save_model_config(args.dst, model.config)
    path = save_checkpoint(args.dst, args.name,
                           {"model": model.state_dict()},
                           meta={"converted_from": os.path.abspath(args.src)})
    print(f"wrote {path} (+ model_config.json)")
    return path


def to_reference(args):
    src_dir = os.path.dirname(os.path.abspath(args.src))
    cfg = load_model_config(src_dir)
    if cfg.n_sessions > 1:
        raise ValueError(
            f"{args.src} is a session-stitched checkpoint (n_sessions="
            f"{cfg.n_sessions}): the reference has no names for its stacks")
    tree = torch.load(args.src, map_location="cpu", weights_only=True)
    sd = {k: v.detach().cpu().contiguous() for k, v in tree["model"].items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)) or ".",
                exist_ok=True)
    torch.save(sd, args.dst)
    print(f"wrote {args.dst} ({len(sd)} tensors, reference naming)")
    return args.dst


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("to-port", help="reference .pt -> port checkpoint dir")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--name", default="best")
    p.add_argument("--n-neurons", type=int, required=True)
    p.add_argument("--n-behaviors", type=int, default=2)
    p.add_argument("--max-F", type=int, default=100)
    p.add_argument("--reference-src", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the model is built: cuda (default; raises "
                        "without a card) or cpu")
    p.set_defaults(fn=to_port)

    r = sub.add_parser("to-reference",
                       help="port model_<name>.pt -> state_dict .pt")
    r.add_argument("src")
    r.add_argument("dst")
    r.set_defaults(fn=to_reference)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
