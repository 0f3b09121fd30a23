"""Checkpoints: ``torch.save`` of {model, optimizer, step}.

Port of ``multi_modal_foundation_model_tpu/train/checkpoint.py`` (orbax
pytrees of {params, opt_state, step} there). The optimizer entry holds the
AdamW state, the update count that places the OneCycle schedule, and the
accumulation buffers (``train/schedule.py``). Layout under ``log_dir``::

    model_best.pt    the tree (written to a temporary file, then renamed)
    model_best.json  {"epoch": ..., "step": ..., "metric": ...}
    model_last.pt / model_last.json
    model_config.json  written by the trainer (``eval/loading.py``)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


def checkpoint_path(log_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(log_dir, f"model_{name}.pt"))


def save_checkpoint(log_dir: str, name: str, tree: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Save ``tree`` as ``<log_dir>/model_<name>.pt`` (atomic rename) and
    ``meta`` beside it as ``model_<name>.json``."""
    os.makedirs(log_dir, exist_ok=True)
    path = checkpoint_path(log_dir, name)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(os.path.join(log_dir, f"model_{name}.json"), "w") as f:
            json.dump(meta, f)
    return path


def restore_checkpoint(log_dir: str, name: str,
                       map_location=None) -> Dict[str, Any]:
    """The tree of ``<log_dir>/model_<name>.pt`` (tensors, numbers and
    containers only: ``weights_only=True``)."""
    return torch.load(checkpoint_path(log_dir, name),
                      map_location=map_location, weights_only=True)


def load_checkpoint_meta(log_dir: str, name: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(log_dir, f"model_{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
