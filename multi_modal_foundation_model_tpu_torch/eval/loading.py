"""Model-config sidecar I/O and checkpoint loading for the eval.

The port's copy of ``multi_modal_foundation_model_tpu/eval/loading.py``:
``save_model_config``/``load_model_config`` (``model_config.json``; the
port and the JAX package read each other's file) and
``load_model_data_local`` (:39-73), which rebuilds a trained model from a
port checkpoint with the masker disabled by configuration (``ratio=0``,
``force_active=False``) and builds the full-test-set loader in trial order.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

from ..data.loader import DataLoader, make_loader
from ..data.session import SessionData
from ..models.multimodal import MultiModal, MultiModalConfig
from ..utils.device import DeviceLike


def save_model_config(log_dir: str, config: MultiModalConfig) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "model_config.json")
    with open(path, "w") as f:
        json.dump(config.to_json_dict(), f, indent=1)
    return path


def load_model_config(log_dir: str) -> MultiModalConfig:
    with open(os.path.join(log_dir, "model_config.json")) as f:
        return MultiModalConfig.from_json_dict(json.load(f))


def load_model_data_local(
    *,
    model_dir: str,
    test_session: SessionData,
    checkpoint_name: str = "best",
    max_time_length: int = 100,
    max_space_length: Optional[int] = None,
    seed: int = 42,
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[MultiModal, DataLoader]:
    """(model carrying the checkpoint's weights, full-test-set loader).

    JAX returns (model, params, loader); the port's model holds its
    parameters. Held-out masking at eval time arrives through explicit
    ``eval_mask`` tensors, so the masker is switched off."""
    # imported here: the train package imports this module
    from ..train.checkpoint import restore_checkpoint

    config = load_model_config(model_dir)
    config = dataclasses.replace(
        config,
        mask_params=dataclasses.replace(config.mask_params, ratio=0.0),
        force_active=False)
    model = MultiModal(config, device=device)
    tree = restore_checkpoint(model_dir, checkpoint_name,
                              map_location=next(model.parameters()).device)
    model.load_state_dict(tree["model"])
    n_space = max_space_length or config.n_channels["ap"]
    loader = make_loader(
        test_session,
        batch_size=batch_size or test_session.n_trials,
        max_time_length=max_time_length,
        max_space_length=n_space,
        shuffle=False,
        seed=seed,
    )
    return model, loader
