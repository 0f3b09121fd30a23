"""Model-config sidecar I/O (``model_config.json``).

The port's copy of ``save_model_config``/``load_model_config``
(``multi_modal_foundation_model_tpu/eval/loading.py:26-36``): the port and
the JAX package read each other's file. Restoring checkpoints comes with
the training slice.
"""

from __future__ import annotations

import json
import os

from ..models.multimodal import MultiModalConfig


def save_model_config(log_dir: str, config: MultiModalConfig) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "model_config.json")
    with open(path, "w") as f:
        json.dump(config.to_json_dict(), f, indent=1)
    return path


def load_model_config(log_dir: str) -> MultiModalConfig:
    with open(os.path.join(log_dir, "model_config.json")) as f:
        return MultiModalConfig.from_json_dict(json.load(f))
