"""Device resolution for the port's entry points.

``device=None`` means the card (``"cuda"``). Without CUDA the caller must
ask for the CPU explicitly; nothing moves to the CPU silently.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

