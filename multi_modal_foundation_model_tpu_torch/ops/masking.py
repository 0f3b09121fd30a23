"""Masking hyperparameters (copy of the JAX package's ``MaskParams``).

Only the static parameter record is here, so that ``MultiModalConfig``
reads and writes the JAX package's ``model_config.json``. The masker itself
(the nine masking modes, span expansion, region sampling) lands with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MaskParams:
    """Static masking hyperparameters."""

    ratio: float = 0.3
    zero_ratio: float = 1.0
    random_ratio: float = 1.0
    expand_prob: float = 0.0
    max_timespan: int = 1
    channels: Optional[Tuple[int, ...]] = None      # co-smooth
    timesteps: Optional[Tuple[int, ...]] = None     # forward-pred
    n_mask_regions: int = 1
    causal_zero: bool = True
