"""Host seeding: Python's and numpy's global generators.

The port's copy of ``multi_modal_foundation_model_tpu/utils/seeding.py``
(``set_seed``). The port's device randomness is keyed explicitly (every
draw of a step from its seed table, ``utils/rng.py``; initial weights
from a ``torch.Generator``), so this seeds only the host generators that
remain global.
"""

from __future__ import annotations

import os
import random

import numpy as np


def set_seed(seed: int, verbose: bool = True) -> None:
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    random.seed(seed)
    if verbose:
        print(f"seed set to {seed}")
