"""The port's ``utils/seeding.py::set_seed`` against the JAX package's:
after each, Python's and numpy's global generators draw the same values
and ``PYTHONHASHSEED`` holds the seed. Exact equality."""

import os
import random

import numpy as np
import pytest

from multi_modal_foundation_model_tpu.utils.seeding import (
    set_seed as jax_set_seed)
from multi_modal_foundation_model_tpu_torch.utils.seeding import set_seed


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_set_seed_matches_jax(seed, monkeypatch, capsys):
    monkeypatch.setenv("PYTHONHASHSEED", "unset")   # restored afterwards
    draws = []
    for fn in (set_seed, jax_set_seed):
        fn(seed)
        assert capsys.readouterr().out == f"seed set to {seed}\n"
        assert os.environ["PYTHONHASHSEED"] == str(seed)
        draws.append((random.random(), random.getrandbits(64),
                      np.random.rand(4).tolist(),
                      np.random.randint(0, 1000, 5).tolist()))
    assert draws[0] == draws[1]
    set_seed(seed, verbose=False)
    assert capsys.readouterr().out == ""
