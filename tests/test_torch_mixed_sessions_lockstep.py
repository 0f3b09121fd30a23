"""The port's session-mixed resident trainer in lockstep with JAX's:
one bucket at K=1, two buckets at K=2 (the other two cases are in
``test_torch_mixed_sessions.py``, which documents the gates). A file of
its own keeps each under about a minute: most of the time is JAX
compiling its mixed step with Pallas in interpret mode."""

import pytest

from torch_parity import mixed_lockstep


@pytest.mark.parametrize("K,n_buckets", [(1, 1), (2, 2)],
                         ids=["k1_one_bucket", "k2_two_buckets"])
def test_mixed_lockstep_with_jax(K, n_buckets, tmp_path):
    mixed_lockstep(K, n_buckets, tmp_path)
