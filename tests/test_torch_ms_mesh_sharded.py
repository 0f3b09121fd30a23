"""The port's session-mixed and sharded resident epochs at dp = 2 against
JAX's under ``build_mesh(2)`` (``_train_epoch_dr_mixed`` and
``_train_epoch_dr_mixed_sharded``), one epoch each in lockstep
(``tests/torch_ms_mesh.py`` has the set-up and the gates)."""

from torch_ms_mesh import mesh_lockstep


def test_dp2_mixed_and_sharded_in_lockstep_with_jax_mesh(tmp_path):
    got = mesh_lockstep(2, 1, ("mixed", "sharded"), tmp_path, step0=False)
    # each data rank holds its shard's sessions only: rank 0 s0 and s2
    # (11 train trials each), rank 1 s1, its block padded to L = 22 of the
    # replicated block's 33 rows
    sharded = got["sharded"]
    assert sharded["pools"] == [22, 11] and sharded["rows"] == 22
    assert sharded["resident_bytes"] * 33 == sharded["replicated_bytes"] * 22
