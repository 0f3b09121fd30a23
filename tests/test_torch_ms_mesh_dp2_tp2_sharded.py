"""The port's sharded resident sessions at dp 2 x tp 2, K = 2, against
JAX's ``_train_epoch_dr_mixed_sharded`` under ``build_mesh(2, 2)``: one
epoch in lockstep, the tp ranks of a data row holding one shard
(``tests/torch_ms_mesh.py`` has the set-up and the gates)."""

from torch_ms_mesh import mesh_lockstep


def test_dp2_tp2_sharded_in_lockstep_with_jax_mesh(tmp_path):
    got = mesh_lockstep(2, 2, ("sharded_k2",), tmp_path, step0=False)
    assert got["sharded_k2"]["rows"] == 22
