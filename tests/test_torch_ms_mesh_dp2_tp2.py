"""The port's ``MultiSessionTrainer`` at dp 2 x tp 2 against JAX's under
``build_mesh(2, 2)``: the step-0 loss and gradients, then one epoch of
host batches in lockstep (``tests/torch_ms_mesh.py`` has the set-up and the gates)."""

from torch_ms_mesh import mesh_lockstep


def test_dp2_tp2_in_lockstep_with_jax_mesh(tmp_path):
    mesh_lockstep(2, 2, ("host",), tmp_path, step0=True)
