"""The port's ``MultiSessionTrainer`` at dp = 2 against JAX's under
``build_mesh(2)``: the step-0 loss and gradients, then one epoch of host
batches in lockstep, ``space_attn_mask`` cut to the rank's rows (``tests/torch_ms_mesh.py`` has the set-up and the gates)."""

from torch_ms_mesh import mesh_lockstep


def test_dp2_in_lockstep_with_jax_mesh(tmp_path):
    mesh_lockstep(2, 1, ("host",), tmp_path, step0=True)
