"""The port's resident ``MultiSessionTrainer`` at dp = 2 against JAX's
under ``build_mesh(2)``: K = 1, and K = 2 (groups of two steps across
sessions, a leftover single step, JAX's stacked scan), each one epoch in
lockstep, every step eager on a rank (``tests/torch_ms_mesh.py`` has the set-up and the gates)."""

from torch_ms_mesh import mesh_lockstep


def test_dp2_resident_in_lockstep_with_jax_mesh(tmp_path):
    mesh_lockstep(2, 1, ("k1", "k2"), tmp_path, step0=False)
