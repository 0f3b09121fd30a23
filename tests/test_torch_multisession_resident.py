"""The multi-session trainer's resident paths and per-session eval against
the JAX package.

The toy of ``test_torch_multisession.py`` (three sessions of 24-61
neurons, T=20, H=32, 2+2 layers, dropout 0, the deterministic MtM menu
co-smooth / forward-pred, remat off on both sides, lr 1e-3), with the
splits resident on the device and each step gathering from its bucket's
stacked block: K=1 (the interleave step by step) and the stacked K=2
(groups of 2 crossing sessions, the 11th step alone) against JAX's
``_train_epoch_dr`` / ``_train_epoch_dr_stacked``, JAX's attention through
Pallas (interpret mode). Gates (``tests/test_torch_trainer.py``'s): the
same schedule and host draws exactly, per-step losses rtol 2e-5, final
parameters atol 2e-5 except the attention key biases. Then
``eval_epoch``'s per-session metrics on the trained weights: ``ap_bps``,
``ap_r2`` and ``behavior_r2`` per eid, and the eval loss, within 1e-4
(``tests/test_torch_eval.py``'s metric tolerance).
"""

import jax
import numpy as np
import pytest

from torch_parity import (assert_params_close, jax_trainer, port_trainer,
                          record_modes)

STEP_RTOL, METRIC_ATOL = 2e-5, 1e-4


def _jax_epoch(tr):
    """One epoch of JAX's resident path with its per-step losses (single
    steps and K-step scans alike, in order)."""
    losses = []

    def recording(get):
        def wrapped(*args, **kwargs):
            step = get(*args, **kwargs)

            def run(*a):
                state, loss = step(*a)
                losses.extend(np.atleast_1d(np.asarray(loss)).tolist())
                return state, loss
            return run
        return wrapped

    tr._get_train_step_dr = recording(tr._get_train_step_dr)
    tr._get_multi_step_dr = recording(tr._get_multi_step_dr)
    tr.train_epoch(0)
    return losses


@pytest.mark.parametrize("K", [1, 2], ids=["k1", "stacked_k2"])
def test_resident_lockstep_with_jax(K, tmp_path):
    over = dict(device_resident_data=True, steps_per_dispatch=K)
    j = jax_trainer(tmp_path / "j", **over)
    init = jax.tree_util.tree_map(np.asarray, j.state.params)
    jmodes = record_modes(j)
    jlosses = _jax_epoch(j)
    t = port_trainer(tmp_path / "t", init, **over)
    assert t._epoch_schedule(0) == j._epoch_schedule(0)
    tmodes = record_modes(t)
    losses = t.train_epoch(0)["step_losses"]
    assert tmodes == jmodes
    assert len(losses) == 11
    np.testing.assert_allclose(losses, jlosses, rtol=STEP_RTOL, atol=0)
    assert_params_close(t, jax.tree_util.tree_map(np.asarray,
                                                  j.state.params))
    if K == 2:
        return
    # the per-session eval on the trained weights, both resident
    want, got = j.eval_epoch(), t.eval_epoch()
    assert got["eval_per_session"].keys() == want["eval_per_session"].keys()
    for eid, metrics in want["eval_per_session"].items():
        assert got["eval_per_session"][eid].keys() == metrics.keys()
        assert set(metrics) == {"ap_bps", "ap_r2", "behavior_r2"}
        for k, v in metrics.items():
            np.testing.assert_allclose(got["eval_per_session"][eid][k], v,
                                       atol=METRIC_ATOL, rtol=0,
                                       err_msg=f"{eid}.{k}")
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["eval_trial_avg_r2"],
                               want["eval_trial_avg_r2"], atol=METRIC_ATOL)
    for eid in want["eval_gt"]:
        for mod in ("ap", "behavior"):
            np.testing.assert_array_equal(got["eval_gt"][eid][mod],
                                          want["eval_gt"][eid][mod])
