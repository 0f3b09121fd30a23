"""``co_smoothing_eval_baseline`` against the JAX package's, in both modes.

The same synthetic test split (bit-identical in both packages) and the
same weights (the JAX model's initial params, carried by
``baseline_params_from_jax``) go through both harnesses: ``modal_spike``
for the encoder, ``modal_behavior`` for the decoder. The returned dicts
and the saved ``bps.npy`` / ``r2.npy`` agree within atol 1e-6 and rtol
1e-6 (f32 products summed in another order), with NaN in the same places
(the per-neuron bps of a neuron with no spikes, ``modal_behavior``'s bps).
"""

import jax
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.eval import baseline_harness as jharness
from multi_modal_foundation_model_tpu.models import baseline as jbaseline
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.eval import baseline_harness
from multi_modal_foundation_model_tpu_torch.models import baseline as tbaseline
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    baseline_params_from_jax)

N, T, N_BEH = 24, 20, 2
ATOL = RTOL = 1e-6
CASES = {
    "modal_spike": ("encoding", {"input": ["behavior"], "output": ["ap"]}),
    "modal_behavior": ("decoding", {"input": ["ap"], "output": ["behavior"]}),
}


def _test_loader(loader_mod, session_mod):
    sp = session_mod.synthetic_splits(seed=1, n_trials=120, n_neurons=N,
                                      n_timesteps=T)
    return loader_mod.make_loader(sp.test, batch_size=sp.test.n_trials,
                                  max_time_length=T, max_space_length=N,
                                  shuffle=False)


def _models(direction, batch):
    if direction == "encoding":
        jm = jbaseline.BaselineEncoder(in_channel=N_BEH, out_channel=N,
                                       seq_len=T)
        tm = tbaseline.BaselineEncoder(N_BEH, N, seq_len=T, device="cpu")
        data = {"inputs": batch["target"], "targets": batch["spikes_data"]}
    else:
        jm = jbaseline.BaselineDecoder(in_channel=N, out_channel=N_BEH)
        tm = tbaseline.BaselineDecoder(N, N_BEH, device="cpu")
        data = {"inputs": batch["spikes_data"], "targets": batch["target"]}
    params = jm.init(jax.random.PRNGKey(2), data)["params"]
    tm.load_state_dict(baseline_params_from_jax(params), strict=True)
    return jm, params, tm


def _close(a, b, what):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("mode", list(CASES))
def test_baseline_harness_matches_jax(mode, tmp_path):
    direction, modal_filter = CASES[mode]
    jloader_ = _test_loader(jloader, jsession)
    tloader_ = _test_loader(tloader, tsession)
    jm, params, tm = _models(direction, next(iter(jloader_)))
    kw = dict(modal_filter=modal_filter, held_out_list=list(range(T)),
              n_time_steps=T)
    want = jharness.co_smoothing_eval_baseline(
        jm, params, jloader_, mode, save_path=str(tmp_path / "j"), **kw)
    got = baseline_harness.co_smoothing_eval_baseline(
        tm, tloader_, mode, save_path=str(tmp_path / "t"), **kw)

    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            assert got[key].keys() == want[key].keys()
            for k in want[key]:
                _close(got[key][k], want[key][k], f"{key}.{k}")
        else:
            _close(got[key], want[key], key)

    for name in ("bps.npy", "r2.npy"):
        a = np.load(tmp_path / "t" / name, allow_pickle=True)
        b = np.load(tmp_path / "j" / name, allow_pickle=True)
        if mode == "modal_behavior" and name == "r2.npy":
            a, b = a.item(), b.item()
            assert a.keys() == b.keys()
            for k in b:
                _close(a[k], b[k], f"{name}.{k}")
        else:
            _close(a, b, name)
    if mode == "modal_spike":
        assert np.load(tmp_path / "t" / "bps.npy").shape == (N,)
        assert np.load(tmp_path / "t" / "r2.npy").shape == (N, 2)
    else:
        assert np.isnan(np.load(tmp_path / "t" / "bps.npy"))


def test_baseline_harness_unported_and_bad_arguments_raise(tmp_path):
    """``save_plot``, ported since, draws nothing in ``modal_behavior``
    (JAX draws the encoder's ``modal_spike`` neurons only,
    ``tests/test_torch_plotting.py``); a missing ``held_out_list`` and an
    unknown mode raise."""
    loader = _test_loader(tloader, tsession)
    tm = tbaseline.BaselineDecoder(N, N_BEH, device="cpu")
    kw = dict(modal_filter=CASES["modal_behavior"][1],
              save_path=str(tmp_path))
    res = baseline_harness.co_smoothing_eval_baseline(
        tm, loader, "modal_behavior", held_out_list=[0], save_plot=True,
        **kw)
    assert "modal_behavior_behav_results" in res
    assert not list(tmp_path.glob("*.png"))
    with pytest.raises(ValueError):
        baseline_harness.co_smoothing_eval_baseline(
            tm, loader, "modal_behavior", **kw)
    with pytest.raises(NotImplementedError):
        baseline_harness.co_smoothing_eval_baseline(
            tm, loader, "per_neuron", held_out_list=[0], **kw)
