"""Port data + eval (``data/``, ``eval/``) against the JAX package.

- ``synthetic_splits``, ``prepare_split`` and the loader's batches are
  bit-identical to the JAX package's for the same seed.
- ``co_smoothing_eval``, all six modes, ``use_mtm`` True and False, on the
  same data and converted weights: per-neuron bps and R² within 1e-4
  absolute with NaN in the same places; the saved ``bps.npy``/``r2.npy``
  have the same shapes. The ``per_neuron`` case with ``use_mtm=True`` is
  the one that catches a sweep batching variants without the per-variant
  row-0 token zeroing (``token_zero_groups``).
"""

import numpy as np
import pytest
import torch

from torch_parity import TOY, jax_model, port_model
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.eval import harness as jharness
from multi_modal_foundation_model_tpu.eval import heldout as jheldout
from multi_modal_foundation_model_tpu.eval import metrics as jmetrics
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.eval import harness as tharness
from multi_modal_foundation_model_tpu_torch.eval import heldout as theldout
from multi_modal_foundation_model_tpu_torch.eval import metrics as tmetrics

N_AP, T = TOY["n_channels"]["ap"], TOY["max_F"]
N_SPACE = N_AP + 4          # four padded neuron columns
HELD = list(range(14, 20))
ATOL = 1e-4


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_trials=200, n_neurons=24, n_timesteps=20),
    dict(seed=3, n_trials=40, n_neurons=70, n_timesteps=33, n_behaviors=3),
])
def test_synthetic_splits_bit_identical(kw):
    j, t = jsession.synthetic_splits(**kw), tsession.synthetic_splits(**kw)
    for split in ("train", "val", "test"):
        js, ts = getattr(j, split), getattr(t, split)
        for f in ("eid", "spikes", "behavior", "choice", "block", "reward",
                  "neuron_regions", "neuron_depths", "binsize",
                  "target_names"):
            _assert_same(getattr(js, f), getattr(ts, f), f"{split}.{f}")


@pytest.mark.parametrize("kw", [
    dict(max_time_length=20, max_space_length=24),
    dict(max_time_length=25, max_space_length=30, pad_to_right=False),
    dict(max_time_length=15, max_space_length=10, sort_by_depth=True),
    dict(max_time_length=20, max_space_length=40, sort_by_region=True),
    dict(max_time_length=20, max_space_length=24, brain_region="DG"),
])
def test_prepare_split_matches_jax(kw):
    sess = jsession.synthetic_session(seed=1, n_trials=12, n_neurons=24,
                                      n_timesteps=20)
    tsess = tsession.synthetic_session(seed=1, n_trials=12, n_neurons=24,
                                       n_timesteps=20)
    _assert_same(jloader.prepare_split(sess, **kw),
                 tloader.prepare_split(tsess, **kw))


def test_loader_batches_match_jax():
    """Trial order, last-batch padding (masks zeroed), keys and n_real."""
    kw = dict(batch_size=8, max_time_length=20, max_space_length=26,
              target=["whisker-motion-energy"])
    j = jloader.make_loader(
        jsession.synthetic_session(seed=2, n_trials=20, n_neurons=24,
                                   n_timesteps=20), shuffle=False, **kw)
    t = tloader.make_loader(
        tsession.synthetic_session(seed=2, n_trials=20, n_neurons=24,
                                   n_timesteps=20), shuffle=False, **kw)
    jb, tb = list(j), list(t)
    assert len(jb) == len(tb) == len(t) == 3
    for a, b in zip(jb, tb):
        for k in a:
            if k == "nemo_rep":
                assert np.isnan(a[k]).all() and np.isnan(b[k]).all()
            else:
                _assert_same(a[k], b[k], k)
        assert a.keys() == b.keys()


def test_heldout_and_metrics_copies_match_jax():
    rng = np.random.default_rng(4)
    spikes = rng.poisson(1.0, (6, 10, 8)).astype(np.float32)
    regions = np.array(["A"] * 3 + ["B"] * 5)
    for kw in (dict(mode="manual", heldout_idxs=np.array([1, 4])),
               dict(mode="most", n_active=3),
               dict(mode="forward_pred", heldout_idxs=np.array([7, 8, 9])),
               dict(mode="inter_region", heldout_idxs=np.arange(3),
                    target_regions=["A"], neuron_regions=regions),
               dict(mode="intra_region", heldout_idxs=np.array([0]),
                    target_regions=["B"], neuron_regions=regions)):
        _assert_same(jheldout.heldout_mask(spikes, **kw),
                     theldout.heldout_mask(spikes, **kw), kw["mode"])
    rates = rng.random(spikes.shape) + 0.1
    assert tmetrics.bits_per_spike(rates, spikes) == \
        jmetrics.bits_per_spike(rates, spikes)
    X = jmetrics.create_behavior_conditions(
        rng.choice([-1.0, 1.0], 6), rng.choice([0.0, 1.0], 6),
        rng.choice([0.2, 0.8], 6), T=10)
    args = (X[0], spikes[:, :, 0], rates[:, :, 0], X[2], X[1])
    assert tmetrics.psth_and_trial_r2(*args) == \
        jmetrics.psth_and_trial_r2(*args)


@pytest.fixture(scope="module")
def shared():
    """JAX model (Pallas attention, interpret mode) + the port model on
    its converted weights + both loaders over the same test split."""
    channels = {"ap": N_SPACE, "behavior": 2}
    jmodel, jparams = jax_model(seed=5, n_channels=channels)
    # shrink the heads so that predicted rates sit near the data's (an
    # untrained head's R² is in the -1000s, where f32 rounding alone
    # exceeds 1e-4 absolute); both sides get these weights
    for mod, bias in (("ap", np.log(0.3)), ("behavior", 0.0)):
        head = jparams[f"out_proj_{mod}"]
        head["kernel"] = head["kernel"] * np.float32(0.05)
        head["bias"] = np.full_like(head["bias"], bias)
    tmodel = port_model(jparams, n_channels=channels)
    kw = dict(batch_size=20, max_time_length=T, max_space_length=N_SPACE)
    split_kw = dict(seed=0, n_trials=200, n_neurons=N_AP, n_timesteps=T)
    jl = jloader.make_loader(jsession.synthetic_splits(**split_kw).test,
                             shuffle=False, **kw)
    tl = tloader.make_loader(tsession.synthetic_splits(**split_kw).test,
                             shuffle=False, **kw)
    return jmodel, jparams, tmodel, jl, tl


MODES = ("per_neuron", "forward_pred", "inter_region", "intra_region",
         "modal_spike", "modal_behavior")


@pytest.mark.parametrize("use_mtm", [True, False], ids=["mtm", "no_mtm"])
@pytest.mark.parametrize("mode", MODES)
def test_co_smoothing_eval_matches_jax(shared, mode, use_mtm, tmp_path):
    jmodel, jparams, tmodel, jl, tl = shared
    held = HELD if mode in ("forward_pred", "modal_spike",
                            "modal_behavior") else None
    kw = dict(use_mtm=use_mtm, n_time_steps=T, held_out_list=held, chunk=8)
    want = jharness.co_smoothing_eval(jmodel, jparams, jl, mode,
                                      save_path=str(tmp_path / "j"), **kw)
    got = tharness.co_smoothing_eval(tmodel, tl, mode,
                                     save_path=str(tmp_path / "t"), **kw)
    if mode == "modal_behavior":
        want, got = want[f"{mode}_behav_results"], got[f"{mode}_behav_results"]
    assert want.keys() == got.keys()
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], atol=ATOL, rtol=0)
    for name in ("bps.npy", "r2.npy"):
        a = np.load(tmp_path / "j" / name, allow_pickle=True)
        b = np.load(tmp_path / "t" / name, allow_pickle=True)
        assert a.shape == b.shape, name
        if mode == "modal_behavior":
            continue                      # a pickled dict / a NaN scalar
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0, err_msg=name)
        assert np.isfinite(a).any()


def test_save_plot_not_ported(shared, tmp_path):
    """``save_plot``, ported since: per_neuron draws JAX's figures, the
    first ``max_plots`` neurons under JAX's names, from the same weights
    (JAX's Pallas attention in interpret mode); the results are those of a
    run without figures."""
    jmodel, jparams, tmodel, jl, tl = shared
    kw = dict(n_time_steps=T, save_plot=True, max_plots=2,
              method_name="mm")
    jharness.co_smoothing_eval(jmodel, jparams, jl, "per_neuron",
                               save_path=str(tmp_path / "j"), **kw)
    got = tharness.co_smoothing_eval(tmodel, tl, "per_neuron",
                                     save_path=str(tmp_path / "t"), **kw)
    names = sorted(p.name for p in (tmp_path / "t").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("*.png"))
    assert len(names) == 2 and all(n.endswith("_mm.png") for n in names)
    np.testing.assert_equal(got, tharness.co_smoothing_eval(
        tmodel, tl, "per_neuron", save_path=str(tmp_path / "n"),
        n_time_steps=T))


def test_sweep_keeps_variants_apart(shared):
    """Chunked sweep == one forward per variant, for every chunk size."""
    _, _, tmodel, _, tl = shared
    batch = next(iter(tl))
    visible = np.ones((5, N_SPACE), np.float32)
    visible[np.arange(5), np.arange(5)] = 0.0
    fwd = tharness.EvalForward(tmodel, batch, chunk=1)
    one_by_one = fwd.sweep(visible, np.arange(5), use_mtm=True)
    for chunk in (2, 5):
        fwd.chunk = chunk
        torch.testing.assert_close(
            torch.from_numpy(fwd.sweep(visible, np.arange(5), use_mtm=True)),
            torch.from_numpy(one_by_one), atol=1e-5, rtol=0)
