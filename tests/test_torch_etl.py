"""The port's ETL and dataset layer (``data/etl.py``, ``data/dataset.py``)
against the JAX package's, on the same seeded numpy inputs.

Both packages run the same numpy on float64 times, so every comparison is
exact (``assert_array_equal``, ``==`` on lists and frames): the binning,
the trials mask (on pandas frames), the behavior interpolation and its
quality gates, alignment, probe merging, the region selection, the
network wrappers over the fake ONE / brainbox / iblatlas stack of
``tests/test_etl_network_seam.py`` (installed in ``sys.modules`` for both
packages) and ``prepare_data`` with its default and injected loaders, then
``create_dataset`` (``datasets``, no hub), ``get_data_from_h5`` on h5 files
written here and ``split_both_dataset``.
"""

import types

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.data import dataset as jdataset
from multi_modal_foundation_model_tpu.data import etl as jetl
from multi_modal_foundation_model_tpu_torch.data import dataset as tdataset
from multi_modal_foundation_model_tpu_torch.data import etl as tetl
from tests.test_etl import (_FakeSessionLoader, _fake_spiking_loader,
                            _fake_trials_df)
from tests.test_etl_network_seam import EID, fake_ibl_stack  # noqa: F401

pd = pytest.importorskip("pandas")


def _equal(a, b):
    """Exact equality of nested ETL outputs (arrays, object arrays of
    arrays or None, dicts, lists, tuples, frames, scalars)."""
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)) or (
            isinstance(a, np.ndarray) and a.dtype == object):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _spiking(seed=0, n=6000, n_clu=14, t_end=100.0):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, t_end, n))
    return times, rng.integers(0, n_clu, n)


def test_intervals_match_jax():
    _equal(tetl.create_intervals(0.0, 10.0, 2.0),
           jetl.create_intervals(0.0, 10.0, 2.0))
    _equal(tetl.create_intervals(0.3, 7.1, 0.02),
           jetl.create_intervals(0.3, 7.1, 0.02))
    align = np.random.default_rng(1).uniform(0, 90, 25)
    _equal(tetl.trial_intervals(align, (-0.5, 1.5)),
           jetl.trial_intervals(align, (-0.5, 1.5)))


@pytest.mark.parametrize("binsize", [0.02, 0.05])
def test_bin_spikes_per_interval_matches_jax(binsize):
    """Overlapping intervals, a NaN interval, an unknown cluster id list."""
    times, clusters = _spiking()
    starts = np.sort(np.random.default_rng(2).uniform(0, 95, 30))
    intervals = np.c_[starts, starts + 2.0]
    intervals[4] = np.nan
    for ids in (None, np.array([1, 3, 5, 99])):
        _equal(tetl.bin_spikes_per_interval(times, clusters, intervals,
                                            binsize, cluster_ids=ids),
               jetl.bin_spikes_per_interval(times, clusters, intervals,
                                            binsize, cluster_ids=ids))


def test_spike_counts_and_bin_spiking_data_match_jax():
    times, clusters = _spiking(seed=3)
    intervals = tetl.create_intervals(0.0, 90.0, 0.5)
    _equal(tetl.get_spike_counts_in_bins(times, clusters, intervals),
           jetl.get_spike_counts_in_bins(times, clusters, intervals))
    align = np.sort(np.random.default_rng(4).uniform(1, 95, 20))
    for kw in (dict(align_times=align),
               dict(intervals=np.c_[align - 0.2, align + 0.8])):
        _equal(tetl.bin_spiking_data([1, 2, 7, 11], times, clusters, **kw,
                                     time_window=(-0.5, 1.5), binsize=0.02),
               jetl.bin_spiking_data([1, 2, 7, 11], times, clusters, **kw,
                                     time_window=(-0.5, 1.5), binsize=0.02))


def _trials_frame():
    return pd.DataFrame({
        "stimOn_times": [1.0, 2.0, 3.0, np.nan, 5.0, 6.0],
        "firstMovement_times": [1.1, 2.01, 5.5, 4.2, 5.3, 6.4],
        "feedback_times": [1.5, 2.5, 6.0, 4.5, 5.6, 17.0],
        "goCue_times": [0.9, 1.9, 2.9, 3.9, 4.9, 5.9],
        "choice": [1, -1, 1, 1, 0, -1],
        "probabilityLeft": [0.2, 0.5, 0.8, 0.5, 0.2, 0.5],
        "feedbackType": [1, 1, 1, 1, 1, -1],
    })


@pytest.mark.parametrize("kw", [
    {}, dict(min_rt=None, max_rt=None), dict(max_trial_len=10.0),
    dict(min_trial_len=0.7, exclude_unbiased=True, exclude_nochoice=False),
    dict(nan_exclude=("stimOn_times",))], ids=str)
def test_trials_mask_matches_jax(kw):
    df = _trials_frame()
    _equal(tetl.trials_mask(df, **kw), jetl.trials_mask(df, **kw))


def test_interpolation_matches_jax():
    """Every quality gate, a 2-column signal, and ``_interp_extrap``'s
    edge extrapolation."""
    t = np.arange(0.0, 10.0, 0.01)
    v = np.sin(t)
    v[300:305] = np.nan
    intervals = np.array([[1.0, 3.0], [20.0, 22.0], [np.nan, np.nan],
                          [2.5, 4.5], [-1.0, 1.0], [9.0, 11.0]])
    for allow in (False, True):
        _equal(tetl.interpolate_behavior_per_interval(
                   t, v, intervals, binsize=0.02, allow_nans=allow),
               jetl.interpolate_behavior_per_interval(
                   t, v, intervals, binsize=0.02, allow_nans=allow))
    two = np.c_[np.sin(t), np.cos(t)]
    _equal(tetl.interpolate_behavior_per_interval(t, two, intervals[:1],
                                                  0.02),
           jetl.interpolate_behavior_per_interval(t, two, intervals[:1],
                                                  0.02))
    x = np.linspace(-0.5, 10.5, 57)
    _equal(tetl._interp_extrap(x, t, np.cos(t)),
           jetl._interp_extrap(x, t, np.cos(t)))


def _behavior_frame():
    return pd.DataFrame({
        "stimOn_times": [1.0, 10.0, 45.0, 49.0],
        "choice": [1, -1, 1, -1],
        "probabilityLeft": [0.2, 0.5, 0.8, 0.5],
        "rewardVolume": [2.0, 0.0, 2.0, 1.5],
        "contrastLeft": [np.nan, 0.5, np.nan, 0.25],
        "contrastRight": [0.25, np.nan, 1.0, np.nan],
    })


def test_bin_behaviors_and_align_match_jax():
    """A trials frame with and without a mask, intervals alone, a trial
    whose window runs past the data, and the intersected masks of
    ``align_spike_behavior``."""
    t = np.arange(0.0, 50.0, 0.01)
    signals = {"whisker-motion-energy": (t, np.cos(t)),
               "wheel-speed": (t, np.abs(np.sin(t)))}
    df = _behavior_frame()
    mask = np.array([True, False, True, True])
    for kw in (dict(trials_df=df), dict(trials_df=df, mask=mask),
               dict(intervals=np.array([[0.5, 2.5], [9.5, 11.5]]))):
        got = tetl.bin_behaviors(signals, time_window=(-0.5, 1.5),
                                 binsize=0.02, **kw)
        _equal(got, jetl.bin_behaviors(signals, time_window=(-0.5, 1.5),
                                       binsize=0.02, **kw))
    behave, masks = tetl.bin_behaviors(signals, trials_df=df)
    assert masks["wheel-speed"].tolist() == [True, True, True, False]
    spikes = np.random.default_rng(5).poisson(1.0, (4, 100, 3))
    for trials_mask in (None, [1, 1, 0, 1]):
        got = tetl.align_spike_behavior(spikes, behave,
                                        trials_mask=trials_mask)
        _equal(got, jetl.align_spike_behavior(spikes, behave,
                                              trials_mask=trials_mask))
    assert got[0].shape[0] == 2         # trial 2 masked, trial 3 no data


def test_merge_probes_and_regions_match_jax(fake_ibl_stack):  # noqa: F811
    s1 = {"times": np.array([0.1, 0.5]), "clusters": np.array([0, 1])}
    c1 = pd.DataFrame({"acronym": ["CA1", "DG"]})
    s2 = {"times": np.array([0.2, 0.3]), "clusters": np.array([0, 1])}
    c2 = pd.DataFrame({"acronym": ["LP", "PO"]})
    _equal(tetl.merge_probes([s1, s2], [c1, c2]),
           jetl.merge_probes([s1, s2], [c1, c2]))
    acronyms = np.array(["CA1", "DG", "CA1", "LP"])
    for single in (False, True):
        _equal(tetl.list_brain_regions(acronyms, single_region=single),
               jetl.list_brain_regions(acronyms, single_region=single))
    _equal(tetl.select_brain_regions(acronyms, ["CA1", "LP"]),
           jetl.select_brain_regions(acronyms, ["CA1", "LP"]))


def test_network_wrappers_match_jax(fake_ibl_stack):  # noqa: F811
    """``load_spiking_data`` over the fake SpikeSortingLoader, every
    ``load_target_behavior`` branch (and its skip contract), the
    concurrent ``load_anytime_behaviors``, the whisker fallback and the
    trials mask through a fake SessionLoader, on both packages."""
    one = fake_ibl_stack
    _equal(tetl.load_spiking_data(one, "p1", qc=1.0),
           jetl.load_spiking_data(one, "p1", qc=1.0))
    targets = ("left-pupil-diameter", "left-camera-right-paw-speed",
               "right-camera-left-paw-speed", "right-nose-speed",
               "wheel-speed", "wheel-position", "wheel-velocity",
               "left-whisker-motion-energy", "right-whisker-motion-energy")
    for target in targets:
        got = tetl.load_target_behavior(
            one, EID, target, sess_loader=_FakeSessionLoader(
                _fake_trials_df()))
        _equal(got, jetl.load_target_behavior(
            one, EID, target, sess_loader=_FakeSessionLoader(
                _fake_trials_df())))
    broken = types.SimpleNamespace(load_object=_raise)
    assert tetl.load_target_behavior(broken, EID, "left-pupil-diameter") \
        == jetl.load_target_behavior(broken, EID, "left-pupil-diameter")
    for mod in (tetl, jetl):
        with pytest.raises(NotImplementedError):
            mod.load_target_behavior(one, EID, "tail-speed")
    _equal(tetl.load_anytime_behaviors(
               one, EID, sess_loader=_FakeSessionLoader(_fake_trials_df())),
           jetl.load_anytime_behaviors(
               one, EID, sess_loader=_FakeSessionLoader(_fake_trials_df())))
    half = {"broken_views": ("left",)}
    _equal(tetl.collect_behavior_signals(None, EID, sess_loader=(
               _FakeSessionLoader(_fake_trials_df(), **half))),
           jetl.collect_behavior_signals(None, EID, sess_loader=(
               _FakeSessionLoader(_fake_trials_df(), **half))))
    for mod in (tetl, jetl):
        with pytest.raises(RuntimeError, match="failed to load"):
            mod.collect_behavior_signals(None, EID, sess_loader=(
                _FakeSessionLoader(_fake_trials_df(),
                                   broken_views=("left", "right"))))
    for kw in (dict(trials_df=_fake_trials_df()),
               dict(sess_loader=_FakeSessionLoader(_fake_trials_df()))):
        _equal(tetl.load_trials_and_mask(max_trial_len=10.0, **kw),
               jetl.load_trials_and_mask(max_trial_len=10.0, **kw))


def _raise(*a, **k):
    raise IOError("ONE download failed")


def test_loader_lock_is_per_loader():
    a, b = _FakeSessionLoader(_fake_trials_df()), _FakeSessionLoader(
        _fake_trials_df())
    assert tetl._loader_lock(a) is tetl._loader_lock(a)
    assert tetl._loader_lock(a) is not tetl._loader_lock(b)


def _bwm():
    return pd.DataFrame({"eid": [EID, EID], "subject": ["mouse-a"] * 2,
                         "lab": ["lab-x"] * 2, "pid": ["p1", "p2"],
                         "probe_name": ["probe00", "probe01"]})


def test_prepare_data_default_loaders_match_jax(fake_ibl_stack):  # noqa: F811
    """``prepare_data`` with its default hooks over the fake stack."""
    one = fake_ibl_stack
    got = tetl.prepare_data(one, EID, _bwm(), sess_loader=_FakeSessionLoader(
        _fake_trials_df()))
    want = jetl.prepare_data(one, EID, _bwm(),
                             sess_loader=_FakeSessionLoader(
                                 _fake_trials_df()))
    _equal(got, want)


def test_prepare_data_injected_loaders_match_jax():
    """``prepare_data`` with injected loaders (two probes of 6 units drawn
    from one seed on each side), then the full ETL on both packages."""
    trials = _fake_trials_df()

    def run(mod):
        sl = _FakeSessionLoader(trials)
        neural, behave, meta, trials_data = mod.prepare_data(
            None, "e1", _bwm().assign(eid="e1"),
            load_spiking_data_fn=_fake_spiking_loader(
                np.random.default_rng(0)),
            load_trials_fn=lambda one=None, eid=None, max_trial_len=None,
            sess_loader=None: mod.load_trials_and_mask(
                trials_df=trials, max_trial_len=max_trial_len),
            load_behaviors_fn=lambda one, eid, sess_loader=None: {},
            sess_loader=sl)
        binned, _ = mod.bin_spiking_data(
            np.arange(12), neural["spike_times"], neural["spike_clusters"],
            align_times=np.asarray(trials["stimOn_times"]))
        signals = mod.collect_behavior_signals(None, "e1", sess_loader=sl)
        behaves, _ = mod.bin_behaviors(signals, trials_df=trials)
        aligned = mod.align_spike_behavior(
            binned, behaves, trials_mask=trials_data["trials_mask"])
        return neural, behave, meta, trials_data, aligned

    got, want = run(tetl), run(jetl)
    _equal(got, want)
    assert got[4][0].shape[0] >= 16


def test_create_dataset_matches_jax():
    """Hub rows from dense spikes, behaviors and metadata: the same
    ``Dataset`` rows in both packages (``datasets`` builds them in memory;
    nothing is uploaded)."""
    pytest.importorskip("datasets")
    rng = np.random.default_rng(0)
    spikes = rng.poisson(0.5, (6, 10, 8)).astype(np.float32)
    kw = dict(eid="x", params={"binsize": 0.02, "interval_len": 2.0},
              meta_data={"eid": "x", "cluster_regions": ["CA1"] * 8,
                         "cluster_depths": list(np.linspace(0, 1, 8)),
                         "uuids": [f"u{i}" for i in range(8)]},
              binned_behaviors={"choice": np.ones(6),
                                "wheel-speed": rng.normal(size=(6, 10))})
    rows = tdataset.create_dataset(spikes, **kw)[:]
    assert rows == jdataset.create_dataset(spikes, **kw)[:]
    assert rows["cluster_uuids"][0] == [f"u{i}" for i in range(8)]
    assert tdataset.create_dataset(spikes, "x", {})[:] == \
        jdataset.create_dataset(spikes, "x", {})[:]


def _write_h5(path, kind, rng):
    import h5py

    with h5py.File(path, "w") as f:
        if kind == "lfads":
            f["train_data"] = rng.poisson(1.0, (8, 10, 5)).astype(np.float32)
            f["valid_data"] = rng.poisson(1.0, (4, 10, 5)).astype(np.float32)
            f["train_truth"] = rng.uniform(0.5, 2, (8, 10, 5))
            f["valid_truth"] = rng.uniform(0.5, 2, (4, 10, 5))
            f["conversion_factor"] = 2.0
            return
        key = "spikes" if kind == "nlb" else "data"
        for split, n in (("train", 8), ("eval", 4)):
            f[f"{split}_{key}_heldin"] = rng.poisson(1.0, (n, 10, 5))
            f[f"{split}_{key}_heldout"] = rng.poisson(1.0, (n, 10, 3))
            if split == "train" or kind == "nlb":
                f[f"{split}_{key}_heldin_forward"] = rng.poisson(
                    1.0, (n, 4, 5))
                f[f"{split}_{key}_heldout_forward"] = rng.poisson(
                    1.0, (n, 4, 3))


@pytest.mark.parametrize("kind", ["lfads", "nlb", "nlb_data_key"])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_get_data_from_h5_matches_jax(tmp_path, kind, mode):
    pytest.importorskip("h5py")
    path = str(tmp_path / f"{kind}.h5")
    _write_h5(path, kind, np.random.default_rng(0))
    for lograte in (True, False):
        if kind != "lfads" and mode == "test":
            # no NLB split is "test": both fall through to the LFADS keys
            for mod in (tdataset, jdataset):
                with pytest.raises(KeyError, match="train_data"):
                    mod.get_data_from_h5(mode, path, use_lograte=lograte)
            continue
        _equal(tdataset.get_data_from_h5(mode, path, use_lograte=lograte),
               jdataset.get_data_from_h5(mode, path, use_lograte=lograte))


def test_split_both_dataset_matches_jax():
    """The paired aligned/unaligned split: the same aligned train/test
    rows and the same unaligned chunks routed to test (within 2 s of an
    aligned test trial) in both packages."""
    datasets = pytest.importorskip("datasets")
    rng = np.random.default_rng(0)
    aligned = datasets.Dataset.from_dict({
        "intervals": [[float(t), float(t) + 2.0]
                      for t in np.sort(rng.uniform(0, 200, 30))],
        "x": list(range(30))})
    unaligned = datasets.Dataset.from_dict({
        "intervals": [[float(t), float(t) + 2.0]
                      for t in np.arange(0, 200, 2.0)],
        "y": list(range(100))})
    got = tdataset.split_both_dataset(aligned, unaligned, seed=3)
    want = jdataset.split_both_dataset(aligned, unaligned, seed=3)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for split in g:
            assert g[split][:] == w[split][:]
    assert 0 < len(got[1]["test"]) < 100
    with pytest.raises(AssertionError):
        tdataset.split_both_dataset(aligned, unaligned, train_size=0.8,
                                    test_size=0.1)


def test_read_eid_list_matches_jax(tmp_path):
    path = tmp_path / "eids.txt"
    path.write_text("a-1\nb-2  \n\nc-3\n")
    assert tdataset.read_eid_list(str(path)) == \
        jdataset.read_eid_list(str(path))
