"""The port's hub reader, multi-session assembly and NEMO filter against
the JAX package's, and the real-data slice as a whole.

- ``_rows_to_session`` on the hub's columns (as ``ds[split][:]`` returns
  them: nested lists), with and without depths and ``binsize``;
  ``load_ibl_session`` through a stand-in ``datasets`` module in
  ``sys.modules`` (``chip_smoke.hub_stand_in``: nothing is downloaded),
  aligned and unaligned, and its ``ImportError`` without the package.
- ``load_ibl_dataset`` in every split method and mode with the same
  injected loaders on both sides: the same eids, arrays and meta.
- ``load_nemo_units``, ``prepare_split(unit_filter=)`` and
  ``make_loader(use_nemo=True)``; both packages refuse ``use_nemo`` on a
  hub session (``_rows_to_session`` keeps no ``cluster_uuids``).
- ``FactorsProjection`` on JAX's weights.
- The slice: a raw session from a seed (``chip_smoke.raw_session``)
  through each package's ETL, hub rows, ``load_ibl_dataset`` and
  ``make_loader`` gives the same arrays, and a deterministic training
  lockstep (dropout 0, the co-smooth / forward-pred menu, 16 AdamW
  updates) agrees at the single-session lockstep's gates (losses rtol
  2e-5, parameters atol 2e-5; ``tests/test_torch_trainer.py``).

Every comparison is exact unless its docstring names the float op whose
order differs.
"""

import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import TOY
from multi_modal_foundation_model_tpu.data import etl as jetl
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.data import sparse as jsparse
from multi_modal_foundation_model_tpu.models import layers as jlayers
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.data import etl as tetl
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.data import sparse as tsparse
from multi_modal_foundation_model_tpu_torch.models import layers as tlayers
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops.masking import (
    MaskParams as TMP)
from multi_modal_foundation_model_tpu_torch.train import (
    MultiModalTrainer, OptimizerConfig, TrainerConfig)
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    factors_projection_params_from_jax, params_from_jax)

SESSION_FIELDS = ("eid", "spikes", "behavior", "choice", "block", "reward",
                  "neuron_regions", "neuron_depths", "binsize",
                  "target_names", "cluster_uuids")
# the slice's toy session: 24 of 28 clusters kept, 20 bins of 20 ms
N_AP, T = TOY["n_channels"]["ap"], TOY["max_F"]
WINDOW = (-0.1, 0.3)
RAW = dict(n_clusters=28, n_kept=N_AP, n_trials=100)


def assert_same_session(a, b):
    for f in SESSION_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def assert_same_splits(a, b):
    for split in ("train", "val", "test"):
        assert_same_session(getattr(a, split), getattr(b, split))


def assert_same_dataset(got, want):
    """Two ``load_ibl_dataset`` results: (train, val, test, meta)."""
    for g, w in zip(got[:3], want[:3]):
        assert (g is None) == (w is None)
        if g is not None:
            assert list(g) == list(w)
            for e in g:
                assert_same_splits(g[e], w[e])
    assert got[3] == want[3]


def _rows(seed=0, eid="etl-0", etl=tetl, sparse=tsparse, **raw_over):
    raw = chip_smoke.raw_session(seed=seed, **{**RAW, **raw_over})
    rows, _, counts = chip_smoke.etl_rows(raw, eid, etl, sparse,
                                          window=WINDOW)
    return rows, counts


@pytest.fixture(scope="module")
def rows():
    return _rows()[0]


# ---------------------------------------------------------------------------
# the hub's rows
# ---------------------------------------------------------------------------

def _variants(rows):
    r = rows["train"]
    no_depth = {k: v for k, v in r.items() if k != "cluster_depths"}
    none_depth = dict(r, cluster_depths=[None] * len(r["choice"]))
    no_binsize = {k: v for k, v in r.items() if k != "binsize"}
    return {"full": r, "no_depths": no_depth, "none_depths": none_depth,
            "no_binsize": no_binsize,
            "binsize_50ms": dict(r, binsize=[0.05] * len(r["choice"]))}


@pytest.mark.parametrize("variant", ["full", "no_depths", "none_depths",
                                     "no_binsize", "binsize_50ms"])
def test_rows_to_session_matches_jax(rows, variant):
    r = _variants(rows)[variant]
    got = tsession._rows_to_session(r, "etl-0")
    assert_same_session(got, jsession._rows_to_session(r, "etl-0"))
    assert got.spikes.shape == (len(r["choice"]), T, N_AP)
    assert got.cluster_uuids is None       # as in JAX: the rows' uuids drop
    if variant in ("no_depths", "none_depths"):
        assert np.isnan(got.neuron_depths).all()
    targets = ("whisker-motion-energy",)
    assert_same_session(tsession._rows_to_session(r, "x", targets),
                        jsession._rows_to_session(r, "x", targets))


@pytest.mark.parametrize("aligned", [True, False])
def test_load_ibl_session_through_a_datasets_stand_in(rows, aligned):
    suffix = "aligned" if aligned else "unaligned"
    kw = dict(org="org-x", aligned=aligned, cache_dir="unused")
    with chip_smoke.hub_stand_in({f"org-x/etl-0_{suffix}": rows}) as hub:
        got = tsession.load_ibl_session("etl-0", **kw)
        assert_same_splits(got, jsession.load_ibl_session("etl-0", **kw))
        assert hub.loaded == [f"org-x/etl-0_{suffix}"] * 2
        with pytest.raises(FileNotFoundError):       # no other dataset
            tsession.load_ibl_session("etl-9", **kw)


def test_load_ibl_session_without_datasets_raises(monkeypatch):
    """No fallback: without the package, loading raises ``ImportError``
    (and returns no synthetic session)."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    for mod in (tsession, jsession):
        with pytest.raises(ImportError):
            mod.load_ibl_session("etl-0")


# ---------------------------------------------------------------------------
# load_ibl_dataset: the split machinery
# ---------------------------------------------------------------------------

EIDS = [f"eid{i:02d}" for i in range(4)]


def _hub(mod, failing=()):
    """(load_session, list_datasets) over synthetic sessions of 16 + 8 i
    neurons, 37 trials (bit-identical in both packages)."""
    def load_session(e):
        if e in failing:
            raise IOError("hub down")
        i = EIDS.index(e)
        return mod.synthetic_splits(seed=100 + i, n_trials=37,
                                    n_neurons=16 + 8 * i, n_timesteps=10)

    def list_datasets(org):
        return [f"{org}/{e}_aligned" for e in EIDS] + [
            f"{org}/{EIDS[0]}_unaligned"]
    return dict(_load_session=load_session, _list_datasets=list_datasets)


DATASET_CASES = {
    "predefined": dict(num_sessions=2, batch_size=8),
    "predefined_all": dict(num_sessions=4, batch_size=4),
    "eids": dict(eids=[EIDS[2], EIDS[0]], num_sessions=2),
    "eid": dict(eid=EIDS[1]),
    "train_session_eid": dict(train_session_eid=[EIDS[3], EIDS[1]],
                              num_sessions=2),
    "random_split": dict(num_sessions=3, split_method="random_split",
                         split_size=0.2, seed=7),
    "random_split_default": dict(num_sessions=2,
                                 split_method="random_split"),
    "session_based": dict(num_sessions=4, split_method="session_based",
                          test_session_eid=[EIDS[3]]),
    "eval_mode": dict(mode="eval", num_sessions=2,
                      split_method="session_based",
                      test_session_eid=[EIDS[1], EIDS[2]]),
    "zero_train_sessions": dict(num_sessions=1, split_method="session_based",
                                test_session_eid=[EIDS[2]]),
    "unaligned": dict(num_sessions=3, train_aligned=False, batch_size=4),
    "skips_failing": dict(num_sessions=3, failing=(EIDS[1],)),
    "use_re": dict(num_sessions=4, use_re=True),
}


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_load_ibl_dataset_matches_jax(case, tmp_path):
    kw = dict(DATASET_CASES[case])
    failing = kw.pop("failing", ())
    if kw.get("use_re"):
        allow, deny = tmp_path / "allow.txt", tmp_path / "deny.txt"
        allow.write_text("\n".join(EIDS[:3]) + "\n")
        deny.write_text(EIDS[1] + "\n")
        kw.update(target_eids_path=str(allow), test_re_eids_path=str(deny))
    got = tsession.load_ibl_dataset(None, **kw, **_hub(tsession, failing))
    want = jsession.load_ibl_dataset(None, **kw, **_hub(jsession, failing))
    assert_same_dataset(got, want)
    expected_eids = {
        "predefined": EIDS[:2], "eids": [EIDS[2], EIDS[0]],
        "eid": [EIDS[1]], "unaligned": [EIDS[0]],
        "skips_failing": [EIDS[0], EIDS[2]], "use_re": [EIDS[0], EIDS[2]],
        "zero_train_sessions": [EIDS[2]]}.get(case)
    if expected_eids is not None:
        assert got[3]["eids"] == expected_eids


@pytest.mark.parametrize("kw,exc", [
    (dict(split_method="random_split", test_session_eid=[EIDS[0]]),
     AssertionError),
    (dict(num_sessions=1, split_method="session_based",
          test_session_eid=[EIDS[1], EIDS[2]]), AssertionError),
    (dict(split_method="by_subject"), ValueError)], ids=[
        "random_split_with_test_sessions", "negative_budget",
        "unknown_split_method"])
def test_load_ibl_dataset_refusals_match_jax(kw, exc):
    for mod in (tsession, jsession):
        with pytest.raises(exc):
            mod.load_ibl_dataset(None, **kw, **_hub(mod))


def test_merge_and_truncate_match_jax():
    t = tsession.synthetic_splits(seed=3, n_trials=37, n_neurons=9,
                                  n_timesteps=6)
    j = jsession.synthetic_splits(seed=3, n_trials=37, n_neurons=9,
                                  n_timesteps=6)
    assert_same_session(tsession._merge_session([t.train, t.val, t.test]),
                        jsession._merge_session([j.train, j.val, j.test]))
    for bs in (1, 4, 8, 64):
        assert_same_session(tsession._truncate_to_batch(t.train, bs),
                            jsession._truncate_to_batch(j.train, bs))
    assert tsession._session_meta({"a": t}) == jsession._session_meta(
        {"a": j})


# ---------------------------------------------------------------------------
# the NEMO unit filter
# ---------------------------------------------------------------------------

def _nemo_session(mod, N=12):
    sess = mod.synthetic_session(seed=3, n_trials=10, n_neurons=N,
                                 n_timesteps=8)
    uuids = np.array([f"uuid-{i:03d}" for i in range(N)])
    return dataclasses.replace(sess, cluster_uuids=uuids), uuids


@pytest.fixture
def nemo_pkl(tmp_path):
    rng = np.random.default_rng(0)
    table = np.array(["uuid-009", "uuid-002", "uuid-005", "uuid-007",
                      "uuid-999"])
    path = tmp_path / "MtM_unit_embed.pkl"
    with open(path, "wb") as f:
        pickle.dump({"uuids": table,
                     "wvf_rep": rng.normal(size=(5, 4)).astype(np.float32),
                     "acg_rep": rng.normal(size=(5, 3)).astype(np.float32)},
                    f)
    return str(path)


def test_load_nemo_units_matches_jax(nemo_pkl):
    _, uuids = _nemo_session(tsession)
    got = tloader.load_nemo_units(nemo_pkl, uuids)
    want = jloader.load_nemo_units(nemo_pkl, uuids)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [2, 5, 7, 9])
    assert got[1].shape == (4, 7)


@pytest.mark.parametrize("unit_filter", [
    np.array([1, 3, 5, 11]),
    np.arange(12) % 3 == 0], ids=["indices", "mask"])
@pytest.mark.parametrize("extra", [{}, dict(sort_by_depth=True),
                                   dict(brain_region="CA1")],
                         ids=["plain", "by_depth", "one_region"])
def test_prepare_split_unit_filter_matches_jax(unit_filter, extra):
    t, _ = _nemo_session(tsession)
    j, _ = _nemo_session(jsession)
    kw = dict(max_time_length=8, max_space_length=12, unit_filter=unit_filter,
              **extra)
    got = tloader.prepare_split(t, **kw)
    want = jloader.prepare_split(j, **kw)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_make_loader_use_nemo_matches_jax(nemo_pkl):
    """The space axis narrows to the kept units and every batch carries
    the table's representation rows, as in JAX."""
    t, _ = _nemo_session(tsession)
    j, _ = _nemo_session(jsession)
    kw = dict(batch_size=4, max_time_length=8, max_space_length=12,
              use_nemo=True, nemo_path=nemo_pkl, seed=5)
    got = list(tloader.make_loader(t, **kw))
    want = list(jloader.make_loader(j, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    assert got[0]["spikes_data"].shape == (4, 8, 4)
    assert got[0]["nemo_rep"].shape == (4, 7)
    for mod, sess in ((tloader, t), (jloader, j)):
        with pytest.raises(AssertionError, match="unit_filter"):
            mod.make_loader(sess, unit_filter=np.arange(3), **kw)


def test_use_nemo_refuses_a_hub_session_in_both(rows, nemo_pkl):
    """A session from the hub has no ``cluster_uuids`` (JAX
    ``data/session.py:179-210``), so ``use_nemo`` asserts (JAX
    ``data/loader.py:434``): kept as a known JAX quirk."""
    for sess_mod, loader_mod in ((tsession, tloader), (jsession, jloader)):
        sess = sess_mod._rows_to_session(rows["train"], "etl-0")
        with pytest.raises(AssertionError, match="cluster_uuids"):
            loader_mod.make_loader(sess, batch_size=4, max_time_length=T,
                                   max_space_length=N_AP, use_nemo=True,
                                   nemo_path=nemo_pkl)


def test_make_loader_flags_match_jax():
    """``load_meta`` is accepted and unread, ``stitching`` picks the
    stitch sampler, as in JAX; the batches are equal."""
    t = tsession.synthetic_session(seed=1, n_trials=24, n_neurons=8,
                                   n_timesteps=8)
    j = jsession.synthetic_session(seed=1, n_trials=24, n_neurons=8,
                                   n_timesteps=8)
    kw = dict(batch_size=5, max_time_length=8, max_space_length=8,
              load_meta=False, stitching=True)
    got, want = tloader.make_loader(t, **kw), jloader.make_loader(j, **kw)
    assert got.sampler == want.sampler == "stitch"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["spikes_data"], w["spikes_data"])


def test_pad_helpers_match_jax():
    rng = np.random.default_rng(0)
    seq = rng.normal(size=(3, 4))
    for name, args in (("pad_seq_right_to_n", (5, -1.0)),
                       ("pad_seq_left_to_n", (5, 0.5)),
                       ("wrap_pad_temporal_right_to_n", (7,)),
                       ("wrap_pad_neuron_up_to_n", (9,))):
        np.testing.assert_array_equal(getattr(tloader, name)(seq, *args),
                                      getattr(jloader, name)(seq, *args))


# ---------------------------------------------------------------------------
# FactorsProjection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,bias,active", [
    ("relu", True, True), ("gelu", False, True), ("tanh", True, False)])
def test_factors_projection_on_jax_weights(act, bias, active):
    """Eval forward on JAX's weights, loaded with ``strict=True``. One f32
    GEMM whose sums run in other orders: within 1e-6 of the output's
    largest magnitude."""
    x = np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    jmod = jlayers.FactorsProjection(hidden_size=16, size=6, act=act,
                                     use_bias=bias, dropout=0.3,
                                     active=active)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)).get(
        "params", {})
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tlayers.FactorsProjection(16, 6, act=act, use_bias=bias,
                                     dropout=0.3, active=active)
    tmod.load_state_dict(factors_projection_params_from_jax(params),
                         strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_factors_projection_init_and_dropout():
    """The reference's init (U(+-init_range), zero bias); layer dropout
    draws only with a seed."""
    m = tlayers.FactorsProjection(64, 32, dropout=0.5, init_range=0.02,
                                  generator=torch.Generator().manual_seed(0))
    assert m.proj.weight.abs().max() <= 0.02 and m.proj.weight.min() < 0
    assert (m.proj.bias == 0).all()
    x = torch.ones(2, 64)
    torch.testing.assert_close(m(x), m(x), rtol=0, atol=0)
    dropped = m(x, seeds=torch.tensor([7]))
    assert not torch.equal(dropped, m(x))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_etl_rows_match_jax_and_the_hub_schema():
    """A raw session from a seed through each package's ETL: the same hub
    rows (and the schema ``create_dataset`` writes)."""
    got, counts = _rows(seed=4)
    want, _ = _rows(seed=4, etl=jetl, sparse=jsparse)
    assert got == want
    assert counts["clusters_kept"] == N_AP
    assert counts["trials_aligned"] == RAW["n_trials"] - 3   # NaN trials
    pytest.importorskip("datasets")
    from multi_modal_foundation_model_tpu_torch.data import dataset

    r = got["test"]
    spikes = tsparse.sparse_rows_to_dense(
        r["spikes_sparse_data"], r["spikes_sparse_indices"],
        r["spikes_sparse_indptr"], r["spikes_sparse_shape"])
    ds = dataset.create_dataset(
        spikes, "etl-0", {"binsize": 0.02, "interval_len": 0.4},
        meta_data={"eid": "etl-0", "cluster_regions": r["cluster_regions"][0],
                   "cluster_depths": r["cluster_depths"][0],
                   "uuids": r["cluster_uuids"][0]},
        binned_behaviors={k: np.asarray(r[k]) for k in (
            "wheel-speed", "whisker-motion-energy", "choice", "reward",
            "block")})[:]
    for k, v in r.items():
        assert ds[k] == v, k


def _slice_loaders(mod_session, mod_loader, rows):
    sessions = {"etl-0": mod_session.SessionSplits(**{
        s: mod_session._rows_to_session(r, "etl-0")
        for s, r in rows.items()})}
    train, val, test, meta = mod_session.load_ibl_dataset(
        None, num_sessions=1, batch_size=8,
        _load_session=sessions.__getitem__,
        _list_datasets=lambda org: [f"{org}/etl-0_aligned"])
    sp = train["etl-0"]
    kw = dict(batch_size=8, max_time_length=T, max_space_length=N_AP)
    return (mod_loader.make_loader(sp.train, **kw),
            mod_loader.make_loader(sp.val, shuffle=False, **kw), meta)


def test_etl_session_makes_the_same_loader_arrays(rows):
    t_train, t_val, t_meta = _slice_loaders(tsession, tloader, rows)
    j_train, j_val, j_meta = _slice_loaders(jsession, jloader, rows)
    assert t_meta == j_meta and t_meta["num_neurons"] == [N_AP]
    for got, want in ((t_train, j_train), (t_val, j_val)):
        assert got.arrays.keys() == want.arrays.keys()
        for k in got.arrays:
            if isinstance(got.arrays[k], np.ndarray):
                np.testing.assert_array_equal(got.arrays[k],
                                              want.arrays[k], err_msg=k)
            else:
                assert got.arrays[k] == want.arrays[k], k
    assert t_train.n_trials == 64 and len(t_train) == 8


MASK = dict(channels=(1, 5, 20, 23), timesteps=(12, 15, 19))
MENU = ("co-smooth", "forward-pred")
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5


def _tcfg(cls, tmp):
    return cls(num_epochs=2, log_dir=str(tmp), seed=0, mask_type="input",
               mask_mode=MENU, mixed_training=True, eval_every=10 ** 9)


def test_etl_session_training_lockstep_with_jax(rows, tmp_path):
    """Two epochs (16 AdamW updates at lr 1e-3, dropout 0, the
    deterministic co-smooth / forward-pred menu with mixed objectives) on
    the ETL'd session from the same initial weights: per-step losses
    within rtol 2e-5 and the final parameters within atol 2e-5 (f32 sums in
    other orders); the attention key biases are left out, as in
    ``tests/test_torch_trainer.py`` (their exact gradient is 0)."""
    j_train, j_val, _ = _slice_loaders(jsession, jloader, rows)
    cfg = jmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=JMP(**MASK))
    jtr = jtrainer.MultiModalTrainer(
        jmm.MultiModal(cfg), j_train, j_val, JOC(lr=1e-3),
        _tcfg(jtrainer.TrainerConfig, tmp_path / "j"))
    init = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    jlosses, jmodes = [], []
    get_step, sample = jtr._get_train_step, jtr._sample_modes

    def recording(training_mode, use_mtm):
        step = get_step(training_mode, use_mtm)

        def run(*args):
            state, loss = step(*args)
            jlosses.append(float(loss))
            return state, loss
        return run

    jtr._get_train_step = recording
    jtr._sample_modes = lambda: jmodes.append(sample()) or jmodes[-1]
    for epoch in range(2):
        jtr.train_epoch(epoch)
    jfinal = jax.tree_util.tree_map(np.asarray, jtr.state.params)

    t_train, t_val, _ = _slice_loaders(tsession, tloader, rows)
    tcfg = tmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                                mask_params=TMP(**MASK))
    model = tmm.MultiModal(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(init, tcfg))
    tr = MultiModalTrainer(model, t_train, t_val, OptimizerConfig(lr=1e-3),
                           _tcfg(TrainerConfig, tmp_path / "t"))
    modes, sample_t = [], tr._sample_modes
    tr._sample_modes = lambda: modes.append(sample_t()) or modes[-1]
    losses = []
    for epoch in range(2):
        losses += tr.train_epoch(epoch)["step_losses"]
    assert modes == jmodes and len(losses) == 16
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    want = params_from_jax(jfinal, tcfg)
    for name, p in tr.model.state_dict().items():
        if name.endswith("key.bias"):
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
