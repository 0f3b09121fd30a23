"""Session-level data: dense split arrays and synthetic sessions.

The port's copy of ``multi_modal_foundation_model_tpu/data/session.py:26-172``
and ``:179-415`` (numpy only). ``synthetic_session`` draws the same
numbers in the same order as the JAX package's, so both give bit-identical
arrays for one seed. ``load_ibl_session`` reads one session's hub dataset
(the reference's ``<eid>_aligned`` rows: CSR spike columns, behavior
traces, trial scalars, cluster metadata) through ``datasets``, imported
inside it: without the package it raises ``ImportError``, and it never
falls back to synthetic data. ``load_ibl_dataset`` is JAX's multi-session
assembly with the reference's split machinery.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .sparse import sparse_rows_to_dense

DEFAULT_TARGETS = ("wheel-speed", "whisker-motion-energy")
_REGION_POOL = ("CA1", "DG", "LP", "PO", "VISa", "VISam", "MRN", "APN", "root")


@dataclasses.dataclass
class SessionData:
    """One split of one session as dense arrays.

    Shapes: spikes (K, T, N); behavior (K, T, n_beh); trial scalars (K,);
    neuron metadata (N,).
    """

    eid: str
    spikes: np.ndarray
    behavior: np.ndarray
    choice: np.ndarray
    block: np.ndarray
    reward: np.ndarray
    neuron_regions: np.ndarray
    neuron_depths: np.ndarray
    binsize: float = 0.02
    target_names: Tuple[str, ...] = DEFAULT_TARGETS
    cluster_uuids: Optional[np.ndarray] = None

    @property
    def n_trials(self) -> int:
        return int(self.spikes.shape[0])

    @property
    def n_timesteps(self) -> int:
        return int(self.spikes.shape[1])

    @property
    def n_neurons(self) -> int:
        return int(self.spikes.shape[2])

    def subset(self, idxs: Sequence[int]) -> "SessionData":
        idxs = np.asarray(idxs, dtype=np.int64)
        return dataclasses.replace(
            self,
            spikes=self.spikes[idxs],
            behavior=self.behavior[idxs],
            choice=self.choice[idxs],
            block=self.block[idxs],
            reward=self.reward[idxs],
        )


@dataclasses.dataclass
class SessionSplits:
    train: SessionData
    val: SessionData
    test: SessionData

    @property
    def eid(self) -> str:
        return self.train.eid

    @property
    def n_neurons(self) -> int:
        return self.train.n_neurons


def _smooth(x: np.ndarray, width: int) -> np.ndarray:
    # np.convolve 'same' returns max(len, width) samples — clamp the kernel
    # so short sequences keep their length
    width = min(width, x.shape[-1])
    kernel = np.ones(width) / width
    return np.apply_along_axis(
        lambda r: np.convolve(r, kernel, mode="same"), -1, x)


def synthetic_session(
    seed: int = 0,
    n_trials: int = 200,
    n_timesteps: int = 100,
    n_neurons: int = 64,
    n_behaviors: int = 2,
    n_latents: int = 6,
    eid: Optional[str] = None,
    binsize: float = 0.02,
) -> SessionData:
    """A session with genuine spike<->behavior coupling: latent factors
    drive both Poisson spike rates and the behavior traces."""
    rng = np.random.default_rng(seed)
    if eid is None:
        eid = "synthetic-" + hashlib.sha1(
            f"{seed}-{n_trials}-{n_neurons}".encode()).hexdigest()[:8]

    # trial-level task variables
    choice = rng.choice([-1.0, 1.0], size=n_trials)
    block = rng.choice([0.2, 0.5, 0.8], size=n_trials)
    reward = rng.choice([0.0, 1.0], size=n_trials, p=[0.3, 0.7])

    # smooth latent trajectories, modulated by choice
    latents = _smooth(rng.normal(size=(n_trials, n_latents, n_timesteps)), 9)
    t_axis = np.linspace(0, 1, n_timesteps)
    stim_bump = np.exp(-((t_axis - 0.35) ** 2) / 0.01)
    latents[:, 0] += choice[:, None] * stim_bump[None, :]
    latents[:, 1] += (reward[:, None] * np.clip(t_axis - 0.5, 0, None)[None, :]
                      * 2.0)
    latents = latents.transpose(0, 2, 1)  # (K, T, L)

    # behavior = linear readout of latents + noise
    w_beh = rng.normal(scale=1.0, size=(n_latents, n_behaviors))
    behavior = latents @ w_beh + 0.05 * rng.normal(
        size=(n_trials, n_timesteps, n_behaviors))
    behavior = behavior.astype(np.float32)

    # spikes = Poisson(exp(latent readout)); mean rate ~ a spike / few bins
    w_spk = rng.normal(scale=0.4, size=(n_latents, n_neurons))
    log_rates = latents @ w_spk + rng.normal(scale=0.2, size=n_neurons) - 1.2
    rates = np.exp(np.clip(log_rates, -6.0, 3.0))
    spikes = rng.poisson(rates).astype(np.float32)

    neuron_regions = rng.choice(_REGION_POOL[:max(2, n_neurons // 16)],
                                size=n_neurons).astype(str)
    neuron_depths = np.sort(
        rng.uniform(0, 3000, size=n_neurons)).astype(np.float32)

    return SessionData(
        eid=eid,
        spikes=spikes,
        behavior=behavior,
        choice=choice.astype(np.float32),
        block=block.astype(np.float32),
        reward=reward.astype(np.float32),
        neuron_regions=neuron_regions,
        neuron_depths=neuron_depths,
        binsize=binsize,
    )


def synthetic_splits(seed: int = 0, n_trials: int = 200,
                     **kwargs) -> SessionSplits:
    """Train/val/test split of one synthetic session (80/10/10)."""
    sess = synthetic_session(seed=seed, n_trials=n_trials, **kwargs)
    n_train = int(0.8 * n_trials)
    n_val = max(1, int(0.1 * n_trials))
    return SessionSplits(
        train=sess.subset(range(0, n_train)),
        val=sess.subset(range(n_train, n_train + n_val)),
        test=sess.subset(range(n_train + n_val, n_trials)),
    )


# ---------------------------------------------------------------------------
# IBL hub loading (JAX :179-415)
# ---------------------------------------------------------------------------

def _rows_to_session(rows: Dict[str, list], eid: str,
                     target_names: Sequence[str] = DEFAULT_TARGETS
                     ) -> SessionData:
    """Hub dataset columns (``ds[split][:]``: a dict of lists) -> a
    SessionData. Region and depth come from the first row (``NaN`` depths
    where the column is missing or None); ``binsize`` from the rows where
    present, else 0.02. As in JAX, ``cluster_uuids`` is not read, so a
    session from the hub has none and ``make_loader(use_nemo=True)``
    refuses it."""
    spikes = sparse_rows_to_dense(
        rows["spikes_sparse_data"],
        rows["spikes_sparse_indices"],
        rows["spikes_sparse_indptr"],
        rows["spikes_sparse_shape"],
    ).astype(np.float32)

    behavior = np.stack(
        [np.asarray(rows[name], dtype=np.float32) for name in target_names],
        axis=-1)

    regions = np.asarray(rows["cluster_regions"][0]).astype(str)
    if "cluster_depths" in rows and rows["cluster_depths"][0] is not None:
        depths = np.asarray(rows["cluster_depths"][0], dtype=np.float32)
    else:
        depths = np.full(spikes.shape[-1], np.nan, dtype=np.float32)

    return SessionData(
        eid=eid,
        spikes=spikes,
        behavior=behavior,
        choice=np.asarray(rows["choice"], dtype=np.float32),
        block=np.asarray(rows["block"], dtype=np.float32),
        reward=np.asarray(rows["reward"], dtype=np.float32),
        neuron_regions=regions,
        neuron_depths=depths,
        binsize=(float(np.asarray(rows["binsize"])[0]) if "binsize" in rows
                 else 0.02),
        target_names=tuple(target_names),
    )


def load_ibl_session(eid: str, cache_dir: Optional[str] = None,
                     org: str = "neurofm123",
                     target_names: Sequence[str] = DEFAULT_TARGETS,
                     aligned: bool = True) -> SessionSplits:
    """One IBL session's train/val/test splits from the hub dataset
    ``<org>/<eid>_aligned`` (``aligned=False``: ``<eid>_unaligned``, the
    chunked dataset of the unaligned eval). Needs ``datasets`` and the hub
    or a warm ``cache_dir``."""
    from datasets import load_dataset  # heavy import, needs the hub

    suffix = "aligned" if aligned else "unaligned"
    ds = load_dataset(f"{org}/{eid}_{suffix}", cache_dir=cache_dir)
    return SessionSplits(**{
        split: _rows_to_session(ds[split][:], eid, target_names)
        for split in ("train", "val", "test")})


def _merge_session(parts: Sequence[SessionData]) -> SessionData:
    """Same-session splits concatenated along the trial axis."""
    first = parts[0]
    return dataclasses.replace(
        first,
        spikes=np.concatenate([p.spikes for p in parts], axis=0),
        behavior=np.concatenate([p.behavior for p in parts], axis=0),
        choice=np.concatenate([p.choice for p in parts], axis=0),
        block=np.concatenate([p.block for p in parts], axis=0),
        reward=np.concatenate([p.reward for p in parts], axis=0),
    )


def _truncate_to_batch(sess: SessionData, batch_size: int) -> SessionData:
    """Tail trials dropped to a batch-size multiple (the reference's
    fixed-shape batching, ``dataset_utils.py:262-272``)."""
    return sess.subset(range(sess.n_trials - sess.n_trials % batch_size))


def load_ibl_dataset(
    cache_dir: Optional[str],
    user_or_org_name: str = "neurofm123",
    eid: Optional[str] = None,
    num_sessions: int = 1,
    split_method: str = "predefined",
    train_session_eid: Sequence[str] = (),
    test_session_eid: Sequence[str] = (),
    split_size: float = 0.1,
    mode: str = "train",
    batch_size: int = 16,
    use_re: bool = False,
    target_eids_path: str = "data/target_eids.txt",
    test_re_eids_path: str = "data/test_re_eids.txt",
    train_aligned: bool = True,
    seed: int = 42,
    eids: Optional[Sequence[str]] = None,
    _load_session=None,
    _list_datasets=None,
) -> Tuple[Optional[dict], Optional[dict], Optional[dict], dict]:
    """Multi-session assembly with the reference's split machinery (JAX
    :256-408; the reference's ``dataset_utils.py:160-320``).

    Sessions: ``eids``, else ``eid``, else ``train_session_eid``, else the
    hub's datasets of ``user_or_org_name`` whose names end in exactly
    ``_aligned`` (``_unaligned`` with ``train_aligned=False``: the
    reference's substring filter can never pick unaligned data). Test
    sessions are taken out; ``use_re`` keeps the allow list's eids minus
    the deny list's; ``num_sessions`` counts train and test sessions (0
    train sessions means none, not all). A session that fails to load is
    skipped. ``split_method``: ``predefined`` (the hub's splits, each cut
    to a batch-size multiple), ``random_split`` (the session's trials
    merged and split by one ``default_rng(seed)`` permutation over all
    sessions in turn, val = ``split_size`` of what the test split leaves)
    or ``session_based`` (train sessions whole, the test sessions loaded
    apart); ``mode="eval"`` loads the test sessions only.

    Returns ``(train, val, test, meta)``, dicts eid -> SessionSplits (None
    when empty) and ``meta`` with ``num_neurons``, ``num_sessions``,
    ``eids`` and ``eid_list``, over the test sessions too.
    ``_load_session`` / ``_list_datasets`` replace the hub's loader and
    listing.
    """
    load_one = _load_session or (
        lambda e: load_ibl_session(e, cache_dir=cache_dir,
                                   org=user_or_org_name,
                                   aligned=train_aligned))

    # ---- session discovery -------------------------------------------
    if eids:
        wanted = list(eids)
    elif eid is not None:
        wanted = [eid]
    elif train_session_eid:
        wanted = list(train_session_eid)
    else:
        if _list_datasets is not None:
            ids = _list_datasets(user_or_org_name)
        else:
            from .dataset import get_user_datasets
            ids = get_user_datasets(user_or_org_name)
        ids = [d.split("/", 1)[1] if "/" in d else d for d in ids]
        suffix = "_aligned" if train_aligned else "_unaligned"
        wanted = [d[: -len(suffix)] for d in ids if d.endswith(suffix)]

    test_eids = list(test_session_eid)
    assert not (test_eids and split_method == "random_split"), (
        "When you have a test session, the split method should be "
        "'session_based'")
    wanted = [e for e in wanted if e not in set(test_eids)]

    if use_re:
        from .dataset import read_eid_list
        allow = set(read_eid_list(target_eids_path))
        deny = set(read_eid_list(test_re_eids_path))
        wanted = [e for e in wanted if e in allow and e not in deny]

    n_train_sessions = (num_sessions - len(test_eids)
                        if test_eids else num_sessions)
    assert n_train_sessions >= 0, (
        f"num_sessions={num_sessions} < len(test_session_eid)="
        f"{len(test_eids)}")
    wanted = wanted[:n_train_sessions]

    # ---- load --------------------------------------------------------
    def load_many(eid_list):
        out: Dict[str, SessionSplits] = {}
        for e in eid_list:
            try:
                out[e] = load_one(e)
            except Exception:  # skipped, as the reference does
                continue
        return out

    if mode == "eval":
        test = load_many(test_eids)
        return None, None, test or None, _session_meta(test)

    loaded = load_many(wanted)
    train: Dict[str, SessionSplits] = {}
    val: Dict[str, SessionSplits] = {}
    test: Dict[str, SessionSplits] = {}

    if split_method == "predefined":
        for e, s in loaded.items():
            sp = SessionSplits(train=_truncate_to_batch(s.train, batch_size),
                               val=_truncate_to_batch(s.val, batch_size),
                               test=_truncate_to_batch(s.test, batch_size))
            train[e] = val[e] = test[e] = sp
    elif split_method == "random_split":
        rng = np.random.default_rng(seed)
        for e, s in loaded.items():
            whole = _merge_session([s.train, s.val, s.test])
            perm = rng.permutation(whole.n_trials)
            n_test = max(1, int(round(split_size * whole.n_trials)))
            n_val = max(1, int(round(split_size * (whole.n_trials - n_test))))
            sp = SessionSplits(train=whole.subset(perm[n_test + n_val:]),
                               val=whole.subset(perm[n_test:n_test + n_val]),
                               test=whole.subset(perm[:n_test]))
            train[e] = val[e] = test[e] = sp
    elif split_method == "session_based":
        for e, s in loaded.items():
            train[e] = val[e] = s
        test = load_many(test_eids)
    else:
        raise ValueError(
            "Invalid split method. Please choose 'predefined', "
            "'random_split' or 'session_based'")

    meta = _session_meta({**loaded, **{e: s for e, s in test.items()
                                       if e not in loaded}})
    return train or None, val or None, test or None, meta


def _session_meta(splits_by_eid: Dict[str, SessionSplits]) -> dict:
    eids = list(splits_by_eid.keys())
    nn = [s.n_neurons for s in splits_by_eid.values()]
    return {"num_neurons": nn, "num_sessions": len(eids), "eids": eids,
            "eid_list": {e: n for e, n in zip(eids, nn)}}
