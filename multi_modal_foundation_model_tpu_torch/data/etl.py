"""Offline IBL ETL: session-wide arrays -> per-trial binned arrays.

The port's copy of ``multi_modal_foundation_model_tpu/data/etl.py``, the
rebuild of the reference's ``src/utils/ibl_data_utils.py`` core. It stays
on the host, in numpy with float64 times, as JAX's does: spike binning is
one vectorized scatter-add over all spikes (``floor((t - t_beg) /
binsize)`` in float64, so no spike moves across a bin edge), behavior
interpolation one pass per trial, no worker pools.

The network pieces (the ONE API, brainbox's ``SpikeSortingLoader`` /
``SessionLoader``, iblatlas's ``BrainRegions``) are imported inside the
functions that use them and are injectable, so the math runs offline and
the IBL entry path maps 1:1 where those packages are installed; pandas is
imported lazily too.

Known deviation, kept from JAX: the reference's ``align_spike_behavior``
combines masks with Python ``and`` (``ibl_data_utils.py:801-806``), which
*replaces* rather than intersects them; here masks are intersected.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_NAN_EXCLUDE = (
    "stimOn_times",
    "choice",
    "feedback_times",
    "probabilityLeft",
    "firstMovement_times",
    "feedbackType",
)


# ---------------------------------------------------------------------------
# intervals (parity: ibl_data_utils.py:234-241)
# ---------------------------------------------------------------------------

def create_intervals(start_time: float, end_time: float,
                     interval_len: float) -> np.ndarray:
    """(n, 2) array of consecutive [beg, end) chunks of ``interval_len``."""
    interval_begs = np.arange(start_time, end_time - interval_len,
                              interval_len)
    interval_ends = np.arange(start_time + interval_len, end_time,
                              interval_len)
    return np.c_[interval_begs, interval_ends]


def trial_intervals(align_times: np.ndarray,
                    time_window: Tuple[float, float]) -> np.ndarray:
    """Per-trial [align+w0, align+w1] intervals
    (``ibl_data_utils.py:348-352``)."""
    align_times = np.asarray(align_times, dtype=np.float64)
    return np.c_[align_times + time_window[0], align_times + time_window[1]]


# ---------------------------------------------------------------------------
# spike binning (parity: ibl_data_utils.py:244-385, vectorized)
# ---------------------------------------------------------------------------

def bin_spikes_per_interval(
    spike_times: np.ndarray,
    spike_clusters: np.ndarray,
    intervals: np.ndarray,              # (K, 2)
    binsize: float,
    cluster_ids: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bin spikes into (K, n_bins, n_clusters) counts with one scatter-add.

    Semantics match the reference per-interval ``bincount2D`` path
    (``get_spike_data_per_interval``): spikes in ``[t_beg, t_end)`` land in
    bin ``floor((t - t_beg)/binsize)`` clipped to ``n_bins``; clusters are
    indexed by their sorted unique ids. NaN intervals produce all-zero
    trials. Returns (binned, cluster_ids).
    """
    spike_times = np.asarray(spike_times, dtype=np.float64)
    spike_clusters = np.asarray(spike_clusters)
    intervals = np.asarray(intervals, dtype=np.float64)
    K = len(intervals)
    spans = intervals[:, 1] - intervals[:, 0]
    finite_spans = spans[np.isfinite(spans)]
    interval_len = float(finite_spans[0]) if len(finite_spans) else 0.0
    n_bins = int(np.ceil(interval_len / binsize))

    if cluster_ids is None:
        cluster_ids = np.unique(spike_clusters)
    n_clusters = len(cluster_ids)
    clu_index = np.searchsorted(cluster_ids, spike_clusters)
    valid_clu = (clu_index < n_clusters)
    valid_clu &= (np.asarray(cluster_ids)[np.minimum(clu_index,
                                                     n_clusters - 1)]
                  == spike_clusters)

    binned = np.zeros((K, n_bins, n_clusters), dtype=np.float32)
    # each interval bins its [beg, end) slice independently (reference
    # semantics: overlapping intervals both count a shared spike); the
    # per-interval slices are materialized as one flat index vector
    t_order = np.argsort(spike_times, kind="stable")
    times_s = spike_times[t_order]
    begs, ends = intervals[:, 0], intervals[:, 1]
    lo = np.searchsorted(times_s, begs, side="left")
    hi = np.searchsorted(times_s, ends, side="left")
    lens = np.maximum(hi - lo, 0)
    if lens.sum() > 0:
        k_ids = np.repeat(np.arange(K), lens)
        csum = np.concatenate([[0], np.cumsum(lens)])
        pos = np.arange(csum[-1]) - np.repeat(csum[:-1], lens)
        spike_idx = t_order[np.repeat(lo, lens) + pos]
        sel = valid_clu[spike_idx]
        k_ids, spike_idx = k_ids[sel], spike_idx[sel]
        t_rel = spike_times[spike_idx] - begs[k_ids]
        b = np.floor(t_rel / binsize).astype(np.int64)
        keep = b < n_bins
        np.add.at(binned, (k_ids[keep], b[keep],
                           clu_index[spike_idx[keep]]), 1.0)
    return binned, np.asarray(cluster_ids)


def get_spike_counts_in_bins(spike_times, spike_clusters,
                             intervals) -> Tuple[np.ndarray, np.ndarray]:
    """One count per (cluster, interval) — the reference's single-bin path
    (``bin_spiking_data`` with chunk_len == binsize)."""
    K = len(intervals)
    interval_len = float(intervals[0, 1] - intervals[0, 0]) if K else 0.0
    binned, ids = bin_spikes_per_interval(
        spike_times, spike_clusters, intervals, binsize=interval_len or 1.0)
    return binned.sum(axis=1).T, ids     # (n_clusters, K)


def bin_spiking_data(reg_clu_ids, spike_times, spike_clusters,
                     intervals=None, align_times=None,
                     time_window: Tuple[float, float] = (-0.5, 1.5),
                     binsize: float = 0.02
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(K, n_bins, n_clusters) binned spikes for the selected clusters
    (reference ``bin_spiking_data``, ``ibl_data_utils.py:313-385``)."""
    if intervals is None:
        assert align_times is not None, \
            "need intervals or align_times to segment the recording"
        intervals = trial_intervals(align_times, time_window)
    mask = np.isin(spike_clusters, reg_clu_ids)
    return bin_spikes_per_interval(
        np.asarray(spike_times)[mask], np.asarray(spike_clusters)[mask],
        intervals, binsize)


# ---------------------------------------------------------------------------
# probe merging (parity: ibl_data_utils.py:75-120)
# ---------------------------------------------------------------------------

def merge_probes(spikes_list: Sequence[Dict[str, np.ndarray]],
                 clusters_list: Sequence) -> Tuple[Dict[str, np.ndarray], "object"]:
    """Merge per-probe spike dicts + cluster tables, re-indexing clusters
    and time-sorting spikes."""
    import pandas as pd

    assert len(clusters_list) == len(spikes_list)
    merged_spikes, merged_clusters = [], []
    cluster_max = 0
    for clusters, spikes in zip(clusters_list, spikes_list):
        spikes = dict(spikes)
        spikes["clusters"] = spikes["clusters"] + cluster_max
        cluster_max += int(pd.DataFrame(clusters).index.max()) + 1
        merged_spikes.append(spikes)
        merged_clusters.append(pd.DataFrame(clusters))
    clusters = pd.concat(merged_clusters, ignore_index=True)
    spikes = {k: np.concatenate([s[k] for s in merged_spikes])
              for k in merged_spikes[0].keys()}
    sort_idx = np.argsort(spikes["times"], kind="stable")
    spikes = {k: v[sort_idx] for k, v in spikes.items()}
    return spikes, clusters


# ---------------------------------------------------------------------------
# trials mask (parity: ibl_data_utils.py:186-214)
# ---------------------------------------------------------------------------

def trials_mask(trials_df, min_rt: Optional[float] = 0.08,
                max_rt: Optional[float] = 2.0,
                min_trial_len: Optional[float] = None,
                max_trial_len: Optional[float] = None,
                exclude_unbiased: bool = False,
                exclude_nochoice: bool = True,
                nan_exclude: Sequence[str] = DEFAULT_NAN_EXCLUDE):
    """Boolean mask of trials passing the reference's exclusion query."""
    rt = trials_df["firstMovement_times"] - trials_df["stimOn_times"]
    bad = np.zeros(len(trials_df), dtype=bool)
    if min_rt is not None:
        bad |= np.asarray(rt < min_rt)
    if max_rt is not None:
        bad |= np.asarray(rt > max_rt)
    if min_trial_len is not None or max_trial_len is not None:
        tl = trials_df["feedback_times"] - trials_df["goCue_times"]
        if min_trial_len is not None:
            bad |= np.asarray(tl < min_trial_len)
        if max_trial_len is not None:
            bad |= np.asarray(tl > max_trial_len)
    for event in nan_exclude:
        bad |= np.asarray(trials_df[event].isnull()
                          if hasattr(trials_df[event], "isnull")
                          else np.isnan(trials_df[event]))
    if exclude_unbiased:
        bad |= np.asarray(trials_df["probabilityLeft"] == 0.5)
    if exclude_nochoice:
        bad |= np.asarray(trials_df["choice"] == 0)
    return ~bad


# ---------------------------------------------------------------------------
# behavior interpolation (parity: ibl_data_utils.py:514-647)
# ---------------------------------------------------------------------------

def interpolate_behavior_per_interval(
    target_times: np.ndarray,
    target_vals: np.ndarray,
    intervals: np.ndarray,                 # (K, 2)
    binsize: float,
    allow_nans: bool = False,
) -> Tuple[List[Optional[np.ndarray]], np.ndarray, List[Optional[str]]]:
    """Linearly interpolate a session-wide signal onto each interval's bin
    grid, with the reference's per-interval quality gates.

    Returns (per-interval values or None, good mask, skip reasons).
    Grid parity: ``x = linspace(beg + binsize, end, n_bins)``.
    """
    target_times = np.asarray(target_times, dtype=np.float64)
    target_vals = np.asarray(target_vals)
    intervals = np.asarray(intervals, dtype=np.float64)
    K = len(intervals)
    interval_len = float(intervals[0, 1] - intervals[0, 0]) if K else 0.0
    n_bins = int(np.ceil(interval_len / binsize))

    idxs_beg = np.searchsorted(target_times, intervals[:, 0], side="right")
    idxs_end = np.searchsorted(target_times, intervals[:, 1], side="left")

    vals_list: List[Optional[np.ndarray]] = [None] * K
    good = np.zeros(K, dtype=bool)
    reasons: List[Optional[str]] = [None] * K
    for k in range(K):
        t = target_times[idxs_beg[k]:idxs_end[k]]
        v = target_vals[idxs_beg[k]:idxs_end[k]]
        if len(v) == 0:
            reasons[k] = "target data not present"
            continue
        if not allow_nans and np.isnan(v).sum() > 0:
            reasons[k] = "nans in target data"
            continue
        if np.isnan(intervals[k, 0]) or np.isnan(intervals[k, 1]):
            reasons[k] = "bad interval data"
            continue
        if abs(intervals[k, 0] - t[0]) > binsize:
            reasons[k] = "target data starts too late"
            continue
        if abs(intervals[k, 1] - t[-1]) > binsize:
            reasons[k] = "target data ends too early"
            continue
        x = np.linspace(intervals[k, 0] + binsize, intervals[k, 1], n_bins)
        if v.ndim > 1 and v.shape[1] > 1:
            cols = [_interp_extrap(x, t, v[:, n]) for n in range(v.shape[1])]
            vals_list[k] = np.stack(cols, axis=1)
        else:
            vals_list[k] = _interp_extrap(x, t, v.ravel())
        good[k] = True
    return vals_list, good, reasons


def _interp_extrap(x: np.ndarray, t: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Linear interpolation WITH linear edge extrapolation (the reference
    uses scipy ``interp1d(..., fill_value='extrapolate')``; ``np.interp``
    alone clamps at the boundary values)."""
    y = np.interp(x, t, v)
    if len(t) >= 2:
        lo = x < t[0]
        if lo.any():
            slope = (v[1] - v[0]) / (t[1] - t[0])
            y[lo] = v[0] + slope * (x[lo] - t[0])
        hi = x > t[-1]
        if hi.any():
            slope = (v[-1] - v[-2]) / (t[-1] - t[-2])
            y[hi] = v[-1] + slope * (x[hi] - t[-1])
    return y


def bin_behaviors(
    behavior_signals: Dict[str, Tuple[np.ndarray, np.ndarray]],
    intervals: Optional[np.ndarray] = None,
    trials_df=None,
    align_time: str = "stimOn_times",
    time_window: Tuple[float, float] = (-0.5, 1.5),
    binsize: float = 0.02,
    mask: Optional[np.ndarray] = None,
    allow_nans: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Per-trial behavior traces + trial scalars
    (reference ``bin_behaviors``, ``ibl_data_utils.py:679-737``).

    ``behavior_signals`` maps name -> (times, values) session-wide arrays
    (the network loads live outside this function).
    """
    behave_dict: Dict[str, np.ndarray] = {}
    mask_dict: Dict[str, np.ndarray] = {}

    if mask is not None and trials_df is not None:
        trials_df = trials_df[mask]

    if trials_df is not None:
        choice = np.asarray(trials_df["choice"])
        block = np.asarray(trials_df["probabilityLeft"])
        reward = (np.asarray(trials_df["rewardVolume"]) > 1).astype(int)
        contrast = np.c_[np.asarray(trials_df["contrastLeft"]),
                         np.asarray(trials_df["contrastRight"])]
        contrast = (-1 * np.nan_to_num(contrast, nan=0.0)).sum(1)
        behave_dict.update({"choice": choice, "block": block,
                            "reward": reward, "contrast": contrast})
        intervals = trial_intervals(np.asarray(trials_df[align_time]),
                                    time_window)
    else:
        assert intervals is not None, \
            "Require intervals to segment the recording"

    for name, (times, vals) in behavior_signals.items():
        vals_list, good, _ = interpolate_behavior_per_interval(
            times, vals, intervals, binsize=binsize, allow_nans=allow_nans)
        behave_dict[name] = np.array(vals_list, dtype=object)
        mask_dict[name] = good
    return behave_dict, mask_dict


# ---------------------------------------------------------------------------
# alignment (parity: ibl_data_utils.py:795-823, with the mask-intersection
# fix documented in the module docstring)
# ---------------------------------------------------------------------------

def align_spike_behavior(binned_spikes, binned_behaviors,
                         beh_names: Sequence[str] = ("choice", "reward",
                                                     "block",
                                                     "whisker-motion-energy"),
                         trials_mask=None):
    """Drop trials missing any modality; returns aligned (spikes, behaviors)."""
    K = len(binned_spikes)
    target_mask = np.ones(K, dtype=bool)
    for beh_name in beh_names:
        vals = binned_behaviors[beh_name]
        beh_mask = np.array([trial is not None for trial in vals]) \
            if vals.dtype == object else np.ones(K, dtype=bool)
        target_mask &= beh_mask
    if trials_mask is not None:
        target_mask &= np.asarray(trials_mask).astype(bool)

    keep = np.where(target_mask)[0]
    aligned_spikes = np.asarray(binned_spikes)[keep]
    aligned_behaviors = {}
    for beh_name in beh_names:
        kept = [binned_behaviors[beh_name][i] for i in keep]
        aligned_behaviors[beh_name] = np.array(
            [np.asarray(y, dtype=float) for y in kept]
        ).reshape((len(keep), -1))
        assert len(aligned_spikes) == len(aligned_behaviors[beh_name])
    return aligned_spikes, aligned_behaviors


# ---------------------------------------------------------------------------
# network-gated wrappers (need ONE API / brainbox / iblatlas)
# ---------------------------------------------------------------------------

def load_spiking_data(one, pid, compute_metrics=False, qc=1.0, **kwargs):
    """Good-unit spikes for one probe via SpikeSortingLoader
    (``ibl_data_utils.py:27-72``). Requires ``brainbox``."""
    from brainbox.io.one import SpikeSortingLoader  # network-gated import

    loader = SpikeSortingLoader(one=one, pid=pid, **kwargs)
    spikes, clusters, channels = loader.load_spike_sorting()
    clusters = loader.merge_clusters(spikes, clusters, channels,
                                     compute_metrics=compute_metrics)
    clusters = clusters.to_df()
    iok = clusters["label"] >= qc
    clusters = clusters[iok]
    kept = np.isin(spikes["clusters"], clusters.index)
    spikes = {k: v[kept] for k, v in spikes.items()}
    clusters = clusters.reset_index(drop=False)
    remap = {old: new for new, old in enumerate(clusters["index"])}
    spikes["clusters"] = np.asarray(
        [remap[c] for c in spikes["clusters"]])
    sampling_freq = loader.raw_electrophysiology(band="ap", stream=True).fs
    return spikes, clusters, sampling_freq


def list_brain_regions(cluster_regions, single_region: bool = False):
    """Beryl-mapped region list (``ibl_data_utils.py:217-223``);
    requires ``iblatlas``."""
    from iblatlas.regions import BrainRegions  # network-gated import

    beryl_reg = BrainRegions().acronym2acronym(cluster_regions,
                                               mapping="Beryl")
    regions = ([[k] for k in np.unique(beryl_reg)] if single_region
               else [np.unique(beryl_reg)])
    return regions, beryl_reg


def select_brain_regions(beryl_reg, region) -> np.ndarray:
    """Cluster ids in the selected region(s) (``ibl_data_utils.py:226-231``)."""
    reg_mask = np.isin(beryl_reg, region)
    return np.argwhere(reg_mask).flatten()


# ---------------------------------------------------------------------------
# orchestration tier (parity: ibl_data_utils.py:123-214,387-511,650-792)
#
# Every function is dependency-injected: the network objects (ONE API,
# SessionLoader) are plain duck-typed arguments, so the full raw-session ->
# hub-dataset pipeline runs offline under tests with fakes, and maps 1:1
# onto the IBL stack when ``one``/``brainbox`` are installed.
# ---------------------------------------------------------------------------

def _session_loader(one, eid, sess_loader=None):
    if sess_loader is not None:
        return sess_loader
    from brainbox.io.one import SessionLoader  # network-gated import
    return SessionLoader(one, eid)


def load_trials_and_mask(
    one=None,
    eid: Optional[str] = None,
    min_rt: Optional[float] = 0.08,
    max_rt: Optional[float] = 2.0,
    nan_exclude="default",
    min_trial_len: Optional[float] = None,
    max_trial_len: Optional[float] = None,
    exclude_unbiased: bool = False,
    exclude_nochoice: bool = True,
    sess_loader=None,
    trials_df=None,
):
    """Trials table + inclusion mask (``ibl_data_utils.py:123-214``).

    Offline path: pass ``trials_df`` (or a ``sess_loader`` whose ``trials``
    is populated); the exclusion mask is the vectorized ``trials_mask``
    (identical semantics to the reference's pandas query string).
    """
    if nan_exclude == "default":
        nan_exclude = DEFAULT_NAN_EXCLUDE
    if trials_df is None:
        sess_loader = _session_loader(one, eid, sess_loader)
        if getattr(sess_loader, "trials", None) is None or \
                len(sess_loader.trials) == 0:
            sess_loader.load_trials()
        trials_df = sess_loader.trials
    mask = trials_mask(
        trials_df, min_rt=min_rt, max_rt=max_rt,
        min_trial_len=min_trial_len, max_trial_len=max_trial_len,
        exclude_unbiased=exclude_unbiased, exclude_nochoice=exclude_nochoice,
        nan_exclude=nan_exclude)
    return trials_df, mask


# behavior-signal dispatch (``ibl_data_utils.py:387-511``): wheel/motion
# energy ride the SessionLoader; pose-derived signals ride one.load_object
_WHEEL_COLUMN = {"wheel-position": "position", "wheel-velocity": "velocity",
                 "wheel-speed": "velocity"}


_LOADER_LOCKS: Any = None  # WeakKeyDictionary, created lazily
_LOADER_LOCKS_GUARD = None  # created lazily (threading import kept local)


def _loader_lock(sess_loader):
    """Per-SessionLoader mutex: load_anytime_behaviors shares one loader
    across ThreadPoolExecutor workers, and brainbox's load_* methods
    reassign loader attributes — check-then-load must be atomic. Keyed
    weakly by the loader object so locks die with their loader (no
    unbounded growth across a long multi-session ETL run, no id()-reuse
    aliasing)."""
    import threading
    import weakref

    global _LOADER_LOCKS, _LOADER_LOCKS_GUARD
    if _LOADER_LOCKS_GUARD is None:
        _LOADER_LOCKS_GUARD = threading.Lock()
    with _LOADER_LOCKS_GUARD:
        if _LOADER_LOCKS is None:
            _LOADER_LOCKS = weakref.WeakKeyDictionary()
        if sess_loader not in _LOADER_LOCKS:
            _LOADER_LOCKS[sess_loader] = threading.Lock()
        return _LOADER_LOCKS[sess_loader]


BEHAVIOR_TARGETS = (
    "wheel-position", "wheel-velocity", "wheel-speed",
    "left-whisker-motion-energy", "right-whisker-motion-energy",
    "left-pupil-diameter", "right-pupil-diameter",
    "left-camera-left-paw-speed", "left-camera-right-paw-speed",
    "right-camera-left-paw-speed", "right-camera-right-paw-speed",
    "left-nose-speed", "right-nose-speed",
)


def load_target_behavior(one, eid, target: str, sess_loader=None) -> Dict:
    """One behavior signal as ``{'times', 'values'}`` (+``'skip': True`` on
    any load failure — the reference's error contract,
    ``ibl_data_utils.py:506-509``)."""
    try:
        if target in _WHEEL_COLUMN:
            sl = _session_loader(one, eid, sess_loader)
            if getattr(sl, "wheel", None) is None or len(sl.wheel) == 0:
                with _loader_lock(sl):
                    if getattr(sl, "wheel", None) is None \
                            or len(sl.wheel) == 0:
                        sl.load_wheel()
            vals = np.asarray(sl.wheel[_WHEEL_COLUMN[target]])
            if target == "wheel-speed":
                vals = np.abs(vals)
            return {"times": np.asarray(sl.wheel["times"]), "values": vals}

        if target.endswith("whisker-motion-energy"):
            view = target.split("-")[0]            # 'left' | 'right'
            sl = _session_loader(one, eid, sess_loader)
            # check the VIEW, not dict truthiness: with a shared loader a
            # prior left-view load would otherwise skip the right view
            me = getattr(sl, "motion_energy", None)
            if not me or f"{view}Camera" not in me:
                with _loader_lock(sl):
                    me = getattr(sl, "motion_energy", None)
                    if not me or f"{view}Camera" not in me:
                        sl.load_motion_energy(views=[view])
            cam = sl.motion_energy[f"{view}Camera"]
            return {"times": np.asarray(cam["times"]),
                    "values": np.asarray(cam["whiskerMotionEnergy"])}

        if target.endswith("pupil-diameter"):
            side = target.split("-")[0]
            obj = one.load_object(eid, f"{side}Camera",
                                  attribute=["dlc", "features", "times"],
                                  collection="alf")
            return {"times": obj.times,
                    "values": obj.features.pupilDiameter_smooth}

        if target.endswith("paw-speed") or target.endswith("nose-speed"):
            from brainbox.behavior import dlc  # network-gated import

            parts = target.split("-")
            camera = parts[0]                       # recording camera view
            if target.endswith("nose-speed"):
                feature = "nose_tip"
            else:                                   # '<cam>-camera-<side>-paw-speed'
                feature = "paw_l" if parts[2] == "left" else "paw_r"
            obj = one.load_object(eid, f"{camera}Camera",
                                  attribute=["dlc", "features", "times"],
                                  collection="alf")
            return {"times": obj.times,
                    "values": dlc.get_speed(obj.dlc, obj.times,
                                            camera=camera, feature=feature)}

        raise NotImplementedError(target)
    except BaseException as e:  # noqa: BLE001 — reference contract
        if isinstance(e, NotImplementedError):
            raise
        return {"times": None, "values": None, "skip": True}


DEFAULT_ANYTIME_BEHAVIORS = ("left-whisker-motion-energy",
                             "right-whisker-motion-energy")


def load_anytime_behaviors(one, eid,
                           behaviors: Sequence[str] = DEFAULT_ANYTIME_BEHAVIORS,
                           max_workers: int = 4, sess_loader=None) -> Dict:
    """Concurrent load of the session-wide behavior signals
    (``ibl_data_utils.py:650-676``). Threads instead of the reference's
    process pool: the work is network/IO-bound, and thread results need no
    pickling."""
    from concurrent.futures import ThreadPoolExecutor

    def load(beh):
        return beh, load_target_behavior(one, eid, beh,
                                         sess_loader=sess_loader)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return dict(pool.map(load, behaviors))


def collect_behavior_signals(one, eid,
                             behaviors: Sequence[str] = ("whisker-motion-energy",),
                             sess_loader=None
                             ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{name: (times, values)} signals feeding :func:`bin_behaviors`, with
    the reference's left->right whisker-camera fallback
    (``ibl_data_utils.py:717-723``)."""
    out = {}
    for beh in behaviors:
        if beh == "whisker-motion-energy":
            d = load_target_behavior(one, eid, "left-whisker-motion-energy",
                                     sess_loader=sess_loader)
            if d.get("skip"):
                d = load_target_behavior(one, eid,
                                         "right-whisker-motion-energy",
                                         sess_loader=sess_loader)
        else:
            d = load_target_behavior(one, eid, beh, sess_loader=sess_loader)
        if d.get("skip"):
            raise RuntimeError(f"failed to load behavior signal {beh!r}")
        out[beh] = (d["times"], d["values"])
    return out


def prepare_data(one, eid, bwm_df, params: Optional[Dict] = None,
                 load_spiking_data_fn=None, load_trials_fn=None,
                 load_behaviors_fn=None, sess_loader=None):
    """One-session ETL orchestrator (``ibl_data_utils.py:740-792``).

    ``bwm_df`` is the brain-wide-map probe table (columns: eid, subject,
    lab, pid, probe_name). The three loader hooks default to the network
    implementations and are injectable for offline use. Returns
    ``(neural_dict, behave_dict, meta_data, trials_data)`` in the
    reference's schema, feeding ``bin_spiking_data``/``bin_behaviors``/
    ``align_spike_behavior`` -> ``create_dataset``.
    """
    load_spiking_data_fn = load_spiking_data_fn or load_spiking_data
    load_trials_fn = load_trials_fn or load_trials_and_mask
    load_behaviors_fn = load_behaviors_fn or load_anytime_behaviors

    tmp_df = bwm_df.set_index(["eid", "subject"]).xs(eid, level="eid")
    subject = tmp_df.index[0]
    lab = tmp_df["lab"].iloc[0]
    pids = tmp_df["pid"].to_list()
    probe_names = tmp_df["probe_name"].to_list()

    spikes_list, clusters_list, sampling_freq = [], [], None
    for pid, probe_name in zip(pids, probe_names):
        spikes, clusters, sampling_freq = load_spiking_data_fn(
            one, pid, eid=eid, pname=probe_name)
        clusters = clusters.copy()
        clusters["pid"] = pid
        spikes_list.append(spikes)
        clusters_list.append(clusters)
    spikes, clusters = merge_probes(spikes_list, clusters_list)

    trials_df, trials_mask_ = load_trials_fn(
        one=one, eid=eid, max_trial_len=10.0, sess_loader=sess_loader)

    behave_dict = load_behaviors_fn(one, eid, sess_loader=sess_loader)

    neural_dict = {
        "spike_times": spikes["times"],
        "spike_clusters": spikes["clusters"],
        "cluster_regions": clusters["acronym"].to_numpy(),
    }
    meta_data = {
        "subject": subject,
        "eid": eid,
        "probe_name": probe_names[-1],
        "lab": lab,
        "sampling_freq": sampling_freq,
        "cluster_channels": list(clusters["channels"]),
        "cluster_regions": list(clusters["acronym"]),
        "good_clusters": list((clusters["label"] >= 1).astype(int)),
        "cluster_depths": list(clusters["depths"]),
        "uuids": list(clusters["uuids"]),
        "cluster_qc": {k: np.asarray(v)
                       for k, v in clusters.to_dict("list").items()},
    }
    trials_data = {"trials_df": trials_df, "trials_mask": trials_mask_}
    return neural_dict, behave_dict, meta_data, trials_data
