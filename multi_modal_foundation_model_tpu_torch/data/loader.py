"""Fixed-shape batching of whole splits (numpy).

The port's copy of ``multi_modal_foundation_model_tpu/data/loader.py``
(``attention_mask``, ``prepare_split``, ``DataLoader``, ``make_loader``):
the whole split is padded once into stacked fixed-shape arrays, and the
loader yields batches in JAX's order: with ``shuffle`` a permutation drawn
from ``np.random.default_rng((seed, epoch))``, the epoch advancing after
each pass, so both packages yield the same batches. The last batch is
padded up to ``batch_size`` with its ``time/space_attn_mask`` zeroed and
``n_real`` telling the real count (``pad_last``), or dropped
(``drop_last``). The batch keys are the JAX loader's. ``sampler`` (or
``make_loader``'s ``stitching``) orders the trials as the JAX samplers do
(``get_length_grouped_indices``, ``get_length_grouped_indices_stitched``,
JAX :76-125, from the same ``(seed, epoch)`` generator), index for index.
The NEMO unit filter (``load_nemo_units``, ``make_loader(use_nemo=True)``,
JAX :261-283, :432-441) keeps the units whose uuid is in the unit-embedding
pickle, narrows the space axis to them and carries their representation
rows as ``nemo_rep``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .session import SessionData

Batch = Dict[str, np.ndarray]


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               shuffle: bool = True,
                               mega_batch_mult: Optional[int] = None,
                               generator: Optional[np.random.Generator] = None,
                               ) -> List[int]:
    """Hugging Face-style megabatch length grouping: megabatches of
    ``mega_batch_mult * batch_size`` trials, each sorted longest first, the
    longest trial of all swapped to the front."""
    if mega_batch_mult is None:
        mega_batch_mult = min(len(lengths) // (batch_size * 4), 50) or 1
    gen = generator or np.random.default_rng()
    indices = (gen.permutation(len(lengths)) if shuffle
               else np.arange(len(lengths)))
    size = mega_batch_mult * batch_size
    megabatches = [sorted(indices[i:i + size].tolist(),
                          key=lambda i: lengths[i], reverse=True)
                   for i in range(0, len(lengths), size)]
    longest = int(np.argmax([lengths[mb[0]] for mb in megabatches]))
    megabatches[0][0], megabatches[longest][0] = (
        megabatches[longest][0], megabatches[0][0])
    return sum(megabatches, [])


def get_length_grouped_indices_stitched(
        lengths: Sequence[int], batch_size: int,
        generator: Optional[np.random.Generator] = None) -> List[int]:
    """Trials grouped by equal length (neuron count), cut into batches in
    that order, the batches shuffled."""
    order = np.argsort(np.asarray(lengths), kind="stable").tolist()
    batches = [order[i:i + batch_size]
               for i in range(0, len(order), batch_size)]
    (generator or np.random.default_rng()).shuffle(batches)
    return [int(i) for batch in batches for i in batch]


def pad_seq_right_to_n(seq: np.ndarray, n: int,
                       pad_value: float = 0.0) -> np.ndarray:
    """``seq`` padded along its first axis to ``n`` at the end (the
    reference's ``loader/base.py:9-118`` helpers, JAX :36-61)."""
    if n == len(seq):
        return seq
    pad = np.ones((n - len(seq), *np.asarray(seq[0]).shape)) * pad_value
    return np.concatenate([seq, pad], axis=0)


def pad_seq_left_to_n(seq: np.ndarray, n: int,
                      pad_value: float = 0.0) -> np.ndarray:
    if n == len(seq):
        return seq
    pad = np.ones((n - len(seq), *np.asarray(seq[0]).shape)) * pad_value
    return np.concatenate([pad, seq], axis=0)


def wrap_pad_temporal_right_to_n(seq: np.ndarray, n: int) -> np.ndarray:
    if n == len(seq):
        return seq
    return np.pad(seq, ((0, n - seq.shape[0]), (0, 0)), mode="wrap")


def wrap_pad_neuron_up_to_n(seq: np.ndarray, n: int) -> np.ndarray:
    if n == len(seq[0]):
        return seq
    return np.pad(seq, ((0, 0), (0, n - seq.shape[1])), mode="wrap")


def attention_mask(seq_length: int, pad_length: int) -> np.ndarray:
    mask = np.ones(seq_length)
    if pad_length:
        mask[-pad_length:] = 0
    return mask


def prepare_split(
    session: SessionData,
    max_time_length: int = 100,
    max_space_length: int = 668,
    pad_value: float = 0.0,
    pad_to_right: bool = True,
    sort_by_depth: bool = False,
    sort_by_region: bool = False,
    brain_region: str = "all",
    region_vocab: Optional[Dict[str, int]] = None,
    unit_filter: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Pad/truncate time to ``max_time_length`` and space to
    ``max_space_length``, optionally subset one brain region and sort
    neurons by depth or region, over the whole split at once. Also emits
    integer ``region_ids`` (padding = -1). ``unit_filter`` (a boolean mask
    or an index array) selects neurons first: the NEMO filter's units."""
    assert not (sort_by_depth and sort_by_region), \
        "Can only sort either by depth or region."

    spikes = session.spikes
    regions = session.neuron_regions.astype(str)
    depths = session.neuron_depths

    if unit_filter is not None:
        unit_filter = np.asarray(unit_filter)
        keep = (np.argwhere(unit_filter).flatten()
                if unit_filter.dtype == bool else unit_filter)
        spikes = spikes[:, :, keep]
        regions = regions[keep]
        depths = depths[keep]

    if brain_region != "all":
        keep = np.argwhere(regions == brain_region).flatten()
        spikes = spikes[:, :, keep]
        regions = regions[keep]
        depths = depths[keep]

    n_trials, n_t, n_n = spikes.shape

    order = np.arange(n_n)
    if sort_by_depth:
        order = np.argsort(depths, kind="stable")
    elif sort_by_region:
        order = np.argsort(regions, kind="stable")
    spikes = spikes[:, :, order]
    regions = regions[order]
    depths = depths[order]

    # --- time axis ---
    pad_t = 0
    if n_t > max_time_length:
        spikes = spikes[:, :max_time_length]
        behavior = session.behavior[:, :max_time_length]
    else:
        pad_t = max_time_length - n_t
        behavior = session.behavior
        if pad_t:
            width = (0, pad_t) if pad_to_right else (pad_t, 0)
            spikes = np.pad(spikes, ((0, 0), width, (0, 0)),
                            constant_values=pad_value)
            behavior = np.pad(behavior, ((0, 0), width, (0, 0)),
                              constant_values=pad_value)

    # --- space axis ---
    pad_n = 0
    if n_n > max_space_length:
        spikes = spikes[:, :, :max_space_length]
        regions = regions[:max_space_length]
        depths = depths[:max_space_length]
    else:
        pad_n = max_space_length - n_n
        if pad_n:
            width = (0, pad_n) if pad_to_right else (pad_n, 0)
            spikes = np.pad(spikes, ((0, 0), (0, 0), width),
                            constant_values=pad_value)
            regions = np.concatenate([regions, np.array(["<pad>"] * pad_n)])
            depths = np.concatenate([depths, np.full(pad_n, np.nan)])

    if region_vocab is None:
        uniq = sorted(set(regions.tolist()) - {"<pad>"})
        region_vocab = {r: i for i, r in enumerate(uniq)}
    region_ids = np.array([region_vocab.get(r, -1) for r in regions],
                          dtype=np.int32)

    time_mask = attention_mask(max_time_length, pad_t).astype(np.int64)
    space_mask = attention_mask(max_space_length, pad_n).astype(np.int64)

    return {
        "spikes_data": spikes.astype(np.float32),
        "target": behavior.astype(np.float32),
        "time_attn_mask": np.tile(time_mask, (n_trials, 1)),
        "space_attn_mask": np.tile(space_mask, (n_trials, 1)),
        "spikes_timestamps": np.tile(
            np.arange(max_time_length, dtype=np.int64), (n_trials, 1)),
        "spikes_spacestamps": np.tile(
            np.arange(max_space_length, dtype=np.int64), (n_trials, 1)),
        "choice": session.choice.astype(np.float32),
        "block": session.block.astype(np.float32),
        "reward": session.reward.astype(np.float32),
        "neuron_regions": regions,           # (N,) str, shared across trials
        "neuron_depths": depths.astype(np.float32),
        "region_ids": region_ids,            # (N,) int32, -1 = padding
        "region_vocab": region_vocab,        # host-side dict
        "eid": session.eid,
    }


def load_nemo_units(nemo_path: str, cluster_uuids: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The NEMO unit-embedding filter (the reference's
    ``loader/base.py:331-343``): reads the pickle (``{'uuids', 'wvf_rep',
    'acg_rep'}``), intersects its uuids with the session's, and returns
    ``(unit_ids, nemo_rep)``: the indices of the session's units to keep
    and their waveform + ACG representation rows in the table's order. The
    pickle is the program's own data: unpickling runs code, so pass only a
    file of trusted origin."""
    import pickle

    with open(nemo_path, "rb") as f:
        nemo = pickle.load(f)
    nemo_uuids = np.asarray(nemo["uuids"]).astype(str)
    rep = np.concatenate(
        [np.asarray(nemo["wvf_rep"]), np.asarray(nemo["acg_rep"])], axis=1)
    cluster_uuids = np.asarray(cluster_uuids).astype(str)
    include = np.intersect1d(cluster_uuids, nemo_uuids)
    unit_ids = np.flatnonzero(np.isin(cluster_uuids, include)).astype(np.int64)
    nemo_rep = rep[np.isin(nemo_uuids, include)].astype(np.float32)
    return unit_ids, nemo_rep


_PER_TRIAL_KEYS = ("spikes_data", "target", "time_attn_mask",
                   "space_attn_mask", "spikes_timestamps",
                   "spikes_spacestamps", "choice", "block", "reward")
_SHARED_KEYS = ("neuron_regions", "neuron_depths", "region_ids",
                "region_vocab", "eid", "nemo_rep")


SAMPLERS = (None, "length_grouped", "stitch")


@dataclasses.dataclass(eq=False)  # identity eq/hash: loaders are stateful
class DataLoader:
    """Deterministic fixed-shape batch iterator over a prepared split."""

    arrays: Dict[str, np.ndarray]
    batch_size: int
    shuffle: bool = True
    seed: int = 42
    pad_last: bool = True
    drop_last: bool = False
    sampler: Optional[str] = None     # None | "length_grouped" | "stitch"

    def __post_init__(self):
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler {self.sampler!r}: one of {SAMPLERS}")
        self._epoch = 0
        self._n = int(self.arrays["spikes_data"].shape[0])

    def __len__(self) -> int:
        if self.drop_last:
            return self._n // self.batch_size
        return -(-self._n // self.batch_size)

    @property
    def n_trials(self) -> int:
        return self._n

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _order(self) -> np.ndarray:
        gen = np.random.default_rng((self.seed, self._epoch))
        if self.sampler == "stitch":
            lengths = self.arrays["space_attn_mask"].sum(axis=1).astype(int)
            return np.asarray(get_length_grouped_indices_stitched(
                lengths.tolist(), self.batch_size, gen))
        if self.sampler == "length_grouped":
            lengths = self.arrays["time_attn_mask"].sum(axis=1).astype(int)
            return np.asarray(get_length_grouped_indices(
                lengths.tolist(), self.batch_size, shuffle=self.shuffle,
                generator=gen))
        if self.shuffle:
            return gen.permutation(self._n)
        return np.arange(self._n)

    def iter_index_batches(self) -> Iterator[tuple]:
        """``(idxs (B,) int32, valid (B,) int32, n_real)`` per batch, in the
        order and with the padding ``__iter__`` yields (JAX :365-389);
        advances the epoch as a pass does."""
        order = self._order()
        self._epoch += 1
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idxs = order[start:start + bs]
            n_real = len(idxs)
            valid = np.ones(bs, dtype=np.int32)
            if n_real < bs:
                if self.drop_last:
                    return
                if self.pad_last:
                    idxs = np.concatenate(
                        [idxs, np.full(bs - n_real, idxs[-1],
                                       dtype=idxs.dtype)])
                    valid[n_real:] = 0
                else:
                    valid = valid[:n_real]
            yield idxs.astype(np.int32), valid, n_real

    def __iter__(self) -> Iterator[Batch]:
        for idxs, valid, n_real in self.iter_index_batches():
            batch: Batch = {k: self.arrays[k][idxs] for k in _PER_TRIAL_KEYS}
            if n_real < len(idxs):
                # padding trials carry zero attention -> zero loss weight
                batch["time_attn_mask"][n_real:] = 0
                batch["space_attn_mask"][n_real:] = 0
            for k in _SHARED_KEYS:
                if k in self.arrays:
                    batch[k] = self.arrays[k]
            batch["n_real"] = n_real
            yield batch


def make_loader(
    session: SessionData,
    batch_size: int,
    target: Optional[Sequence[str]] = None,
    pad_to_right: bool = True,
    sort_by_depth: bool = False,
    sort_by_region: bool = False,
    pad_value: float = 0.0,
    max_time_length: int = 100,
    max_space_length: int = 668,
    brain_region: str = "all",
    load_meta: bool = True,
    stitching: bool = False,
    shuffle: bool = True,
    seed: int = 42,
    region_vocab: Optional[Dict[str, int]] = None,
    drop_last: bool = False,
    sampler: Optional[str] = None,
    use_nemo: bool = False,
    nemo_path: str = "data/MtM_unit_embed.pkl",
    unit_filter: Optional[np.ndarray] = None,
) -> DataLoader:
    """Loader over one session split with JAX ``make_loader``'s arguments
    (:392-464, in its order); ``target`` selects behavior covariates by
    name (default: the session's stored ones). ``sampler`` picks the
    batching order (None | "length_grouped" | "stitch"); ``stitching=True``
    is the reference's flag for the stitch sampler. ``load_meta`` is the
    reference's flag, accepted and unread as in JAX (the metadata is always
    loaded). ``use_nemo`` applies the NEMO filter from ``nemo_path``
    (needs ``session.cluster_uuids``; excludes ``unit_filter``) and narrows
    ``max_space_length`` to the kept units, as the reference does;
    ``unit_filter`` selects neurons directly."""
    if target is not None and tuple(target) != tuple(session.target_names):
        name_to_idx = {n: i for i, n in enumerate(session.target_names)}
        cols = [name_to_idx[t] for t in target]
        session = dataclasses.replace(
            session, behavior=session.behavior[:, :, cols],
            target_names=tuple(target))
    nemo_rep = np.array([np.nan], dtype=np.float32)
    if use_nemo:
        assert session.cluster_uuids is not None, \
            "use_nemo requires session.cluster_uuids"
        assert unit_filter is None, "use_nemo computes its own unit_filter"
        unit_filter, nemo_rep = load_nemo_units(nemo_path,
                                                session.cluster_uuids)
        max_space_length = len(unit_filter)
    arrays = prepare_split(
        session,
        max_time_length=max_time_length,
        max_space_length=max_space_length,
        pad_value=pad_value,
        pad_to_right=pad_to_right,
        sort_by_depth=sort_by_depth,
        sort_by_region=sort_by_region,
        brain_region=brain_region,
        region_vocab=region_vocab,
        unit_filter=unit_filter,
    )
    arrays["nemo_rep"] = nemo_rep
    if sampler is None and stitching:
        sampler = "stitch"
    return DataLoader(arrays=arrays, batch_size=batch_size, shuffle=shuffle,
                      seed=seed, drop_last=drop_last, sampler=sampler)
