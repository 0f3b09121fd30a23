"""The masking-scheme engine (MtM) as seeded functions.

Port of ``multi_modal_foundation_model_tpu/ops/masking.py``. The mode and
the regions arrive as arguments, never as module state. Mode semantics
(JAX :1-34):

- ``random``        per-element Bernoulli(ratio) over (B, T, N)
- ``temporal``      per-timestep Bernoulli over (B, T), optional span
                    expansion; ``random_token`` is an alias
- ``causal``        temporal with ratio 0.01 and (``causal_zero``) the mask
                    extended from each row's first masked bin to the end;
                    the targets stay the pre-extension mask
- ``neuron``        per-channel Bernoulli over (B, N)
- ``co-smooth``     fixed channel list
- ``forward-pred``  fixed timestep list
- ``inter-region``  sample n regions, mask all their neurons
- ``intra-region``  sample n target regions, Bernoulli(ratio) inside them,
                    every other neuron masked; targets only inside them

Masked positions are corrupted BERT-style (``_corrupt``): of the masked
set ``zero_ratio`` is zeroed, of the rest ``random_ratio`` replaced by
``U[0, max(spikes))``.

Randomness: JAX splits a PRNG key; here every draw is keyed by two
entries of the step's seed table (``utils/rng.py``), ``keys = [k_mask,
k_corrupt]`` (an int64 tensor on the spikes' device), and the element masks
are Philox uniforms keyed by them on the device (``ops/random.py``). The
draws a Python branch or a host array would need (``timespan``, ``expand``
and the ratio they set, the sampled regions) are made on the host, from a
numpy generator seeded from ``k_mask`` (``host_draws``), and travel with the
step's inputs as a small f32 vector, ``draws = [width, ratio, region ids]``:
the temporal modes always dilate by the device-side ``width`` (1 is the
identity), and the region modes read their sampled ids from it. So nothing
is read back and nothing is copied from the host while a step runs, and a
CUDA graph of the step, replayed with another step's keys and draws, masks
as the eager step with those would. ``apply_mask`` with a host int seed
derives the keys and draws itself (eagerly). ``apply_mask_by_id`` is a
Python dispatch on the host mode id where JAX has ``lax.switch``.

jax.random and Philox streams differ, so the random modes agree with JAX
by rate, shape and invariant; ``co-smooth``, ``forward-pred``,
``expand_timesteps``, ``_member``, the causal extension and ``_corrupt``
at ``zero_ratio >= 1`` agree exactly (tests/test_torch_masking.py).

Under data parallelism (``parallel/``) a rank holds rows ``[row0, row0 +
B)`` of the global batch: every device draw takes the element offset of
those rows (``row0`` times a row's elements), so the rank draws its rows of
the single-process draw, and the one reduction over the batch, the
corruption's ``max(spikes)``, is taken over the data group. The host
draws are the same on every rank (one generator, seeded from the step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import all_reduce_
from ..utils.rng import fold_in
from .random import uniform

MASK_MODES = (
    "random",
    "temporal",
    "random_token",
    "causal",
    "neuron",
    "co-smooth",
    "forward-pred",
    "inter-region",
    "intra-region",
)


@dataclasses.dataclass(frozen=True)
class MaskParams:
    """Static masking hyperparameters (copy of the JAX record)."""

    ratio: float = 0.3
    zero_ratio: float = 1.0
    random_ratio: float = 1.0
    expand_prob: float = 0.0
    max_timespan: int = 1
    channels: Optional[Tuple[int, ...]] = None      # co-smooth
    timesteps: Optional[Tuple[int, ...]] = None     # forward-pred
    n_mask_regions: int = 1
    causal_zero: bool = True

    @classmethod
    def from_config(cls, cfg) -> "MaskParams":
        """From a loaded ``masker:`` node (mm.yaml), as JAX's
        ``MaskParams.from_config``."""
        def tup(v):
            return tuple(v) if v is not None else None

        return cls(
            ratio=float(cfg.ratio),
            zero_ratio=float(cfg.zero_ratio),
            random_ratio=float(cfg.random_ratio),
            expand_prob=float(cfg.expand_prob),
            max_timespan=int(cfg.max_timespan),
            channels=tup(cfg.get("channels")),
            timesteps=tup(cfg.get("timesteps")),
            n_mask_regions=int(cfg.n_mask_regions),
            causal_zero=bool(cfg.get("causal_zero", True)),
        )


@dataclasses.dataclass(frozen=True)
class RegionSets:
    """Region information for the region-conditioned modes.

    ``region_ids``: (N,) int32 tensor on the model's device, the region id
    of each neuron (-1 for padding). ``mask_candidates`` /
    ``target_candidates``: host int32 arrays of the region ids inter- and
    intra-region masking sample from ('all' expanded on the host); ``None``
    in a ``RegionTable`` row selected by a device session id."""

    region_ids: torch.Tensor
    mask_candidates: Optional[np.ndarray]
    target_candidates: Optional[np.ndarray]

    @classmethod
    def build(cls, region_ids: np.ndarray,
              mask_regions: Optional[Sequence] = ("all",),
              target_regions: Optional[Sequence] = ("all",),
              region_vocab: Optional[dict] = None,
              device=None) -> "RegionSets":
        region_ids = np.asarray(region_ids, dtype=np.int32)
        present = np.unique(region_ids[region_ids >= 0])

        def resolve(names) -> np.ndarray:
            if names is None:
                return present
            names = list(names)
            if "all" in names:
                return present
            if region_vocab is None:
                raise ValueError("need region_vocab to resolve region names")
            return np.asarray(sorted(region_vocab[n] for n in names
                                     if n in region_vocab), dtype=np.int32)

        return cls(region_ids=torch.as_tensor(region_ids, device=device),
                   mask_candidates=resolve(mask_regions).astype(np.int32),
                   target_candidates=resolve(target_regions).astype(
                       np.int32))


@dataclasses.dataclass(frozen=True)
class RegionTable:
    """Per-session region information stacked for session indexing (JAX
    ``RegionTable``, :134-180): ``region_ids`` (S, N_max) int32 on the
    model's device, -1 as padding; the candidate ids each session's
    inter- and intra-region masking draw from, (S, R_max) int32 host
    arrays padded with -1.

    ``select`` takes a session's row. With a device session id (a
    one-element tensor) the row of ``region_ids`` is gathered on the device,
    so a captured step serves every session; its candidates are ``None``,
    as the step reads the regions the host drew. With a host int it also
    gives the session's candidate rows, padded to ``R_max`` as JAX pads
    them, so ``host_draws`` draws ``min(n_mask_regions, R_max)`` slots for
    every session, the surplus as -1 (JAX ``_sample_regions``).

    Per-sample ids (a session-mixed batch, JAX :171-180) select a row a
    sample: ``(B,)`` device ids give ``(B, N_max)`` region ids gathered on
    the device (candidates ``None``); a host ``(B,)`` array also gives the
    ``(B, R_max)`` candidate rows, from which ``host_draws`` draws one row
    of picks per sample."""

    region_ids: torch.Tensor
    mask_candidates: np.ndarray
    target_candidates: np.ndarray

    @classmethod
    def build(cls, per_session_region_ids: Sequence[np.ndarray],
              mask_regions: Optional[Sequence] = ("all",),
              target_regions: Optional[Sequence] = ("all",),
              region_vocab: Optional[dict] = None,
              device=None) -> "RegionTable":
        sets = [RegionSets.build(ids, mask_regions, target_regions,
                                 region_vocab, device="cpu")
                for ids in per_session_region_ids]
        n_max = max(int(s.region_ids.shape[0]) for s in sets)
        r_max = max(max(len(s.mask_candidates), len(s.target_candidates))
                    for s in sets)

        def pad(a, n):
            a = np.asarray(a, dtype=np.int32)
            return np.pad(a, (0, n - len(a)), constant_values=-1)

        ids = np.stack([pad(s.region_ids.numpy(), n_max) for s in sets])
        return cls(
            region_ids=torch.as_tensor(ids, device=device),
            mask_candidates=np.stack([pad(s.mask_candidates, r_max)
                                      for s in sets]),
            target_candidates=np.stack([pad(s.target_candidates, r_max)
                                        for s in sets]))

    def to(self, device) -> "RegionTable":
        return dataclasses.replace(self,
                                   region_ids=self.region_ids.to(device))

    def host_rows(self, session_ids) -> RegionSets:
        """The candidate rows of host ``(B,)`` ids, for ``host_draws``
        only (``region_ids`` ``None``): no device work, so the host can
        draw a step's regions while the card runs earlier steps."""
        ids = np.asarray(session_ids, dtype=np.int64).reshape(-1)
        return RegionSets(region_ids=None,
                          mask_candidates=self.mask_candidates[ids],
                          target_candidates=self.target_candidates[ids])

    def select(self, session_id) -> RegionSets:
        """The ``RegionSets`` of one session: ``session_id`` a host int, or
        a one-element int tensor on the table's device (class
        docstring)."""
        if isinstance(session_id, torch.Tensor):
            if session_id.numel() > 1:
                return RegionSets(
                    region_ids=self.region_ids.index_select(0, session_id),
                    mask_candidates=None, target_candidates=None)
            return RegionSets(
                region_ids=self.region_ids.index_select(
                    0, session_id.reshape(1))[0],
                mask_candidates=None, target_candidates=None)
        if np.size(session_id) > 1:
            ids = torch.as_tensor(np.asarray(session_id, dtype=np.int64))
            return dataclasses.replace(
                self.host_rows(session_id),
                region_ids=self.region_ids.index_select(
                    0, ids.reshape(-1).to(self.region_ids.device)))
        sid = int(np.asarray(session_id).reshape(-1)[0])
        return RegionSets(region_ids=self.region_ids[sid],
                          mask_candidates=self.mask_candidates[sid],
                          target_candidates=self.target_candidates[sid])


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

# host draws travel as [width, ratio, region ids...] (f32)
_WIDTH, _RATIO, _REGIONS = 0, 1, 2
_TEMPORAL = ("temporal", "random_token", "causal")


def n_draws(params: MaskParams, batch: int = 1) -> int:
    """Length of one modality's host-draw vector: ``batch`` rows of region
    picks (more than one for per-sample region draws)."""
    return _REGIONS + int(batch) * int(params.n_mask_regions)


def draw_rows(draws: np.ndarray, params: MaskParams, row0: int,
              rows: int) -> np.ndarray:
    """Host draws (..., ``n_draws(params, B)``) of a batch's B rows of
    region picks cut to rows ``[row0, row0 + rows)`` (a data-parallel
    rank's samples), (..., ``n_draws(params, rows)``)."""
    n = int(params.n_mask_regions)
    picks = draws[..., _REGIONS + row0 * n:_REGIONS + (row0 + rows) * n]
    return np.concatenate([draws[..., :_REGIONS], picks], axis=-1)


def region_batch(regions: Optional[RegionSets]) -> int:
    """The rows of region picks a step draws: one per sample when
    ``regions`` holds per-sample candidate rows (``RegionTable.select`` of
    host ``(B,)`` ids), else one."""
    cands = None if regions is None else regions.mask_candidates
    return int(cands.shape[0]) if cands is not None and cands.ndim == 2 \
        else 1


def mask_keys(seed: int):
    """(k_mask, k_corrupt) of a mask seed, JAX's ``split`` of its key."""
    return fold_in(seed, 0), fold_in(seed, 1)


def _bernoulli(key: torch.Tensor, p, shape, stream: int = 0,
               row0: int = 0) -> torch.Tensor:
    """Bool draws, True with probability ``p`` (a float or a tensor
    broadcastable to ``shape``): Philox uniform < p, as
    jax.random.bernoulli; ``shape``'s rows are rows ``row0..`` of the
    draw."""
    row = 1
    for n in shape[1:]:
        row *= int(n)
    return uniform(key, shape, stream, offset=row0 * row) < p


def expand_timesteps(mask: torch.Tensor, width) -> torch.Tensor:
    """Dilate a (B, T) 0/1 mask with a centred window of ``width`` (a host
    int, or a device scalar): out[t] = any(mask[t - pad : t - pad + width]),
    pad = (width - 1) // 2, the banded-matrix product of JAX :186-201. A
    width of 1 is the identity."""
    T = mask.shape[-1]
    if isinstance(width, torch.Tensor):
        width = width.to(torch.int64)
    else:
        width = int(width)
    pad = (width - 1) // 2
    t = torch.arange(T, device=mask.device)
    off = t[None, :] - t[:, None] + pad              # [t_out, t_in]
    band = ((off >= 0) & (off < width)).to(mask.dtype)
    return (mask @ band.T) >= 1


def _corrupt(key: torch.Tensor, spikes: torch.Tensor, mask: torch.Tensor,
             params: MaskParams, row0: int = 0,
             data_group=None) -> torch.Tensor:
    """BERT-style corruption of masked positions (JAX :204-228), three
    draws under ``key`` (streams 0, 1, 2). The default ``zero_ratio >= 1``
    zeroes every masked element without a draw, a static short cut as in
    JAX. The random values' scale is the global batch's ``max(spikes)``
    (over ``data_group``)."""
    if params.zero_ratio >= 1.0:
        return torch.where(mask, 0.0, spikes)
    zero_idx = _bernoulli(key, params.zero_ratio, spikes.shape, 0,
                          row0) & mask
    out = torch.where(zero_idx, 0.0, spikes)
    if params.random_ratio <= 0.0:
        return out
    random_idx = (_bernoulli(key, params.random_ratio, spikes.shape, 1, row0)
                  & mask & ~zero_idx)
    top = all_reduce_(spikes.max().reshape(1), data_group,
                      torch.distributed.ReduceOp.MAX)[0]
    offset = row0 * spikes[0].numel()
    random_vals = top * uniform(key, spikes.shape, 2, offset=offset).to(
        spikes.dtype)
    return torch.where(random_idx, random_vals, out)


def _sample_regions(rng: np.random.Generator, candidates: np.ndarray,
                    n: int) -> np.ndarray:
    """``n`` region ids drawn uniformly without replacement from the
    valid (>= 0) candidates, on the host; slots past the valid count come
    back as -1 padding, which ``_member`` never matches (JAX :231-247)."""
    n = min(n, len(candidates))
    valid = candidates[candidates >= 0]
    picked = rng.permutation(valid)[:n]
    return np.concatenate([picked, np.full(n - len(picked), -1)]).astype(
        np.int32)


def _member(region_ids: torch.Tensor, sampled: torch.Tensor) -> torch.Tensor:
    """(N,) bool: does each neuron's region id appear in ``sampled``; -1
    entries of ``sampled`` are padding and match nothing (JAX :250-258)."""
    hit = ((region_ids[None, :] == sampled[:, None])
           & (sampled[:, None] >= 0))
    return hit.any(dim=0)


_INDEX_MASKS: Dict[tuple, torch.Tensor] = {}


def _index_mask(n: int, idx: Sequence[int], device) -> torch.Tensor:
    """(n,) bool with ``idx`` set, as JAX's ``zeros(n).at[idx].set(True)``:
    negative indices wrap once, indices still out of range are dropped
    (under MtM the 2-channel behavior modality gets the ap channel list).
    Built on the host once per (n, idx, device) and kept there: a step
    that reads it copies nothing from the host."""
    dev = torch.device(device)
    key = (int(n), tuple(int(i) for i in np.asarray(idx).reshape(-1)),
           str(dev))
    out = _INDEX_MASKS.get(key)
    if out is None:
        flat = np.asarray(key[1], dtype=np.int64)
        flat = np.where(flat < 0, flat + n, flat)
        flat = flat[(flat >= 0) & (flat < n)]
        host = np.zeros(n, dtype=bool)
        host[flat] = True
        out = _INDEX_MASKS[key] = torch.from_numpy(host).to(dev)
    return out


# ---------------------------------------------------------------------------
# per-mode masks: (mask (B, T, N) bool, targets (B, T, N) bool)
# ---------------------------------------------------------------------------

def causal_extend(pre: torch.Tensor) -> torch.Tensor:
    """Extend each row of a (B, T) bool mask from its first masked bin to
    the end (JAX :287-296; a row with no masked bin has its first at 0,
    so it is masked whole, as in JAX)."""
    first = torch.argmax(pre.to(torch.int32), dim=1)
    t = torch.arange(pre.shape[1], device=pre.device)
    return pre | (t[None, :] >= first[:, None])


def _temporal_draws(rng: np.random.Generator, params: MaskParams,
                    mode: str) -> Tuple[int, float]:
    """(timespan, ratio) of a temporal mask, drawn on the host as JAX's
    Python-level draws are (the ratio over the span rounded there)."""
    if mode == "causal":
        ratio = 0.01                      # hard-set, as the reference does
        timespan = int(rng.integers(1, params.max_timespan + 1))
    else:
        expand = rng.random() < params.expand_prob
        timespan = (int(rng.integers(1, params.max_timespan + 1))
                    if expand else 1)
        ratio = params.ratio / timespan
    return timespan, ratio


def host_draws(k_mask: int, params: MaskParams, mode: Optional[str],
               regions: Optional[RegionSets] = None,
               batch: int = 1) -> np.ndarray:
    """The host's draws for one mask under ``k_mask``, as the f32 vector
    the device reads: ``[width, ratio, region ids (-1 padded)]``, the
    region ids ``batch`` rows of ``n_mask_regions``. Width 1 and
    ``params.ratio`` where the mode (or ``None``, no mask) draws nothing
    on the host. With per-sample candidate rows (``(B, R_max)``, a
    session-mixed batch) the region modes draw one row of picks per
    sample from its own session's row, sample b from a generator of its
    own (seeded ``fold_in(key, b)``, as JAX splits the key per row,
    :330-349), so no sample's picks depend on another's session."""
    out = np.full(n_draws(params, batch), -1.0, dtype=np.float32)
    out[_WIDTH], out[_RATIO] = 1.0, params.ratio
    if mode in _TEMPORAL:
        out[_WIDTH], out[_RATIO] = _temporal_draws(
            np.random.default_rng(fold_in(k_mask, 0)), params, mode)
    elif mode in _REGION_FNS:
        if regions is None or regions.mask_candidates is None:
            raise ValueError(f"{mode} masking needs RegionSets with the "
                             "host's candidate ids")
        inter = mode == "inter-region"
        key = k_mask if inter else fold_in(k_mask, 0)
        cands = (regions.mask_candidates if inter
                 else regions.target_candidates)
        n = int(params.n_mask_regions)
        if cands.ndim == 1:
            picked = _sample_regions(np.random.default_rng(key), cands, n)
            out[_REGIONS:_REGIONS + len(picked)] = picked
            return out
        if len(cands) != batch:
            raise ValueError(f"{len(cands)} candidate rows for {batch} rows "
                             "of region picks")
        for b, row in enumerate(cands):
            picked = _sample_regions(
                np.random.default_rng(fold_in(key, b)), row, n)
            start = _REGIONS + b * n
            out[start:start + len(picked)] = picked
    return out


def _mask_temporal(key, draws, spikes, params: MaskParams, row0: int,
                   mode: str):
    B, T, N = spikes.shape
    token_mask = _bernoulli(key, draws[_RATIO], (B, T), 0, row0)
    token_mask = expand_timesteps(token_mask.float(), draws[_WIDTH])

    if mode == "causal" and params.causal_zero:
        mask = causal_extend(token_mask)[:, :, None].expand(B, T, N)
        return mask, token_mask[:, :, None].expand(B, T, N)
    mask = token_mask[:, :, None].expand(B, T, N)
    return mask, mask


def _mask_neuron(key, draws, spikes, params: MaskParams, row0: int):
    B, T, N = spikes.shape
    m = _bernoulli(key, params.ratio, (B, N), 0, row0)
    mask = m[:, None, :].expand(B, T, N)
    return mask, mask


def _mask_random(key, draws, spikes, params: MaskParams, row0: int):
    mask = _bernoulli(key, params.ratio, spikes.shape, 0, row0)
    return mask, mask


def _mask_co_smooth(key, draws, spikes, params: MaskParams, row0: int):
    B, T, N = spikes.shape
    if params.channels is None:
        raise ValueError("co-smooth masking needs MaskParams.channels")
    chan = _index_mask(N, params.channels, spikes.device)
    mask = chan[None, None, :].expand(B, T, N)
    return mask, mask


def _mask_forward_pred(key, draws, spikes, params: MaskParams, row0: int):
    B, T, N = spikes.shape
    if params.timesteps is None:
        raise ValueError("forward-pred masking needs MaskParams.timesteps")
    steps = _index_mask(T, params.timesteps, spikes.device)
    mask = steps[None, :, None].expand(B, T, N)
    return mask, mask


def _region_member(draws, spikes, region_ids: torch.Tensor):
    """(B, N) bool membership of the region ids the host sampled: once for
    the batch against ``region_ids`` (N,) (the reference samples regions
    once per batch), or a row of picks per sample against per-sample
    ``region_ids`` (B, N) (session-mixed batches, JAX :330-349)."""
    B, _, N = spikes.shape
    picks = draws[_REGIONS:].to(torch.int32)
    if region_ids.ndim == 2:
        picks = picks.reshape(B, -1)                           # (B, n)
        hit = ((region_ids[:, None, :] == picks[:, :, None])
               & (picks[:, :, None] >= 0))
        return hit.any(dim=1)
    member = _member(region_ids, picks)
    return member[None, :].expand(B, N)


def _mask_inter_region(key, draws, spikes, params: MaskParams, row0: int,
                       regions: RegionSets):
    B, T, N = spikes.shape
    member = _region_member(draws, spikes, regions.region_ids)
    mask = member[:, None, :].expand(B, T, N)
    return mask, mask


def _mask_intra_region(key, draws, spikes, params: MaskParams, row0: int,
                       regions: RegionSets):
    B, T, N = spikes.shape
    member = _region_member(draws, spikes, regions.region_ids)
    # inside the target regions Bernoulli(ratio); everything outside is
    # masked (probability 1), as the reference does
    probs = torch.where(member, params.ratio, 1.0)
    m = _bernoulli(key, probs, (B, N), 0, row0)
    mask = m[:, None, :].expand(B, T, N)
    return mask, mask & member[:, None, :]


_REGION_FNS = {"inter-region": _mask_inter_region,
               "intra-region": _mask_intra_region}
_PLAIN_FNS = {"neuron": _mask_neuron, "random": _mask_random,
              "co-smooth": _mask_co_smooth,
              "forward-pred": _mask_forward_pred}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def mask_is_drawn(params: MaskParams, mode: str, active: bool = True) -> bool:
    """Whether ``apply_mask`` draws a mask at all (else it returns the
    inputs untouched with a zero targets mask, JAX :377-418)."""
    if mode not in MASK_MODES:
        raise ValueError(f"Masking mode {mode!r} not implemented")
    return active and not (params.ratio == 0 and mode not in
                           ("co-smooth", "forward-pred", "inter-region"))


def apply_mask(
    seed,
    spikes: torch.Tensor,                # (B, T, N)
    params: MaskParams,
    mode: str,
    regions: Optional[RegionSets] = None,
    active: bool = True,
    draws: Optional[torch.Tensor] = None,
    row0: int = 0,
    data_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask + corrupt ``spikes``; returns (corrupted, targets mask int32).

    ``seed``: a host int (the keys are ``mask_keys(seed)`` and the host
    draws ``host_draws`` of ``k_mask``, both copied to the spikes' device
    here), or the step's ``keys`` tensor ``[k_mask, k_corrupt]`` (int64 on
    the spikes' device) with ``draws``, the vector ``host_draws`` made for
    this mode. ``active=False`` (eval without ``force_active``), or ratio 0
    in a mode that reads it, returns the inputs untouched with a zero
    targets mask (JAX :377-418). ``row0``: the global row of ``spikes``'
    first row (a data-parallel rank's), ``data_group`` the group the
    batch is split over (module docstring)."""
    if not mask_is_drawn(params, mode, active):
        return spikes, torch.zeros_like(spikes, dtype=torch.int32)
    if regions is None and mode in _REGION_FNS:
        raise ValueError(f"{mode} masking needs RegionSets")
    if not isinstance(seed, torch.Tensor):
        k_mask, k_corrupt = mask_keys(seed)
        draws = torch.from_numpy(
            host_draws(k_mask, params, mode, regions,
                       region_batch(regions))).to(spikes.device)
        seed = torch.tensor([k_mask, k_corrupt], dtype=torch.int64,
                            device=spikes.device)
    elif draws is None:
        raise ValueError("apply_mask with a keys tensor needs its draws")
    args = (seed[0:1], draws, spikes, params, int(row0))
    if mode in _TEMPORAL:
        mask, targets = _mask_temporal(*args, mode)
    elif mode in _REGION_FNS:
        mask, targets = _REGION_FNS[mode](*args, regions)
    else:
        mask, targets = _PLAIN_FNS[mode](*args)
    corrupted = _corrupt(seed[1:2], spikes, mask, params, int(row0),
                         data_group)
    return corrupted, targets.to(torch.int32)


def apply_mask_by_id(
    seed,
    spikes: torch.Tensor,
    params: MaskParams,
    mode_id: int,                        # host int index into ``modes``
    modes: Sequence[str],
    regions: Optional[RegionSets] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MtM per-step scheme choice: ``apply_mask`` of ``modes[mode_id]``
    (a host int seed)."""
    return apply_mask(seed, spikes, params, modes[int(mode_id)],
                      regions=regions)
