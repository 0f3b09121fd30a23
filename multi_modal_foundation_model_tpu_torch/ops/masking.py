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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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


@dataclasses.dataclass(frozen=True)
class RegionSets:
    """Region information for the region-conditioned modes.

    ``region_ids``: (N,) int32 tensor on the model's device, the region id
    of each neuron (-1 for padding). ``mask_candidates`` /
    ``target_candidates``: host int32 arrays of the region ids inter- and
    intra-region masking sample from ('all' expanded on the host)."""

    region_ids: torch.Tensor
    mask_candidates: np.ndarray
    target_candidates: np.ndarray

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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

# host draws travel as [width, ratio, region ids...] (f32)
_WIDTH, _RATIO, _REGIONS = 0, 1, 2
_TEMPORAL = ("temporal", "random_token", "causal")


def n_draws(params: MaskParams) -> int:
    """Length of one modality's host-draw vector."""
    return _REGIONS + int(params.n_mask_regions)


def mask_keys(seed: int):
    """(k_mask, k_corrupt) of a mask seed, JAX's ``split`` of its key."""
    return fold_in(seed, 0), fold_in(seed, 1)


def _bernoulli(key: torch.Tensor, p, shape, stream: int = 0) -> torch.Tensor:
    """Bool draws, True with probability ``p`` (a float or a tensor
    broadcastable to ``shape``): Philox uniform < p, as
    jax.random.bernoulli."""
    return uniform(key, shape, stream) < p


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
             params: MaskParams) -> torch.Tensor:
    """BERT-style corruption of masked positions (JAX :204-228), three
    draws under ``key`` (streams 0, 1, 2). The default ``zero_ratio >= 1``
    zeroes every masked element without a draw, a static short cut as in
    JAX."""
    if params.zero_ratio >= 1.0:
        return torch.where(mask, 0.0, spikes)
    zero_idx = _bernoulli(key, params.zero_ratio, spikes.shape, 0) & mask
    out = torch.where(zero_idx, 0.0, spikes)
    if params.random_ratio <= 0.0:
        return out
    random_idx = (_bernoulli(key, params.random_ratio, spikes.shape, 1)
                  & mask & ~zero_idx)
    random_vals = spikes.max() * uniform(key, spikes.shape, 2).to(
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
               regions: Optional[RegionSets] = None) -> np.ndarray:
    """The host's draws for one mask under ``k_mask``, as the f32 vector
    the device reads: ``[width, ratio, region ids (-1 padded)]``. Width 1
    and ``params.ratio`` where the mode (or ``None``, no mask) draws nothing
    on the host."""
    out = np.full(n_draws(params), -1.0, dtype=np.float32)
    out[_WIDTH], out[_RATIO] = 1.0, params.ratio
    if mode in _TEMPORAL:
        out[_WIDTH], out[_RATIO] = _temporal_draws(
            np.random.default_rng(fold_in(k_mask, 0)), params, mode)
    elif mode in _REGION_FNS:
        if regions is None:
            raise ValueError(f"{mode} masking needs RegionSets")
        inter = mode == "inter-region"
        picked = _sample_regions(
            np.random.default_rng(k_mask if inter else fold_in(k_mask, 0)),
            regions.mask_candidates if inter else regions.target_candidates,
            params.n_mask_regions)
        out[_REGIONS:_REGIONS + len(picked)] = picked
    return out


def _mask_temporal(key, draws, spikes, params: MaskParams, mode: str):
    B, T, N = spikes.shape
    token_mask = _bernoulli(key, draws[_RATIO], (B, T))
    token_mask = expand_timesteps(token_mask.float(), draws[_WIDTH])

    if mode == "causal" and params.causal_zero:
        mask = causal_extend(token_mask)[:, :, None].expand(B, T, N)
        return mask, token_mask[:, :, None].expand(B, T, N)
    mask = token_mask[:, :, None].expand(B, T, N)
    return mask, mask


def _mask_neuron(key, draws, spikes, params: MaskParams):
    B, T, N = spikes.shape
    m = _bernoulli(key, params.ratio, (B, N))
    mask = m[:, None, :].expand(B, T, N)
    return mask, mask


def _mask_random(key, draws, spikes, params: MaskParams):
    mask = _bernoulli(key, params.ratio, spikes.shape)
    return mask, mask


def _mask_co_smooth(key, draws, spikes, params: MaskParams):
    B, T, N = spikes.shape
    if params.channels is None:
        raise ValueError("co-smooth masking needs MaskParams.channels")
    chan = _index_mask(N, params.channels, spikes.device)
    mask = chan[None, None, :].expand(B, T, N)
    return mask, mask


def _mask_forward_pred(key, draws, spikes, params: MaskParams):
    B, T, N = spikes.shape
    if params.timesteps is None:
        raise ValueError("forward-pred masking needs MaskParams.timesteps")
    steps = _index_mask(T, params.timesteps, spikes.device)
    mask = steps[None, :, None].expand(B, T, N)
    return mask, mask


def _region_member(draws, spikes, region_ids: torch.Tensor):
    """(B, N) bool membership of the region ids the host sampled once for
    the batch (the reference samples regions once per batch)."""
    B, _, N = spikes.shape
    member = _member(region_ids, draws[_REGIONS:].to(torch.int32))
    return member[None, :].expand(B, N)


def _mask_inter_region(key, draws, spikes, params: MaskParams,
                       regions: RegionSets):
    B, T, N = spikes.shape
    member = _region_member(draws, spikes, regions.region_ids)
    mask = member[:, None, :].expand(B, T, N)
    return mask, mask


def _mask_intra_region(key, draws, spikes, params: MaskParams,
                       regions: RegionSets):
    B, T, N = spikes.shape
    member = _region_member(draws, spikes, regions.region_ids)
    # inside the target regions Bernoulli(ratio); everything outside is
    # masked (probability 1), as the reference does
    probs = torch.where(member, params.ratio, 1.0)
    m = _bernoulli(key, probs, (B, N))
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask + corrupt ``spikes``; returns (corrupted, targets mask int32).

    ``seed``: a host int (the keys are ``mask_keys(seed)`` and the host
    draws ``host_draws`` of ``k_mask``, both copied to the spikes' device
    here), or the step's ``keys`` tensor ``[k_mask, k_corrupt]`` (int64 on
    the spikes' device) with ``draws``, the vector ``host_draws`` made for
    this mode. ``active=False`` (eval without ``force_active``), or ratio 0
    in a mode that reads it, returns the inputs untouched with a zero
    targets mask (JAX :377-418)."""
    if not mask_is_drawn(params, mode, active):
        return spikes, torch.zeros_like(spikes, dtype=torch.int32)
    if regions is None and mode in _REGION_FNS:
        raise ValueError(f"{mode} masking needs RegionSets")
    if not isinstance(seed, torch.Tensor):
        k_mask, k_corrupt = mask_keys(seed)
        draws = torch.from_numpy(
            host_draws(k_mask, params, mode, regions)).to(spikes.device)
        seed = torch.tensor([k_mask, k_corrupt], dtype=torch.int64,
                            device=spikes.device)
    elif draws is None:
        raise ValueError("apply_mask with a keys tensor needs its draws")
    args = (seed[0:1], draws, spikes, params)
    if mode in _TEMPORAL:
        mask, targets = _mask_temporal(*args, mode)
    elif mode in _REGION_FNS:
        mask, targets = _REGION_FNS[mode](*args, regions)
    else:
        mask, targets = _PLAIN_FNS[mode](*args)
    corrupted = _corrupt(seed[1:2], spikes, mask, params)
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
