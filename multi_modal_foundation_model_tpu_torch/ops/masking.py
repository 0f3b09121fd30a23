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

Randomness: JAX splits a PRNG key; here every function takes a host
integer ``seed`` and derives what it needs with ``utils.rng.fold_in``. The
element masks are drawn on the spikes' device from a ``torch.Generator``
seeded that way. The scalars a Python branch reads (``expand``,
``timespan``) and the region draws are made on the host from a numpy
generator of the same seed, so no device value is ever read back (a branch
on a CUDA scalar would stall the stream). ``apply_mask_by_id`` is a
Python dispatch on the host mode id where JAX has ``lax.switch``.

jax.random and torch streams differ, so the random modes agree with JAX
by rate, shape and invariant; ``co-smooth``, ``forward-pred``,
``expand_timesteps``, ``_member``, the causal extension and ``_corrupt``
at ``zero_ratio >= 1`` agree exactly (tests/test_torch_masking.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.rng import fold_in

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

def _bernoulli(gen: torch.Generator, p, shape, device) -> torch.Tensor:
    """Bool draws, True with probability ``p`` (a float or a tensor
    broadcastable to ``shape``): uniform < p, as jax.random.bernoulli."""
    return torch.rand(shape, generator=gen, device=device) < p


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def expand_timesteps(mask: torch.Tensor, width: int) -> torch.Tensor:
    """Dilate a (B, T) 0/1 mask with a centred window of ``width``:
    out[t] = any(mask[t - pad : t - pad + width]), pad = (width - 1) // 2,
    the banded-matrix product of JAX :186-201."""
    T = mask.shape[-1]
    pad = (int(width) - 1) // 2
    t = torch.arange(T, device=mask.device)
    off = t[None, :] - t[:, None] + pad              # [t_out, t_in]
    band = ((off >= 0) & (off < width)).to(mask.dtype)
    return (mask @ band.T) >= 1


def _corrupt(seed: int, spikes: torch.Tensor, mask: torch.Tensor,
             params: MaskParams) -> torch.Tensor:
    """BERT-style corruption of masked positions (JAX :204-228). The
    default ``zero_ratio >= 1`` zeroes every masked element without a
    draw, a static short cut as in JAX."""
    if params.zero_ratio >= 1.0:
        return torch.where(mask, 0.0, spikes)
    dev = spikes.device
    gen = _generator(seed, dev)
    zero_idx = _bernoulli(gen, params.zero_ratio, spikes.shape, dev) & mask
    out = torch.where(zero_idx, 0.0, spikes)
    if params.random_ratio <= 0.0:
        return out
    random_idx = (_bernoulli(gen, params.random_ratio, spikes.shape, dev)
                  & mask & ~zero_idx)
    random_vals = spikes.max() * torch.rand(spikes.shape, generator=gen,
                                            device=dev, dtype=spikes.dtype)
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


def _index_mask(n: int, idx: Sequence[int], device) -> torch.Tensor:
    """(n,) bool with ``idx`` set, as JAX's ``zeros(n).at[idx].set(True)``:
    negative indices wrap once, indices still out of range are dropped
    (under MtM the 2-channel behavior modality gets the ap channel list)."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    idx = np.where(idx < 0, idx + n, idx)
    idx = idx[(idx >= 0) & (idx < n)]
    out = torch.zeros(n, dtype=torch.bool, device=device)
    out[torch.as_tensor(idx, device=device)] = True
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


def _mask_temporal(seed, spikes, params: MaskParams, mode: str):
    B, T, N = spikes.shape
    host = np.random.default_rng(fold_in(seed, 0))
    if mode == "causal":
        ratio = 0.01                      # hard-set, as the reference does
        timespan = int(host.integers(1, params.max_timespan + 1))
    else:
        expand = host.random() < params.expand_prob
        timespan = (int(host.integers(1, params.max_timespan + 1))
                    if expand else 1)
        ratio = params.ratio / timespan
    gen = _generator(fold_in(seed, 1), spikes.device)
    token_mask = _bernoulli(gen, ratio, (B, T), spikes.device)
    if timespan > 1:
        token_mask = expand_timesteps(token_mask.float(), timespan)

    if mode == "causal" and params.causal_zero:
        mask = causal_extend(token_mask)[:, :, None].expand(B, T, N)
        return mask, token_mask[:, :, None].expand(B, T, N)
    mask = token_mask[:, :, None].expand(B, T, N)
    return mask, mask


def _mask_neuron(seed, spikes, params: MaskParams):
    B, T, N = spikes.shape
    m = _bernoulli(_generator(seed, spikes.device), params.ratio, (B, N),
                   spikes.device)
    mask = m[:, None, :].expand(B, T, N)
    return mask, mask


def _mask_random(seed, spikes, params: MaskParams):
    mask = _bernoulli(_generator(seed, spikes.device), params.ratio,
                      spikes.shape, spikes.device)
    return mask, mask


def _mask_co_smooth(seed, spikes, params: MaskParams):
    B, T, N = spikes.shape
    if params.channels is None:
        raise ValueError("co-smooth masking needs MaskParams.channels")
    chan = _index_mask(N, params.channels, spikes.device)
    mask = chan[None, None, :].expand(B, T, N)
    return mask, mask


def _mask_forward_pred(seed, spikes, params: MaskParams):
    B, T, N = spikes.shape
    if params.timesteps is None:
        raise ValueError("forward-pred masking needs MaskParams.timesteps")
    steps = _index_mask(T, params.timesteps, spikes.device)
    mask = steps[None, :, None].expand(B, T, N)
    return mask, mask


def _region_member(seed, spikes, candidates: np.ndarray,
                   region_ids: torch.Tensor, n_regions: int):
    """(B, N) bool membership after ONE draw of ``n_regions`` region ids
    shared by the batch (the reference samples regions once per batch)."""
    B, _, N = spikes.shape
    sampled = _sample_regions(np.random.default_rng(seed), candidates,
                              n_regions)
    member = _member(region_ids,
                     torch.as_tensor(sampled, device=region_ids.device))
    return member[None, :].expand(B, N)


def _mask_inter_region(seed, spikes, params: MaskParams,
                       regions: RegionSets):
    B, T, N = spikes.shape
    member = _region_member(seed, spikes, regions.mask_candidates,
                            regions.region_ids, params.n_mask_regions)
    mask = member[:, None, :].expand(B, T, N)
    return mask, mask


def _mask_intra_region(seed, spikes, params: MaskParams,
                       regions: RegionSets):
    B, T, N = spikes.shape
    member = _region_member(fold_in(seed, 0), spikes,
                            regions.target_candidates, regions.region_ids,
                            params.n_mask_regions)
    # inside the target regions Bernoulli(ratio); everything outside is
    # masked (probability 1), as the reference does
    probs = torch.where(member, params.ratio, 1.0)
    m = _bernoulli(_generator(fold_in(seed, 1), spikes.device), probs,
                   (B, N), spikes.device)
    mask = m[:, None, :].expand(B, T, N)
    return mask, mask & member[:, None, :]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def apply_mask(
    seed: int,
    spikes: torch.Tensor,                # (B, T, N)
    params: MaskParams,
    mode: str,
    regions: Optional[RegionSets] = None,
    active: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask + corrupt ``spikes``; returns (corrupted, targets mask int32).

    ``active=False`` (eval without ``force_active``), or ratio 0 in a mode
    that reads it, returns the inputs untouched with a zero targets mask
    (JAX :377-418)."""
    if mode not in MASK_MODES:
        raise ValueError(f"Masking mode {mode!r} not implemented")
    if not active or (params.ratio == 0 and mode not in
                      ("co-smooth", "forward-pred", "inter-region")):
        return spikes, torch.zeros_like(spikes, dtype=torch.int32)

    k_mask, k_corrupt = fold_in(seed, 0), fold_in(seed, 1)
    if mode in ("temporal", "random_token", "causal"):
        mask, targets = _mask_temporal(k_mask, spikes, params, mode)
    elif mode == "neuron":
        mask, targets = _mask_neuron(k_mask, spikes, params)
    elif mode == "random":
        mask, targets = _mask_random(k_mask, spikes, params)
    elif mode == "co-smooth":
        mask, targets = _mask_co_smooth(k_mask, spikes, params)
    elif mode == "forward-pred":
        mask, targets = _mask_forward_pred(k_mask, spikes, params)
    else:                                    # the two region modes
        if regions is None:
            raise ValueError(f"{mode} masking needs RegionSets")
        fn = (_mask_inter_region if mode == "inter-region"
              else _mask_intra_region)
        mask, targets = fn(k_mask, spikes, params, regions)

    corrupted = _corrupt(k_corrupt, spikes, mask, params)
    return corrupted, targets.to(torch.int32)


def apply_mask_by_id(
    seed: int,
    spikes: torch.Tensor,
    params: MaskParams,
    mode_id: int,                        # host int index into ``modes``
    modes: Sequence[str],
    regions: Optional[RegionSets] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MtM per-step scheme choice: ``apply_mask`` of ``modes[mode_id]``."""
    return apply_mask(seed, spikes, params, modes[int(mode_id)],
                      regions=regions)
