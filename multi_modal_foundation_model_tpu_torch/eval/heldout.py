"""Heldout masks for the co-smoothing eval modes.

The port's copy of ``multi_modal_foundation_model_tpu/eval/heldout.py``
(numpy only). Each eval mode reduces to holding out a set of *channels* or
a set of *timesteps*; the (K, T, N) mask is then one broadcast. Returns
``{"spikes": masked, "heldout_idxs": hd, "eval_mask": 1 - mask}`` with
int64 masks, as the JAX package's (and the reference's ``heldout_mask``,
``src/utils/eval_utils.py:988-1045``) does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _region_channels(neuron_regions: np.ndarray, region: str) -> np.ndarray:
    """(n_region,) global channel indices belonging to ``region``."""
    return np.flatnonzero(np.asarray(neuron_regions) == region)


def heldout_mask(
    spike_data: np.ndarray,                 # (K, T, N)
    mode: str = "manual",
    heldout_idxs: np.ndarray = np.array([]),
    n_active: int = 1,
    target_regions: Optional[Sequence[str]] = None,
    neuron_regions: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    spike_data = np.asarray(spike_data)
    K, T, N = spike_data.shape
    idxs = np.asarray(heldout_idxs, dtype=np.int64)

    time_axis = mode in ("forward_pred", "modal_spike", "modal_behavior")

    if time_axis:
        # hold out whole timesteps (modal_behavior's (K, T, C) layout
        # indexes the same axis, so all three share one code path)
        held_t = np.zeros(T, dtype=np.int64)
        held_t[idxs] = 1
        mask = np.broadcast_to((1 - held_t)[None, :, None],
                               spike_data.shape).copy()
        hd = idxs

    else:
        # hold out channels: each mode yields (held (N,) 0/1, hd indices)
        if mode == "manual":
            held, hd = np.zeros(N, np.int64), idxs
            held[idxs] = 1

        elif mode == "most":
            hd = np.argsort(spike_data.mean(axis=(0, 1)))[-n_active:]
            held = np.zeros(N, np.int64)
            held[hd] = 1

        elif mode == "inter_region":
            # every target region fully held out; hd reports only the
            # locally-indexed subset per region (reference contract)
            per_region = [_region_channels(neuron_regions, r)
                          for r in target_regions]
            held = np.zeros(N, np.int64)
            held[np.concatenate(per_region)] = 1
            hd = np.stack([ch[idxs] for ch in per_region]).flatten()

        elif mode == "intra_region":
            # everything OUTSIDE the target regions is held out; within
            # them only the locally-indexed channels are (leave-one-out)
            per_region = [_region_channels(neuron_regions, r)
                          for r in target_regions]
            held = np.ones(N, np.int64)
            held[np.concatenate(per_region)] = 0
            if idxs.size:
                hd = np.stack([ch[idxs] for ch in per_region]).flatten()
                held[hd] = 1
            else:
                hd = np.stack(per_region).flatten()

        else:
            raise NotImplementedError(f"heldout mode {mode!r}")

        mask = np.broadcast_to((1 - held)[None, None, :],
                               spike_data.shape).copy()

    return {
        "spikes": spike_data * mask,
        "heldout_idxs": hd,
        "eval_mask": 1 - mask,
    }
