"""Session-level data: dense split arrays and synthetic sessions.

The port's copy of ``multi_modal_foundation_model_tpu/data/session.py:26-172``
(numpy only). ``synthetic_session`` draws the same numbers in the same
order as the JAX package's, so both give bit-identical arrays for one seed.
Loading IBL sessions from the hub is not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np

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
