"""The sharded resident sessions' schedule against JAX's, bit for bit.

``shard_assignment`` (the port's ``_shard_assignment``) and
``sharded_schedule`` (the index schedule of ``_train_epoch_dr_mixed_sharded``)
against JAX's ``MultiSessionTrainer``, run on stand-in loaders (trial counts
and array signatures only) with its block upload and its steps replaced by
recorders: the same shards, the same ``L``, and every step's (B,) indices
and K-grouping in the order JAX dispatches them, over several sets of
trial counts, the uneven ones included, one and two width buckets, dp 2
and 4, K 1 and 2. Neither side builds a model.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_modal_foundation_model_tpu.train import multisession as jms
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu_torch.train import multisession as tms

B = 8
# (trials, width) a session: equal, uneven, one session heavier than the
# rest, more shards than sessions, two width buckets
CASES = {
    "equal": [(11, 64)] * 3,
    "uneven": [(11, 64), (8, 64), (9, 64), (30, 64), (3, 64)],
    "one_heavy": [(50, 64), (4, 64), (5, 64), (6, 64)],
    "fewer_sessions_than_shards": [(7, 64), (13, 64)],
    "two_buckets": [(9, 32), (17, 64), (12, 32), (5, 64), (21, 64)],
}


def _loaders(case):
    return {f"e{i:02d}": types.SimpleNamespace(
                n_trials=n, batch_size=B,
                arrays={k: np.zeros((n, w), np.float32)
                        for k in jms.MultiSessionTrainer._DR_KEYS})
            for i, (n, w) in enumerate(CASES[case])}


def _jax_schedule(case, dp, K, seed, epoch):
    """JAX's shards, L and dispatched steps on stand-in loaders."""
    tr = jms.MultiSessionTrainer.__new__(jms.MultiSessionTrainer)
    tr.train_loaders = _loaders(case)
    tr.tcfg = jtrainer.TrainerConfig(seed=seed, steps_per_dispatch=K,
                                     log_dir="unused")
    tr.mesh = jax.sharding.Mesh(np.array(jax.devices()[:dp]), ("data",))
    tr.masking_schemes, tr.mixed_training = None, False
    tr._host_rng = np.random.default_rng(0)
    tr.state, tr.base_key = None, None
    shards = {}

    def sharded_data(eids):
        shard_eids, L = tr._shard_assignment(eids)
        shards[eids] = (shard_eids, L)
        return None, shard_eids, [
            sum(tr.train_loaders[e].n_trials for e in g) for g in shard_eids]

    steps = []

    def get_step(training_mode, use_mtm, scan):
        def step(state, data, idx, scheme, key):
            idx = np.asarray(idx)
            steps.append(idx if scan else idx[None])
            return state, jnp.zeros(len(idx) if scan else ())
        return step

    tr._sharded_train_data = sharded_data
    tr._get_sharded_mixed_step_dr = get_step
    tr._train_epoch_dr_mixed_sharded(epoch, K)
    return tr, shards, steps


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_shards_and_schedule_match_jax(case, dp, K):
    seed, epoch = 3, 5
    tr, shards, steps = _jax_schedule(case, dp, K, seed, epoch)
    loaders = tr.train_loaders
    n_trials = {e: l.n_trials for e, l in loaders.items()}
    pools = []
    for eids in tr._stack_groups():
        got = tms.shard_assignment(n_trials, eids, dp)
        assert got == shards[eids]
        pools.append([sum(n_trials[e] for e in g) for g in got[0]])
    # every session on exactly one shard, L the heaviest shard's load
    for eids, (shard_eids, L) in shards.items():
        assert sorted(e for g in shard_eids for e in g) == sorted(eids)
        assert L == max(sum(n_trials[e] for e in g) for g in shard_eids)
    got = tms.sharded_schedule(pools, B, dp, K, seed, epoch)
    # JAX runs a whole group as one scan, a short one as single steps
    flat = []
    for _, g in got:
        if len(g) == K and K > 1:
            flat.append(np.stack(g))
        else:
            flat.extend(idx[None] for idx in g)
    assert len(flat) == len(steps)
    for a, b in zip(flat, steps):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    total = sum(sum(p) for p in pools)
    want_steps = sum(-(-sum(p) // B) for p in pools)
    assert sum(len(g) for _, g in got) == want_steps
    assert want_steps >= total / B


def test_batch_not_divisible_by_dp_raises():
    with pytest.raises(ValueError, match="divide by dp"):
        tms.sharded_schedule([[10, 10, 10]], 9, 2, 1, 0, 0)
