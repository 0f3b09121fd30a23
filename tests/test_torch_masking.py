"""The port's masker (``ops/masking.py``) against the JAX package's.

Exact (bit for bit) where the JAX function draws nothing or where the
draw can be handed over: ``co-smooth`` and ``forward-pred`` (out-of-range
indices dropped, negative ones wrapped, as JAX's ``.at[].set``),
``expand_timesteps``, ``_member``, the causal extension of a given
pre-mask, ``_corrupt`` at ``zero_ratio=1``. The random modes draw from
torch generators where JAX draws from jax.random, so they are held by
rate (4 sigma), shape and invariants.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.ops import masking as jm
from multi_modal_foundation_model_tpu_torch.ops import masking as tm

B, T, N = 6, 20, 24


def _spikes(seed=0, shape=(B, T, N)):
    return np.random.default_rng(seed).poisson(1.0, shape).astype(np.float32)


def _both(mode, spikes, **params):
    jp, tp = jm.MaskParams(**params), tm.MaskParams(**params)
    jc, jt = jm.apply_mask(jax.random.PRNGKey(0), jnp.asarray(spikes), jp,
                           mode)
    tc, tt = tm.apply_mask(0, torch.from_numpy(spikes), tp, mode)
    return (np.asarray(jc), np.asarray(jt)), (tc.numpy(), tt.numpy())


@pytest.mark.parametrize("n", [N, 2])
@pytest.mark.parametrize("mode,key,idx", [
    ("co-smooth", "channels", (1, 5, 23, 30, -1, -40)),
    ("co-smooth", "channels", (0,)),
    ("forward-pred", "timesteps", (15, 16, 19, 25, -2)),
])
def test_fixed_modes_match_jax_exactly(mode, key, idx, n):
    """n = 2: the behavior modality under MtM gets the ap channel list."""
    spikes = _spikes(1, (B, T, n))
    (jc, jt), (tc, tt) = _both(mode, spikes, **{key: idx})
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tc, jc)
    assert tt.dtype == np.int32


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 7])
def test_expand_timesteps_matches_jax(width):
    m = (np.random.default_rng(width).random((B, T)) > 0.85).astype(
        np.float32)
    want = np.asarray(jm.expand_timesteps(jnp.asarray(m), width))
    got = tm.expand_timesteps(torch.from_numpy(m), width).numpy()
    np.testing.assert_array_equal(got, want)


def test_member_matches_jax_and_ignores_padding():
    ids = np.array([0, 1, 1, 2, -1, -1, 3, 0], np.int32)
    for sampled in ([1], [3, -1], [-1], [0, 2, -1]):
        s = np.array(sampled, np.int32)
        want = np.asarray(jm._member(jnp.asarray(ids), jnp.asarray(s)))
        got = tm._member(torch.from_numpy(ids), torch.from_numpy(s)).numpy()
        np.testing.assert_array_equal(got, want)
        assert not got[4:6].any()           # -1 padding never matches


def test_causal_extension_matches_jax():
    """JAX's causal mode returns (extended, pre-extension targets): the
    port's extension of JAX's own pre-mask gives JAX's extended mask,
    rows with no masked bin (extended whole, first = 0) included."""
    spikes = _spikes(2, (16, 100, 3))
    for seed in range(4):
        mask, pre = jm._mask_temporal(
            jax.random.PRNGKey(seed), jnp.asarray(spikes),
            jm.MaskParams(max_timespan=3), "causal")
        pre = torch.from_numpy(np.array(pre)[:, :, 0])
        got = tm.causal_extend(pre).numpy()
        np.testing.assert_array_equal(got, np.asarray(mask)[:, :, 0])
    assert pre.any(1).any() and not pre.any(1).all()


def test_corrupt_zero_ratio_one_matches_jax():
    spikes = _spikes(3)
    mask = np.random.default_rng(4).random(spikes.shape) > 0.6
    want = np.asarray(jm._corrupt(jax.random.PRNGKey(1), jnp.asarray(spikes),
                                  jnp.asarray(mask), jm.MaskParams()))
    got = tm._corrupt(1, torch.from_numpy(spikes), torch.from_numpy(mask),
                      tm.MaskParams()).numpy()
    np.testing.assert_array_equal(got, want)


def _rate_ok(x: torch.Tensor, p: float) -> bool:
    n = x.numel()
    return abs(x.float().mean().item() - p) < 4 * math.sqrt(p * (1 - p) / n)


def test_random_and_neuron_and_temporal_by_rate_and_shape():
    spikes = torch.from_numpy(_spikes(5, (64, 50, 40)))
    p = tm.MaskParams(ratio=0.3)
    c, t = tm.apply_mask(7, spikes, p, "random")
    assert t.shape == spikes.shape and t.dtype == torch.int32
    assert _rate_ok(t, 0.3)
    assert not c[t.bool()].any() and torch.equal(c[~t.bool()],
                                                 spikes[~t.bool()])
    _, t = tm.apply_mask(7, spikes, p, "neuron")
    assert (t == t[:, :1]).all() and _rate_ok(t[:, 0], 0.3)
    _, t = tm.apply_mask(7, spikes, p, "temporal")
    assert (t == t[:, :, :1]).all() and _rate_ok(t[:, :, 0], 0.3)
    _, t2 = tm.apply_mask(8, spikes, p, "temporal")
    assert not torch.equal(t, t2)                  # the seed matters
    _, t3 = tm.apply_mask(7, spikes, p, "random_token")
    assert torch.equal(t, t3)                      # an alias


def test_temporal_span_expansion():
    """expand_prob 1, max_timespan 2: the host draws a span of 1 or 2;
    with 2 the ratio is halved and the mask dilated by a width-2 window
    (out[t] = m[t] | m[t + 1]), so every masked bin past the first has a
    masked neighbour. Either way about ``ratio`` of the bins are masked."""
    spikes = torch.from_numpy(_spikes(6, (32, 60, 4)))
    p = tm.MaskParams(ratio=0.2, expand_prob=1.0, max_timespan=2)
    dilated = 0
    for seed in range(8):
        _, t = tm.apply_mask(seed, spikes, p, "temporal")
        row = t[:, :, 0].bool()
        assert abs(row.float().mean().item() - 0.2) < 0.04
        left = torch.nn.functional.pad(row, (1, 0))[:, :-1]
        right = torch.nn.functional.pad(row, (0, 1))[:, 1:]
        dilated += bool((left | right)[:, 1:][row[:, 1:]].all())
    assert 0 < dilated < 8                  # both spans were drawn


def test_causal_targets_are_the_pre_extension_mask():
    spikes = torch.from_numpy(_spikes(7, (16, 100, 3)))
    c, t = tm.apply_mask(4, spikes, tm.MaskParams(), "causal")
    pre = t[:, :, 0].bool()
    ext = tm.causal_extend(pre)
    assert torch.equal(c[:, :, 0] == 0, ext | (spikes[:, :, 0] == 0))


def _regions(device="cpu"):
    ids = np.array([0] * 5 + [1] * 6 + [2] * 7 + [3] * 2 + [-1] * 4,
                   np.int32)
    return ids, tm.RegionSets.build(ids, device=device)


def test_inter_region_masks_whole_regions():
    ids, regions = _regions()
    spikes = torch.from_numpy(_spikes(8))
    seen = set()
    for seed in range(12):
        _, t = tm.apply_mask(seed, spikes, tm.MaskParams(), "inter-region",
                             regions=regions)
        cols = t[0, 0].bool().numpy()
        assert (t == t[:1, :1]).all()               # one draw per batch
        (r,) = np.unique(ids[cols])
        assert r >= 0 and (cols == (ids == r)).all()
        seen.add(int(r))
    assert seen == {0, 1, 2, 3}


def test_intra_region_targets_inside_target_regions():
    ids, regions = _regions()
    spikes = torch.from_numpy(_spikes(9, (64, 10, N)))
    for seed in range(6):
        _, t = tm.apply_mask(seed, spikes, tm.MaskParams(ratio=0.3),
                             "intra-region", regions=regions)
        c, _ = tm.apply_mask(seed, spikes, tm.MaskParams(ratio=0.3),
                             "intra-region", regions=regions)
        mask = c[:, 0] == 0                         # inputs zeroed = mask
        tgt = t[:, 0].bool()
        (r,) = np.unique(ids[tgt.any(0).numpy()])   # one target region
        inside = torch.from_numpy(ids == r)
        assert not tgt[:, ~inside].any()
        assert (mask[:, ~inside] | (spikes[:, 0, ~inside] == 0)).all()


def test_sampling_more_regions_than_exist_pads_with_minus_one():
    rng = np.random.default_rng(0)
    cand = np.array([4, 7, -1, -1], np.int32)
    got = tm._sample_regions(rng, cand, 3)
    assert sorted(got.tolist()) == [-1, 4, 7]
    ids, regions = _regions()
    _, t = tm.apply_mask(0, torch.from_numpy(_spikes(10)),
                         tm.MaskParams(n_mask_regions=9), "inter-region",
                         regions=regions)
    cols = t[0, 0].bool().numpy()
    assert (cols == (ids >= 0)).all()               # every real region


def test_inactive_and_ratio_zero_and_dispatch():
    spikes = torch.from_numpy(_spikes(11))
    c, t = tm.apply_mask(0, spikes, tm.MaskParams(), "temporal",
                         active=False)
    assert c is spikes and not t.any()
    c, t = tm.apply_mask(0, spikes, tm.MaskParams(ratio=0.0), "neuron")
    assert c is spikes and not t.any()
    _, t = tm.apply_mask(0, spikes, tm.MaskParams(ratio=0.0, channels=(2,)),
                         "co-smooth")
    assert t[:, :, 2].all() and t.sum() == B * T
    modes = ("neuron", "temporal")
    for i, mode in enumerate(modes):
        a = tm.apply_mask_by_id(5, spikes, tm.MaskParams(), i, modes)
        b = tm.apply_mask(5, spikes, tm.MaskParams(), mode)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        tm.apply_mask(0, spikes, tm.MaskParams(), "inter-region")


def test_region_sets_resolve_names_like_jax():
    ids = np.array([2, 0, 1, -1], np.int32)
    vocab = {"CA1": 0, "DG": 1, "LP": 2}
    for names in (("all",), ("DG", "CA1"), None, ("LP", "nope")):
        j = jm.RegionSets.build(ids, names, names, vocab)
        t = tm.RegionSets.build(ids, names, names, vocab)
        np.testing.assert_array_equal(t.mask_candidates,
                                      np.asarray(j.mask_candidates))
        np.testing.assert_array_equal(t.region_ids.numpy(),
                                      np.asarray(j.region_ids))
