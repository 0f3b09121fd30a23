"""Session-mixed batches in the port against the JAX package.

The toy of ``test_torch_multisession.py`` (three sessions of 24-61 neurons
padded to N_max = 64, T=20, H=32, 2+2 layers; JAX's attention through
Pallas in interpret mode). A session-mixed batch carries per-sample
``(B,)`` session ids: each sample runs its own session's stitched rows,
session embedding, token zeroing and region draws. Tolerances:

- the mixed eval forward against JAX's on converted weights: preds atol
  1e-4, loss rtol 1e-5 (the stitched forward's gates); against the port's
  own scalar-id forward, sample by sample: atol 1e-6 (one batched GEMM
  against one GEMM; JAX's own test holds 1e-6);
- per-sample zeroing: the other samples' predictions atol 1e-6 when
  sample 0's data and session change;
- per-sample region draws, the epoch length (``_steps_per_epoch``) and
  the refusal without resident data: exact;
- the gather's fixed-order backward (``ops/session_rows.py``) against a
  float64 sum: atol 1e-6 and rtol 1e-6 (an f32 sum of a dozen N(0, 1)
  rows); two runs bit for bit; exact zeros for absent sessions;
- the mixed resident trainer in lockstep with JAX's
  ``_train_epoch_dr_mixed`` (deterministic menu co-smooth / forward-pred,
  dropout 0, remat off, lr 1e-3): the same host draws exactly, per-step
  losses rtol 2e-5, parameters atol 2e-5 except the attention key biases
  (``tests/test_torch_trainer.py``'s gates); here two buckets at K=1 and
  one bucket at K=2, the other two cases in
  ``test_torch_mixed_sessions_lockstep.py``;
- resume: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (MS_MIXED as MIXED, jax_inputs, jax_trainer,
                          mixed_lockstep, ms_build, ms_config, port_trainer,
                          torch_inputs)
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import masking as tmasking
from multi_modal_foundation_model_tpu_torch.ops.session_rows import (
    session_rows, session_rows_grad)
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

PRED_ATOL, LOSS_RTOL = 1e-4, 1e-5
# two trials of each session, interleaved
SIDS = np.array([2, 0, 1, 0, 2, 1])


@pytest.fixture(scope="module")
def mixed():
    """JAX's and the port's stitched models on the same weights, and a
    batch of six test trials from the three sessions (at N_max)."""
    _, _, test, meta = ms_build("port")
    jcfg = ms_config(jmm, meta)
    rows = {s: 0 for s in range(3)}
    arrays = {k: [] for k in ("spikes_data", "target", "time_attn_mask",
                              "spikes_timestamps", "space_attn_mask")}
    for s in SIDS:
        a = test[meta["eids"][s]].arrays
        for k in arrays:
            arrays[k].append(a[k][rows[s]])
        rows[s] += 1
    arrays = {k: np.stack(v) for k, v in arrays.items()}
    spikes, beh = arrays["spikes_data"], arrays["target"]
    ap_eval = np.zeros_like(spikes, np.int32)
    ap_eval[:, 12:] = 1                       # the last 8 bins held out
    masks = (ap_eval, np.zeros_like(beh, np.int32))
    init_model = jmm.MultiModal(dataclasses.replace(jcfg, attn_impl="xla"))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(init_model.init)(
        {"params": jax.random.PRNGKey(0)},
        jax_inputs(spikes, beh, arrays["time_attn_mask"],
                   arrays["spikes_timestamps"], *masks),
        session_id=jnp.asarray(0, jnp.int32))["params"])
    tcfg = ms_config(tmm, meta)
    tmodel = tmm.MultiModal(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmm.MultiModal(jcfg), params, tmodel, arrays, masks, meta


def _port_inputs(arrays, masks):
    return torch_inputs(arrays["spikes_data"], arrays["target"],
                        arrays["time_attn_mask"],
                        arrays["spikes_timestamps"], *masks)


def test_mixed_forward_matches_jax_and_scalar_forward(mixed):
    """The (B,)-id eval forward: JAX's on the same weights (preds, loss,
    counts; padded neurons out of the loss per sample), and sample by
    sample the port's forward of the whole batch under the sample's own
    session as a scalar id (JAX ``test_multisession.py:347``)."""
    jmodel, params, tmodel, arrays, masks, _ = mixed
    out = jax.jit(lambda sid: jmodel.apply(
        {"params": params},
        jax_inputs(arrays["spikes_data"], arrays["target"],
                   arrays["time_attn_mask"], arrays["spikes_timestamps"],
                   *masks),
        session_id=sid, space_attn_mask=arrays["space_attn_mask"]))(
            jnp.asarray(SIDS, jnp.int32))
    space = torch.as_tensor(arrays["space_attn_mask"])
    with torch.no_grad():
        got = tmodel(_port_inputs(arrays, masks),
                     session_id=torch.as_tensor(SIDS),
                     space_attn_mask=space)
        scalar = {s: tmodel(_port_inputs(arrays, masks), session_id=s,
                            space_attn_mask=space).mod_preds["ap"]
                  for s in range(3)}
    for mod in ("ap", "behavior"):
        np.testing.assert_allclose(got.mod_preds[mod].numpy(),
                                   np.asarray(out.mod_preds[mod]),
                                   atol=PRED_ATOL, rtol=0, err_msg=mod)
        assert float(got.mod_n_examples[mod]) == \
            float(out.mod_n_examples[mod])
    np.testing.assert_allclose(float(got.loss), float(out.loss),
                               rtol=LOSS_RTOL)
    for i, s in enumerate(SIDS):
        torch.testing.assert_close(got.mod_preds["ap"][i], scalar[s][i],
                                   atol=1e-6, rtol=0)


def test_per_sample_zeroing_no_cross_contamination(mixed):
    """Inter-region masking over per-sample region draws: the token masks
    differ by sample, and each sample is zeroed by its own row, so the
    other samples' predictions do not move when sample 0's data and
    session change (JAX ``test_multisession.py:438``)."""
    _, params, _, arrays, masks, meta = mixed
    table = tmasking.RegionTable.build(meta["per_session_region_ids"],
                                       region_vocab=meta["region_vocab"],
                                       device="cpu")
    cfg = ms_config(tmm, meta, dropout=0.0, embed_dropout=0.0,
                    mask_params=tmasking.MaskParams(ratio=0.3,
                                                    n_mask_regions=1))
    model = tmm.MultiModal(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg), strict=True)

    def fwd(spikes, sids):
        inputs = torch_inputs(spikes, arrays["target"],
                              arrays["time_attn_mask"],
                              arrays["spikes_timestamps"], *masks)
        with torch.no_grad():
            return model(inputs, masking_mode=0,
                         mtm_modes=("inter-region",),
                         regions=table.select(sids), training=True, seed=4,
                         session_id=torch.as_tensor(sids)).mod_preds["ap"]

    base = fwd(arrays["spikes_data"], SIDS)
    spikes2 = arrays["spikes_data"].copy()
    spikes2[0] = np.random.default_rng(9).poisson(
        0.4, spikes2[0].shape).astype(np.float32)
    sids2 = SIDS.copy()
    sids2[0] = 1
    changed = fwd(spikes2, sids2)
    torch.testing.assert_close(changed[1:], base[1:], atol=1e-6, rtol=0)
    assert not torch.allclose(changed[0], base[0])


@pytest.mark.parametrize("mode", ["inter-region", "intra-region"])
def test_per_sample_region_draws(mode):
    """A row of picks per sample from its own session's candidate row:
    ``min(n, R_max)`` slots each, the surplus -1 for a session with fewer
    regions; the device masker then masks, per sample, whole regions of
    its own session and nothing else (JAX ``test_multisession.py:388``,
    ``_region_member`` :330-349)."""
    ids = [np.array([0, 0, 1, 1, -1, -1]), np.array([0, 1, 2, 3, 3, 4])]
    table = tmasking.RegionTable.build(ids, device="cpu")
    params = tmasking.MaskParams(ratio=0.3, n_mask_regions=3)
    sids = np.array([0, 1, 0, 1])
    B, T, N = len(sids), 7, 6
    regions = table.select(sids)
    assert tuple(regions.region_ids.shape) == (B, N)
    assert tmasking.region_batch(regions) == B
    for k in range(10):
        draws = tmasking.host_draws(100 + k, params, mode, regions, B)
        assert len(draws) == tmasking.n_draws(params, B) == 2 + 3 * B
        picks = draws[2:].reshape(B, 3).astype(int)
        for b, s in enumerate(sids):
            valid = picks[b][picks[b] >= 0]
            assert len(set(valid.tolist())) == len(valid)
            assert set(valid.tolist()) <= set(ids[s][ids[s] >= 0].tolist())
            assert (picks[b] == -1).sum() == (1 if s == 0 else 0)
        # the host-only rows draw the same picks
        np.testing.assert_array_equal(
            tmasking.host_draws(100 + k, params, mode,
                                table.host_rows(sids), B), draws)
        _, targets = tmasking.apply_mask(
            torch.tensor([100 + k, 7]), torch.ones(B, T, N), params, mode,
            regions=regions, draws=torch.from_numpy(draws))
        for b, s in enumerate(sids):
            hit = np.isin(ids[s], picks[b][picks[b] >= 0])
            masked = targets[b].numpy().any(axis=0)
            assert not masked[~hit].any()
            if mode == "inter-region":
                assert (masked == hit).all()     # whole regions


@pytest.mark.parametrize("n_buckets", [1, 2])
def test_steps_per_epoch_matches_jax(n_buckets, tmp_path):
    """A mixed epoch is ``sum over buckets of ceil(trials / B)`` steps,
    the OneCycle schedule's length, as JAX counts it (JAX
    ``test_multisession.py:695``); without mixing, every session's
    batches."""
    j = jax_trainer(tmp_path / "j", n_buckets=n_buckets, **MIXED)
    t = port_trainer(tmp_path / "t", n_buckets=n_buckets, **MIXED)
    assert t._steps_per_epoch() == j._steps_per_epoch()
    trials = [sum(t.train_loaders[e].n_trials for e in g)
              for g in t._stack_groups()]
    assert len(trials) == n_buckets
    assert t._steps_per_epoch() == sum(-(-n // 8) for n in trials)
    plain = port_trainer(tmp_path / "p", n_buckets=n_buckets,
                         device_resident_data=True)
    assert plain._steps_per_epoch() == 11


def test_mixed_without_resident_data_raises(tmp_path):
    """The streaming path has no cross-session gather (JAX
    ``test_multisession.py:421``)."""
    tr = port_trainer(tmp_path, mixed_session_batches=True)
    with pytest.raises(ValueError, match="device_resident_data"):
        tr.train_epoch(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_session_rows_fixed_order_backward(dtype):
    """The gather's backward sums each session's gradient rows in f32:
    within 1e-6 (absolute and relative) of a float64 sum, the same bits
    on a second run, exact zeros for the sessions absent from the batch,
    in the stack's dtype; the forward casts the stack to ``dtype`` before
    the gather."""
    gen = torch.Generator().manual_seed(0)
    S, B = 5, 37
    stack = torch.randn(S, 6, 10, generator=gen, requires_grad=True)
    ids = torch.randint(0, 3, (B,), generator=gen)      # sessions 3, 4 absent
    g = torch.randn(B, 6, 10, generator=gen).to(dtype)
    grads = []
    for _ in range(2):
        stack.grad = None
        rows = session_rows(stack, ids, dtype)
        assert rows.dtype == dtype
        torch.testing.assert_close(rows, stack.detach().to(dtype)[ids],
                                   atol=0, rtol=0)
        rows.backward(g)
        grads.append(stack.grad.clone())
    assert grads[0].dtype == torch.float32
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros(S, 6, 10, dtype=torch.float64)
    want.index_add_(0, ids, g.double())
    torch.testing.assert_close(grads[0].double(), want, atol=1e-6,
                               rtol=1e-6)
    assert (grads[0][3:] == 0).all()
    assert torch.equal(session_rows_grad(g, ids, S), grads[0])


@pytest.mark.parametrize("K,n_buckets", [(1, 2), (2, 1)],
                         ids=["k1_two_buckets", "k2_one_bucket"])
def test_mixed_lockstep_with_jax(K, n_buckets, tmp_path):
    mixed_lockstep(K, n_buckets, tmp_path)


def _dropout_trainer(tmp, n_buckets=1):
    """Dropout 0.4 with remat, the region and random MtM schemes, mixed
    objectives, mixed batches, K=3."""
    return port_trainer(
        tmp, n_buckets=n_buckets,
        model_over=dict(dropout=0.4, embed_dropout=0.2, remat_layers=True),
        mixed_training=True, steps_per_dispatch=3,
        mask_mode=("temporal", "neuron", "inter-region", "intra-region"),
        **MIXED)


def test_mixed_resume_is_exact(tmp_path):
    """Two epochs straight equal one epoch, a save, a restore into a fresh
    trainer and the second epoch, bit for bit; every step's graph key
    says it mixes sessions."""
    a = _dropout_trainer(tmp_path / "a")
    keys = []
    run = a.graphs.run
    a.graphs.run = lambda key, step: (keys.append(key), run(key, step))
    la = a.train_epoch(0)["step_losses"] + a.train_epoch(1)["step_losses"]
    assert keys and all(k[2] is True for k in keys)
    b = _dropout_trainer(tmp_path / "b")
    lb = b.train_epoch(0)["step_losses"]
    b.save_model("last", epoch=0)
    c = _dropout_trainer(tmp_path / "b")
    assert c.restore("last") == 0 and c.step == b.step
    lb += c.train_epoch(1)["step_losses"]
    assert lb == la and np.isfinite(la).all()
    for (n, pa), pc in zip(a.model.state_dict().items(),
                           c.model.state_dict().values()):
        torch.testing.assert_close(pc, pa, atol=0, rtol=0, msg=n)
