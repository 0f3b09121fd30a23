"""Shared helpers for the port-vs-JAX tests (``tests/test_torch_*.py``).

Both sides get the same numpy inputs, made from a seed; JAX params go to
the port through ``params_from_jax``. The JAX side runs the Pallas
attention kernel (``attn_impl="pallas"``, interpret mode on the CPU, as the
JAX package's own tests run it) unless a test says otherwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops import masking as jmasking
from multi_modal_foundation_model_tpu.train import multisession as jms
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import masking as tmasking
from multi_modal_foundation_model_tpu_torch.train import (
    MultiSessionTrainer, OptimizerConfig, TrainerConfig)
from multi_modal_foundation_model_tpu_torch.train import multisession as tms
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

# tier-1 runs pytest-xdist with 6 workers: one thread each
torch.set_num_threads(1)

# toy geometry of the port tests
N_AP, N_BEH, T = 24, 2, 20
TOY = dict(n_channels={"ap": N_AP, "behavior": N_BEH}, max_F=T,
           hidden_size=64, n_heads=4, n_enc_layers=2, n_dec_layers=2,
           inter_size=128)
# the full width of the reference model (ROADMAP: N=668, T=100, H=256,
# 8 heads, 5+5 layers, FFN 512)
FULL = dict(n_channels={"ap": 668, "behavior": 2}, max_F=100,
            hidden_size=256, n_heads=8, n_enc_layers=5, n_dec_layers=5,
            inter_size=512)


def make_batch(seed: int, B: int, t: int = T, n_ap: int = N_AP,
               n_beh: int = N_BEH, pad_tail: int = 0):
    """numpy (spikes, behavior, attn, timestamps); the last ``pad_tail``
    trials are padding (attention mask all zero)."""
    rng = np.random.default_rng(seed)
    spikes = rng.poisson(1.0, (B, t, n_ap)).astype(np.float32)
    beh = rng.normal(size=(B, t, n_beh)).astype(np.float32)
    attn = np.ones((B, t), np.int64)
    if pad_tail:
        attn[-pad_tail:] = 0
    ts = np.tile(np.arange(t, dtype=np.int64), (B, 1))
    return spikes, beh, attn, ts


def jax_inputs(spikes, beh, attn, ts, ap_eval, beh_eval):
    def mi(x, ev):
        return jmm.ModalityInput(
            inputs=jnp.asarray(x), targets=jnp.asarray(x),
            attn_mask=jnp.asarray(attn), timestamps=jnp.asarray(ts),
            eval_mask=jnp.asarray(ev))
    return {"ap": mi(spikes, ap_eval), "behavior": mi(beh, beh_eval)}


def torch_inputs(spikes, beh, attn, ts, ap_eval, beh_eval, device="cpu"):
    def mi(x, ev):
        return tmm.ModalityInput(
            inputs=torch.as_tensor(x, device=device),
            targets=torch.as_tensor(x, device=device),
            attn_mask=torch.as_tensor(attn, device=device),
            timestamps=torch.as_tensor(ts, device=device),
            eval_mask=torch.as_tensor(ev, device=device))
    return {"ap": mi(spikes, ap_eval), "behavior": mi(beh, beh_eval)}


def jax_model(attn_impl: str = "pallas", seed: int = 0, geometry=TOY,
              **over):
    """(JAX MultiModal, its params) at ``geometry``, init from ``seed``.
    The param tree does not depend on the attention impl, so init runs the
    fast XLA form; the returned model runs ``attn_impl``."""
    cfg = jmm.MultiModalConfig(**{**geometry, "attn_impl": attn_impl,
                                  **over})
    t, n_ap = cfg.max_F, cfg.n_channels["ap"]
    spikes, beh, attn, ts = make_batch(seed, 2, t, n_ap)
    inputs = jax_inputs(spikes, beh, attn, ts, np.zeros_like(spikes, np.int32),
                        np.zeros_like(beh, np.int32))
    init_model = jmm.MultiModal(dataclasses.replace(cfg, attn_impl="xla"))
    params = jax.jit(init_model.init)({"params": jax.random.PRNGKey(seed)},
                                      inputs)
    return (jmm.MultiModal(cfg),
            jax.tree_util.tree_map(np.asarray, params["params"]))


def port_model(jax_params, geometry=TOY, device="cpu", **over):
    """The port's MultiModal of the same config, carrying ``jax_params``."""
    cfg = tmm.MultiModalConfig(**{**geometry, **over})
    model = tmm.MultiModal(cfg, device=device)
    model.load_state_dict(params_from_jax(jax_params, cfg), strict=True)
    return model


def load_flax_params(module: torch.nn.Module, params) -> None:
    """Load a flax sub-tree into a port module whose parameter paths equal
    the flax ones (Linear weight = kernel transposed, LayerNorm weight =
    scale)."""
    sd = {}
    for name in module.state_dict():
        *path, leaf = name.split(".")
        node = params
        for p in path:
            node = node[p]
        if leaf == "weight":
            value = node["kernel"].T if "kernel" in node else node["scale"]
        else:
            value = node[leaf]
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    module.load_state_dict(sd, strict=True)


# --- multi-session (tests/test_torch_*multisession*.py) ---------------------

# three sessions of 24-61 neurons (neurons, trials): s1's 24 train trials
# fill 3 batches of 8, s0's and s2's 28 end in a padded batch
MS_SESSIONS = ((24, 36), (41, 30), (61, 36))
MS_T = 20
MS_GEOMETRY = dict(max_F=MS_T, hidden_size=32, n_heads=2, n_enc_layers=2,
                   n_dec_layers=2, inter_size=64)


def ms_sessions(session_module) -> dict:
    """The three synthetic sessions (seed = index) from either package's
    ``data.session`` (bit-identical arrays)."""
    return {f"s{i}": session_module.synthetic_splits(
                seed=i, n_trials=nt, n_neurons=n, n_timesteps=MS_T,
                eid=f"s{i}")
            for i, (n, nt) in enumerate(MS_SESSIONS)}


def ms_config(module, meta: dict, **over):
    """``module.MultiModalConfig`` (either package's) of the stitched toy
    model over ``meta``'s sessions."""
    return module.MultiModalConfig(**{
        **MS_GEOMETRY, "n_channels": {"ap": meta["n_max"], "behavior": 2},
        "n_sessions": len(meta["eids"]), **over})

# the trainers' lockstep: a deterministic MtM menu, dropout 0
MS_MASK = dict(channels=(1, 5, 20, 30), timesteps=(12, 15, 19))
MS_MENU = ("co-smooth", "forward-pred")
MS_PARAM_ATOL = 2e-5


def ms_build(side: str, n_buckets: int = 1, batch_size: int = 8):
    """``build_multisession_loaders`` of ``side`` ("jax" or "port") over
    the three sessions, padded to multiples of 32."""
    ms, session = ((jms, jsession) if side == "jax" else (tms, tsession))
    return ms.build_multisession_loaders(
        ms_sessions(session), batch_size=batch_size, max_time_length=MS_T,
        pad_multiple=32, n_buckets=n_buckets)


def jax_trainer(tmp, n_buckets=1, **over):
    """JAX's ``MultiSessionTrainer`` of the lockstep (Pallas attention,
    dropout 0, remat off, lr 1e-3), ``over`` on its ``TrainerConfig``."""
    train, val, _, meta = ms_build("jax", n_buckets)
    table = jmasking.RegionTable.build(meta["per_session_region_ids"],
                                       region_vocab=meta["region_vocab"])
    model = jmm.MultiModal(ms_config(
        jmm, meta, dropout=0.0, embed_dropout=0.0, remat_layers=False,
        mask_params=jmasking.MaskParams(**MS_MASK)))
    tcfg = jtrainer.TrainerConfig(**{**dict(
        num_epochs=2, log_dir=str(tmp), seed=0, mask_type="input",
        mask_mode=MS_MENU, eval_every=10 ** 9), **over})
    return jms.MultiSessionTrainer(model, train, val, JOC(lr=1e-3), tcfg,
                                   region_table=table,
                                   eid_to_sid=meta["eid_to_sid"])


def port_trainer(tmp, init=None, n_buckets=1, model_over=None, **over):
    """The port's ``MultiSessionTrainer`` of the lockstep on the CPU,
    carrying JAX's ``init`` params when given (else seeded from 0)."""
    train, val, _, meta = ms_build("port", n_buckets)
    table = tmasking.RegionTable.build(meta["per_session_region_ids"],
                                       region_vocab=meta["region_vocab"],
                                       device="cpu")
    kw = dict(dropout=0.0, embed_dropout=0.0, remat_layers=False,
              mask_params=tmasking.MaskParams(**MS_MASK))
    kw.update(model_over or {})
    cfg = ms_config(tmm, meta, **kw)
    model = tmm.MultiModal(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict(params_from_jax(init, cfg), strict=True)
    tcfg = TrainerConfig(**{**dict(
        num_epochs=2, log_dir=str(tmp), seed=0, mask_type="input",
        mask_mode=MS_MENU, eval_every=10 ** 9), **over})
    return MultiSessionTrainer(model, train, val, OptimizerConfig(lr=1e-3),
                               tcfg, region_table=table,
                               eid_to_sid=meta["eid_to_sid"])


def record_modes(tr) -> list:
    """Record the trainer's host draws (both packages' trainers)."""
    modes = []
    one, group = tr._sample_modes, tr._sample_group_modes

    def sample():
        modes.append(one())
        return modes[-1]

    def sample_group(n):
        modes.append(group(n))
        return modes[-1]

    tr._sample_modes, tr._sample_group_modes = sample, sample_group
    return modes


def assert_params_close(tr, jparams):
    want = params_from_jax(jparams, tr.model.config)
    for name, p in tr.model.state_dict().items():
        if name.endswith("key.bias"):
            continue        # exact gradient 0: Adam steps on f32 noise
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=MS_PARAM_ATOL, rtol=0, err_msg=name)


# session-mixed batches (tests/test_torch_mixed_sessions*.py)
MS_MIXED = dict(device_resident_data=True, mixed_session_batches=True)
MS_STEP_RTOL = 2e-5


def mixed_lockstep(K, n_buckets, tmp_path):
    """One mixed epoch of JAX's resident trainer and the port's from the
    same weights: the same host draws, per-step losses and final
    parameters within the lockstep's gates."""
    over = dict(MS_MIXED, steps_per_dispatch=K)
    j = jax_trainer(tmp_path / "j", n_buckets=n_buckets, **over)
    init = jax.tree_util.tree_map(np.asarray, j.state.params)
    jmodes = record_modes(j)
    jlosses = []
    get_step = j._get_mixed_step_dr

    def recording(*args, **kwargs):
        step = get_step(*args, **kwargs)

        def run(*a):
            state, loss = step(*a)
            jlosses.extend(np.atleast_1d(np.asarray(loss)).tolist())
            return state, loss
        return run

    j._get_mixed_step_dr = recording
    j.train_epoch(0)
    t = port_trainer(tmp_path / "t", init, n_buckets=n_buckets, **over)
    tmodes = record_modes(t)
    losses = t.train_epoch(0)["step_losses"]
    assert tmodes == jmodes
    assert len(losses) == t._steps_per_epoch() == j._steps_per_epoch()
    np.testing.assert_allclose(losses, jlosses, rtol=MS_STEP_RTOL, atol=0)
    assert_params_close(t, jax.tree_util.tree_map(np.asarray,
                                                  j.state.params))
