"""Shared helpers of the multi-session mesh tests
(``tests/test_torch_ms_mesh_*.py``).

The port's ranks are ``tests/torch_parallel_workers.py`` processes over
gloo (``run_ms``, ``run_mm``: no JAX in them), started before JAX compiles
so both sides run at once. JAX runs its ``MultiSessionTrainer`` under
``build_mesh(dp, tp)`` on the 8 virtual CPU devices of ``conftest.py``,
Pallas in interpret mode. Both sides train the stitched TOY model of
``tests/torch_parity.py`` (4 heads) over ``workers.MS_SESSIONS`` (three
sessions of 24, 41 and 61 neurons in one 64-wide bucket) from JAX's
initial weights (``params_from_jax``), at dropout 0 with the co-smooth /
forward-pred menu; one epoch a path (six host or resident steps, five
session-mixed or sharded ones), the padded tail batches included.

Gates (those of ``tests/test_torch_parallel_lockstep.py``): the step-0
loss within 1e-5 max(1, |loss|), every step-0 gradient within rtol 2e-3 /
atol 1e-5; the epoch's losses within rtol 2e-5 and the parameters after
it within atol 2e-5 (the attention key biases, whose exact gradient is 0,
left out); the host draws equal; replicated gradients bit-equal over the
model group and parameters over the data group.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import numpy as np
import torch

import torch_parallel_workers as workers
from torch_parity import TOY
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops import masking as jmasking
from multi_modal_foundation_model_tpu.parallel import (build_mesh, model_axis_size,
                                                       shard_tree)
from multi_modal_foundation_model_tpu.train import multisession as jms
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC, make_optimizer)
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

GEOMETRY = {k: v for k, v in TOY.items() if k != "n_channels"}
MASK = dict(channels=(1, 5, 20, 30), timesteps=(12, 15, 19))
MENU = ("co-smooth", "forward-pred")
B = 8
SPEC = dict(kind="ms", geometry=GEOMETRY, dropout=0.0, embed_dropout=0.0,
            mask=MASK, menu=list(MENU), mixed=False, batch_size=B)
LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-3, 1e-5
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
RESIDENT = dict(device_resident_data=True)
MIXED = dict(RESIDENT, mixed_session_batches=True)
PATHS = {
    "host": {},
    "k1": RESIDENT,
    "k2": dict(RESIDENT, steps_per_dispatch=2),
    "mixed": MIXED,
    "sharded": dict(MIXED, shard_resident_sessions=True),
    "sharded_k2": dict(MIXED, shard_resident_sessions=True,
                       steps_per_dispatch=2),
}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def jax_loaders():
    sessions = {f"s{i}": jsession.synthetic_splits(
                    seed=i, n_trials=nt, n_neurons=n,
                    n_timesteps=GEOMETRY["max_F"], eid=f"s{i}")
                for i, (n, nt) in enumerate(workers.MS_SESSIONS)}
    return jms.build_multisession_loaders(
        sessions, batch_size=B, max_time_length=GEOMETRY["max_F"],
        pad_multiple=32)


def port_config(meta):
    return tmm.MultiModalConfig(
        **GEOMETRY, n_channels={"ap": meta["n_max"], "behavior": 2},
        n_sessions=len(meta["eids"]))


def jax_trainer(tmp):
    """JAX's one-device trainer of the lockstep and its meta."""
    train, val, _, meta = jax_loaders()
    table = jmasking.RegionTable.build(meta["per_session_region_ids"],
                                       region_vocab=meta["region_vocab"])
    cfg = jmm.MultiModalConfig(
        **GEOMETRY, n_channels={"ap": meta["n_max"], "behavior": 2},
        n_sessions=len(meta["eids"]), dropout=0.0, embed_dropout=0.0,
        remat_layers=False, mask_params=jmasking.MaskParams(**MASK))
    tcfg = jtrainer.TrainerConfig(num_epochs=4, log_dir=str(tmp), seed=0,
                                  mask_type="input", mask_mode=MENU,
                                  eval_every=10 ** 9)
    tr = jms.MultiSessionTrainer(jmm.MultiModal(cfg), train, val,
                                 JOC(lr=1e-3), tcfg, region_table=table,
                                 eid_to_sid=meta["eid_to_sid"])
    return tr, meta


def save_init(tr, meta, path) -> None:
    """JAX's initial params as the port's ``state_dict`` file."""
    torch.save(params_from_jax(np_tree(tr.state.params), port_config(meta)),
               path)


def under_mesh(tr, mesh):
    """A copy of the one-device trainer ``tr`` under ``mesh``, as JAX's
    ``__init__`` puts it there (its init is mesh-independent), with fresh
    step caches; ``initial`` keeps its first state on the host."""
    tr = copy.copy(tr)
    tr.mesh = mesh
    tr._tp_mesh = mesh if model_axis_size(mesh) > 1 else None
    tr._train_steps, tr._eval_steps = {}, {}
    tr._stacked_train_cache, tr._sharded_train_cache = {}, {}
    tr._device_data_cache = None          # resident splits of either mesh
    tr.initial, tr.base_tcfg = np_tree(tr.state), tr.tcfg
    tr.base_total = tr.tcfg.num_epochs * tr._steps_per_epoch()
    return tr


_STEP_GETTERS = ("_get_train_step", "_get_train_step_dr",
                 "_get_multi_step_dr", "_get_mixed_step_dr",
                 "_get_sharded_mixed_step_dr")


def jax_epoch(tr, over: dict) -> dict:
    """One epoch of JAX's mesh trainer ``tr`` from its initial state with
    ``over`` on its ``TrainerConfig``: the step losses, the host draws and
    the params after it."""
    tr.tcfg = dataclasses.replace(tr.base_tcfg, **over)
    state = jax.tree_util.tree_map(jax.numpy.asarray, tr.initial)
    total = tr.tcfg.num_epochs * tr._steps_per_epoch()
    if total != tr.base_total:
        # a session-mixed epoch has other steps: JAX's __init__ sizes
        # the one-cycle schedule from them
        tr.tx, tr.schedule = make_optimizer(tr.ocfg, total)
        state = jtrainer.TrainState.create(
            apply_fn=tr.model.apply, params=state.params, tx=tr.tx)
    tr.state = shard_tree(state, tr.mesh)
    losses, modes = [], []
    one, group = tr._sample_modes, tr._sample_group_modes
    tr._sample_modes = lambda: modes.append(one()) or modes[-1]
    tr._sample_group_modes = lambda n: modes.append(group(n)) or modes[-1]
    saved = {name: getattr(tr, name) for name in _STEP_GETTERS
             if hasattr(tr, name)}

    def recording(get):
        def getter(*a, **k):
            step = get(*a, **k)

            def run(*args):
                state, loss = step(*args)
                losses.extend(np.atleast_1d(np.asarray(loss)).tolist())
                return state, loss
            return run
        return getter

    for name, get in saved.items():
        setattr(tr, name, recording(get))
    try:
        tr.train_epoch(0)
    finally:
        for name in saved:
            delattr(tr, name)
        del tr._sample_modes, tr._sample_group_modes
    return dict(losses=losses, modes=modes, params=np_tree(tr.state.params))


def jax_step0(tr) -> dict:
    """JAX's step-0 loss and gradients on the trainer's first host batch
    of epoch 0 (its ``_grad_scan_step`` loss, no update)."""
    tr.state = shard_tree(jax.tree_util.tree_map(jax.numpy.asarray,
                                                 tr.initial), tr.mesh)
    tr._reseed_host_rng(0)
    eid = tr._epoch_schedule(0)[0]
    loader = tr.train_loaders[eid]
    loader.set_epoch(0)
    batch = tr._device_batch(next(iter(loader)))
    _, scheme = tr._sample_modes()
    sid = jax.numpy.asarray(tr.eid_to_sid[eid], jax.numpy.int32)
    regions = tr.region_table.select(sid)

    def loss_fn(params, batch, key):
        k_mask, k_drop = jax.random.split(key)
        out = tr.model.apply(
            {"params": params}, tr._build_mod_inputs(batch, None),
            masking_mode=scheme, mtm_modes=MENU, regions=regions,
            training=True, rngs={"mask": k_mask, "dropout": k_drop},
            session_id=sid, space_attn_mask=batch["space_attn_mask"])
        return out.loss

    grad_fn = tr._tp_wrap(jax.jit(jax.value_and_grad(loss_fn)))
    loss, grads = grad_fn(tr.state.params, batch,
                          jax.random.fold_in(tr.base_key, 0))
    return dict(loss0=float(loss), grads=np_tree(grads))


def assert_step0(got: dict, want: dict, meta) -> None:
    assert abs(got["loss0"] - want["loss0"]) < LOSS_TOL * max(
        1.0, abs(want["loss0"]))
    jgrads = params_from_jax(want["grads"], port_config(meta))
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert got["replicated_equal"]


def assert_epoch(got: dict, want: dict, meta=None, cfg=None) -> None:
    """The port's epoch against JAX's: host draws, losses, params (of the
    port's ``cfg``, by default the stitched toy's over ``meta``)."""
    assert got["modes"] == want["modes"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    final = params_from_jax(want["params"], cfg or port_config(meta))
    for name, p in got["params"].items():
        if name.endswith("key.bias"):
            continue        # exact gradient 0: Adam steps on f32 noise
        np.testing.assert_allclose(p.numpy(), final[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert got["data_equal"]


def start_ranks(dp: int, tp: int, paths, init, tmp, step0=True, **spec):
    """The port's dp x tp ranks training ``paths`` (names of ``PATHS``;
    with ``step0`` the first also returns its step-0 gradients)."""
    p = [dict(name=n, over=PATHS[n], grads=step0 and i == 0,
              save=n == "host") for i, n in enumerate(paths)]
    return workers.Ranks(dict(SPEC, **spec, dp=dp, tp=tp, init=str(init),
                              paths=p, log_dir=str(tmp / "port")),
                         dp * tp, tmp / "ranks")


def mesh_lockstep(dp: int, tp: int, paths, tmp, step0=True) -> dict:
    """The port's ranks and JAX's mesh trainer on ``paths``: every gate of
    the module docstring (the step-0 ones with ``step0``). Returns the
    port's results."""
    tr, meta = jax_trainer(tmp / "jax")
    save_init(tr, meta, tmp / "init.pt")
    ranks = start_ranks(dp, tp, paths, tmp / "init.pt", tmp, step0)
    jt = under_mesh(tr, build_mesh(dp=dp, tp=tp))
    want0 = jax_step0(jt) if step0 else None
    want = {name: jax_epoch(jt, PATHS[name]) for name in paths}
    got = ranks.result()
    if step0:
        assert_step0(got[paths[0]], want0, meta)
    for name in paths:
        assert_epoch(got[name], want[name], meta)
    return got
