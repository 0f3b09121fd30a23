"""Per-session evaluation of a session-stitched model against the JAX
package.

Three synthetic sessions of 24-61 neurons (200 trials each: 20 test
trials), T=20, H=32, 2+2 layers, padded to N_max 64; a JAX stitched model
(Pallas attention, interpret mode) and the port's on its converted weights
(heads shrunk as in ``tests/test_torch_eval.py``, so that R² sits where
f32 rounding stays far below the tolerance).

- ``load_multisession_model_data_local``: the checkpoint's weights
  exactly, one full-test-set loader per eid at N_max, ``eid_to_sid`` from
  ``sessions.json``; it refuses a single-session checkpoint and an eid
  the checkpoint did not train on.
- ``co_smoothing_eval(session_id=)``: all six modes on one session and
  ``modal_spike`` on the other two, ``use_mtm=True``, against JAX's
  harness: per-neuron bps and R² within 1e-4 absolute, NaN in the same
  places (``tests/test_torch_eval.py``'s tolerance).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import MS_SESSIONS, MS_T, ms_config
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.eval import harness as jharness
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.eval import harness as tharness
from multi_modal_foundation_model_tpu_torch.eval import loading as tload
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.train import save_checkpoint
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

ATOL = 1e-4
N_MAX = 64
META = {"eids": [f"s{i}" for i in range(len(MS_SESSIONS))],
        "num_neurons": [n for n, _ in MS_SESSIONS], "n_max": N_MAX}


def _test_split(session_module, i):
    n = MS_SESSIONS[i][0]
    return session_module.synthetic_splits(
        seed=20 + i, n_trials=200, n_neurons=n, n_timesteps=MS_T,
        eid=f"s{i}").test


@pytest.fixture(scope="module")
def stitched(tmp_path_factory):
    """JAX model + params, the port's model on them, and a port checkpoint
    directory (``model_config.json``, ``sessions.json``, ``model_best``)."""
    jcfg = ms_config(jmm, META)
    rng = np.random.default_rng(0)
    spikes = rng.poisson(1.0, (2, MS_T, N_MAX)).astype(np.float32)
    beh = rng.normal(size=(2, MS_T, 2)).astype(np.float32)

    def mi(x):
        return jmm.ModalityInput(
            inputs=jnp.asarray(x), targets=jnp.asarray(x),
            attn_mask=jnp.ones((2, MS_T), jnp.int32),
            timestamps=jnp.tile(jnp.arange(MS_T), (2, 1)),
            eval_mask=jnp.zeros(x.shape, jnp.int32))

    init = jmm.MultiModal(ms_config(jmm, META, attn_impl="xla"))
    params = jax.jit(init.init)({"params": jax.random.PRNGKey(3)},
                                {"ap": mi(spikes), "behavior": mi(beh)},
                                session_id=jnp.asarray(0, jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    for mod, bias in (("ap", np.log(0.3)), ("behavior", 0.0)):
        head = params[f"out_proj_{mod}"]
        head["kernel"] = head["kernel"] * np.float32(0.05)
        head["bias"] = np.full_like(head["bias"], bias)
    tcfg = ms_config(tmm, META)
    tmodel = tmm.MultiModal(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)

    ckpt = tmp_path_factory.mktemp("ms_ckpt")
    tload.save_model_config(str(ckpt), tcfg)
    save_checkpoint(str(ckpt), "best", {"model": tmodel.state_dict()})
    (ckpt / "sessions.json").write_text(json.dumps(META))
    return jmm.MultiModal(jcfg), params, tmodel, ckpt


def test_load_multisession_checkpoint(stitched):
    _, _, tmodel, ckpt = stitched
    tests = {e: _test_split(tsession, i) for i, e in enumerate(META["eids"])}
    model, loaders, eid_to_sid = tload.load_multisession_model_data_local(
        model_dir=str(ckpt), test_sessions=tests, max_time_length=MS_T,
        device="cpu")
    assert eid_to_sid == {e: i for i, e in enumerate(META["eids"])}
    assert model.config.n_sessions == 3
    assert model.config.force_active is False
    assert model.config.mask_params.ratio == 0.0
    for (n, a), b in zip(tmodel.state_dict().items(),
                         model.state_dict().values()):
        torch.testing.assert_close(b, a, atol=0, rtol=0, msg=n)
    for i, (eid, loader) in enumerate(loaders.items()):
        assert len(loader) == 1 and loader.shuffle is False
        batch = next(iter(loader))
        assert batch["spikes_data"].shape == (20, MS_T, N_MAX)
        assert batch["space_attn_mask"][0].sum() == MS_SESSIONS[i][0]


def test_load_multisession_rejects_single_session(stitched, tmp_path):
    _, _, _, ckpt = stitched
    cfg = tmm.MultiModalConfig(n_channels={"ap": 24, "behavior": 2},
                               max_F=MS_T, hidden_size=32, n_heads=2,
                               n_enc_layers=1, n_dec_layers=1, inter_size=64)
    tload.save_model_config(str(tmp_path), cfg)
    (tmp_path / "sessions.json").write_text((ckpt / "sessions.json")
                                            .read_text())
    with pytest.raises(ValueError, match="single-session"):
        tload.load_multisession_model_data_local(
            model_dir=str(tmp_path),
            test_sessions={"s0": _test_split(tsession, 0)},
            max_time_length=MS_T, device="cpu")


def test_load_multisession_rejects_unknown_eid(stitched):
    _, _, _, ckpt = stitched
    with pytest.raises(ValueError, match="not in the checkpoint"):
        tload.load_multisession_model_data_local(
            model_dir=str(ckpt),
            test_sessions={"other": _test_split(tsession, 0)},
            max_time_length=MS_T, device="cpu")
    assert os.path.exists(ckpt / "model_best.pt")


def _loaders(i):
    kw = dict(batch_size=20, max_time_length=MS_T, max_space_length=N_MAX,
              shuffle=False)
    return (jloader.make_loader(_test_split(jsession, i), **kw),
            tloader.make_loader(_test_split(tsession, i), **kw))


HELD = list(range(14, 20))
CASES = ([(2, m) for m in ("per_neuron", "forward_pred", "inter_region",
                           "intra_region", "modal_spike", "modal_behavior")]
         + [(0, "modal_spike"), (1, "modal_spike")])


@pytest.mark.parametrize("sid,mode", CASES,
                         ids=[f"s{i}-{m}" for i, m in CASES])
def test_co_smoothing_eval_session_matches_jax(stitched, sid, mode,
                                               tmp_path):
    jmodel, params, tmodel, _ = stitched
    jl, tl = _loaders(sid)
    held = HELD if mode in ("forward_pred", "modal_spike",
                            "modal_behavior") else None
    kw = dict(use_mtm=True, n_time_steps=MS_T, held_out_list=held, chunk=8,
              session_id=sid)
    want = jharness.co_smoothing_eval(jmodel, params, jl, mode,
                                      save_path=str(tmp_path / "j"), **kw)
    got = tharness.co_smoothing_eval(tmodel, tl, mode,
                                     save_path=str(tmp_path / "t"), **kw)
    if mode == "modal_behavior":
        want, got = want[f"{mode}_behav_results"], got[f"{mode}_behav_results"]
    assert want.keys() == got.keys()
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], atol=ATOL, rtol=0)
    if mode == "modal_behavior":
        return
    for name in ("bps.npy", "r2.npy"):
        a = np.load(tmp_path / "j" / name)
        b = np.load(tmp_path / "t" / name)
        assert a.shape == b.shape == ((MS_SESSIONS[sid][0],)
                                      + ((2,) if name == "r2.npy" else ()))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0, err_msg=name)
        assert np.isfinite(a).any()
