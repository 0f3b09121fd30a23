"""The port's ``MultiSessionTrainer`` at dp 2 x tp 2 against its own
single process, at dropout 0.4 (embedding dropout 0.2), mixed objectives
and the random MtM menu with both region modes, on host batches and on
session-mixed resident batches (each sample's region picks drawn for the
global batch, the rank's rows kept), one epoch each, at the gates of
``tests/test_torch_parallel_lockstep.py::test_dropout_step_matches_the_single_process``;
then the checkpoint the ranks wrote restores into one process bit for bit.
"""

import numpy as np
import torch

import torch_parallel_workers as workers
from torch_ms_mesh import (GEOMETRY, GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                           LOSS_TOL, MIXED, PARAM_ATOL, SPEC)
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm

MENU = ["temporal", "neuron", "random", "inter-region", "intra-region"]


def _close(got, want):
    assert got["modes"] == want["modes"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    for name, p in got["params"].items():
        if name.endswith("key.bias"):
            continue        # exact gradient 0: Adam steps on f32 noise
        np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert got["data_equal"]
    # eval scores the global batch: the single process's loss and R²
    assert abs(got["eval_loss"] - want["eval_loss"]) <= 1e-5 * abs(
        want["eval_loss"])
    assert abs(got["eval_r2"] - want["eval_r2"]) <= 1e-5


def test_dropout_epochs_match_the_single_process(tmp_path):
    _, _, _, meta = workers.ms_loaders(SPEC)
    cfg = tmm.MultiModalConfig(
        **GEOMETRY, n_channels={"ap": meta["n_max"], "behavior": 2},
        n_sessions=len(meta["eids"]))
    torch.save(tmm.MultiModal(cfg, device="cpu").state_dict(),
               tmp_path / "init.pt")
    spec = dict(SPEC, dropout=0.4, embed_dropout=0.2, mixed=True, menu=MENU,
                init=str(tmp_path / "init.pt"), max_grad_norm=1.0,
                paths=[dict(name="host", over={}, grads=True, save=True),
                       dict(name="mixed", over=MIXED)])
    four = tmp_path / "four"
    ranks = workers.Ranks(dict(spec, dp=2, tp=2, log_dir=str(four)), 4,
                          tmp_path / "ranks")
    want = workers.run_ms(dict(spec, log_dir=str(tmp_path / "one")), None)
    got = ranks.result()
    g, w = got["host"], want["host"]
    assert abs(g["loss0"] - w["loss0"]) < LOSS_TOL * max(1.0, abs(w["loss0"]))
    for name, grad in g["grads"].items():
        np.testing.assert_allclose(grad.numpy(), w["grads"][name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert g["replicated_equal"]
    for name in ("host", "mixed"):
        _close(got[name], want[name])
    # every objective and both region modes ran
    assert {m for m, _ in got["host"]["modes"]} == {
        "encoding", "decoding", "token_masking"}
    schemes = {MENU[s] for _, s in got["host"]["modes"] + got["mixed"]["modes"]}
    assert {"inter-region", "intra-region"} <= schemes

    # the ranks' checkpoint (single-device layout) in one process
    single = workers.ms_trainer(spec, None, four / "host")
    assert single.restore("last") == 0 and single.step == g["step"] == 6
    for name, p in single.model.state_dict().items():
        torch.testing.assert_close(p, g["params"][name], rtol=0, atol=0,
                                   msg=name)
    assert single.optimizer.count == 6
