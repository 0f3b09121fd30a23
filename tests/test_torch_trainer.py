"""The port's trainer against the JAX package's, step by step.

**Lockstep** (the anchor): a JAX ``MultiModalTrainer`` and the port's run
side by side for 2 epochs from the same synthetic splits (bit-identical),
the same initial weights (the JAX state through ``params_from_jax``), the
same loader order (``(seed, epoch)`` permutations) and the same host draws
of objective and scheme (``mixed_training`` over the deterministic MtM menu
``co-smooth`` / ``forward-pred``), dropout 0, 14 AdamW updates at lr 1e-3.
Per-step losses agree within rtol 2e-5 and the final parameters within
atol 2e-5 (f32 sums in other orders), once with ``remat_layers`` on and
once off. The JAX side runs its default Pallas attention (K1/K2 in
interpret mode). The attention key biases are left out of the parameter
comparison: softmax is invariant to a per-query shift, so their exact
gradient is 0 and both sides' values are Adam steps on f32 rounding noise
(they move the loss by nothing, as the matching losses show). 14 updates,
not fewer: with ``warmup_pct * total_steps < 2`` JAX clamps the warm-up
phase to one step where torch's ``OneCycleLR`` does not
(``train/schedule.py``).

**Remat replay**: at dropout 0.4 and a fixed step seed the gradients with
``remat_layers=True`` equal those with ``False`` exactly (the recompute
replays every dropout draw). **Resume**: 2 epochs straight equal 1 epoch,
save, restore into a fresh trainer, 1 epoch, exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from torch_parity import TOY
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.eval import loading as tload
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops.masking import (
    MaskParams as TMP)
from multi_modal_foundation_model_tpu_torch.train import (
    MultiModalTrainer, OptimizerConfig, TrainerConfig)
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

N_AP, T = TOY["n_channels"]["ap"], TOY["max_F"]
MASK = dict(channels=(1, 5, 20, 30), timesteps=(12, 15, 19))
MENU = ("co-smooth", "forward-pred")
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5


def _splits(pkg):
    return pkg.synthetic_splits(seed=0, n_trials=64, n_neurons=N_AP,
                                n_timesteps=T)


def _loaders(loader_mod, session_mod, batch_size=8):
    sp = _splits(session_mod)
    kw = dict(batch_size=batch_size, max_time_length=T,
              max_space_length=N_AP)
    return (loader_mod.make_loader(sp.train, **kw),
            loader_mod.make_loader(sp.val, shuffle=False, **kw))


def _tcfg(cls, tmp, **over):
    kw = dict(num_epochs=2, log_dir=str(tmp), seed=0, mask_type="input",
              mask_mode=MENU, mixed_training=True, eval_every=10 ** 9)
    kw.update(over)
    return cls(**kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's 2 epochs: initial params, per-step losses, final
    params."""
    cfg = jmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=JMP(**MASK))
    train, val = _loaders(jloader, jsession)
    tr = jtrainer.MultiModalTrainer(
        jmm.MultiModal(cfg), train, val, JOC(lr=1e-3),
        _tcfg(jtrainer.TrainerConfig, tmp_path_factory.mktemp("j")))
    init = jax.tree_util.tree_map(np.asarray, tr.state.params)
    losses = []
    get_step = tr._get_train_step

    def recording(training_mode, use_mtm):
        step = get_step(training_mode, use_mtm)

        def run(*args):
            state, loss = step(*args)
            losses.append(float(loss))
            return state, loss
        return run

    tr._get_train_step = recording
    modes = []
    sample = tr._sample_modes

    def record_modes():
        modes.append(sample())
        return modes[-1]

    tr._sample_modes = record_modes
    for epoch in range(2):
        tr.train_epoch(epoch)
    final = jax.tree_util.tree_map(np.asarray, tr.state.params)
    return init, losses, modes, final


def _port_trainer(tmp, init_params, remat=True, **model_over):
    kw = dict(TOY, dropout=0.0, embed_dropout=0.0, mask_params=TMP(**MASK),
              remat_layers=remat)
    cfg = tmm.MultiModalConfig(**{**kw, **model_over})
    model = tmm.MultiModal(cfg, device="cpu")
    if init_params is not None:
        model.load_state_dict(params_from_jax(init_params, cfg))
    train, val = _loaders(tloader, tsession)
    return MultiModalTrainer(model, train, val, OptimizerConfig(lr=1e-3),
                             _tcfg(TrainerConfig, tmp))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_trainer_lockstep_with_jax(jax_run, remat, tmp_path):
    init, jlosses, jmodes, jfinal = jax_run
    tr = _port_trainer(tmp_path, init, remat=remat)
    modes = []
    sample = tr._sample_modes
    tr._sample_modes = lambda: modes.append(sample()) or modes[-1]
    losses = []
    for epoch in range(2):
        losses += tr.train_epoch(epoch)["step_losses"]
    assert modes == jmodes                     # the same host draws
    assert len({m for m, _ in modes}) == 3     # every objective ran
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    want = params_from_jax(jfinal, tr.model.config)
    for name, p in tr.model.state_dict().items():
        if name.endswith("key.bias"):
            continue        # exact gradient 0: Adam steps on f32 noise
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_remat_replays_dropout_exactly(tmp_path):
    """Dropout 0.4 (in-kernel attention dropout's plain version and the u8
    layer dropout), MtM random schemes: the same step's gradients with and
    without remat are equal."""
    grads = []
    for remat in (True, False):
        tr = _port_trainer(tmp_path / str(remat), None, remat=remat,
                           dropout=0.4, embed_dropout=0.2)
        tr.masking_schemes = ["random", "intra-region"]
        tr.mtm_modes = tuple(tr.masking_schemes)
        batch = tr._device_batch(next(iter(tr.train_dataloader)))
        for scheme in (0, 1):
            out = tr.step_loss(batch, "token_masking", scheme, step=3)
            out.loss.backward()
        grads.append({n: p.grad.clone()
                      for n, p in tr.model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], atol=0, rtol=0,
                                   msg=n)
    assert any(g.abs().max() > 0 for g in grads[0].values())


def _train_dropout(tmp):
    tr = _port_trainer(tmp, None, dropout=0.4, embed_dropout=0.2)
    tr.masking_schemes = ["temporal", "neuron", "inter-region"]
    tr.mtm_modes = tuple(tr.masking_schemes)
    return tr


def test_resume_is_exact(tmp_path):
    a = _train_dropout(tmp_path / "a")
    la = a.train_epoch(0)["step_losses"] + a.train_epoch(1)["step_losses"]

    b = _train_dropout(tmp_path / "b")
    lb = b.train_epoch(0)["step_losses"]
    b.save_model("last", epoch=0)
    c = _train_dropout(tmp_path / "b")
    assert c.restore("last") == 0 and c.step == b.step
    lb += c.train_epoch(1)["step_losses"]
    assert lb == la
    for (n, pa), pc in zip(a.model.state_dict().items(),
                           c.model.state_dict().values()):
        torch.testing.assert_close(pa, pc, atol=0, rtol=0, msg=n)
    # the checkpoint carries the model config for the eval reload
    model, loader = tload.load_model_data_local(
        model_dir=str(tmp_path / "b"), test_session=_splits(tsession).test,
        checkpoint_name="last", max_time_length=T, max_space_length=N_AP,
        device="cpu")
    assert model.config.force_active is False
    assert model.config.mask_params.ratio == 0.0
    for (n, pb), pm in zip(b.model.state_dict().items(),
                           model.state_dict().values()):
        torch.testing.assert_close(pb, pm, atol=0, rtol=0, msg=n)
    assert loader.shuffle is False and len(loader) == 1


def test_train_runs_eval_and_keeps_best(tmp_path):
    tr = _port_trainer(tmp_path, None, dropout=0.4, embed_dropout=0.2)
    tr.tcfg = dataclasses.replace(tr.tcfg, eval_every=1)
    res = tr.train()
    assert [r["epoch"] for r in res["history"]] == [0, 1]
    assert np.isfinite(res["best_eval_trial_avg_r2"])
    assert (tmp_path / "model_best.pt").exists()
    assert (tmp_path / "model_last.pt").exists()
    assert (tmp_path / "model_config.json").exists()
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 3


def test_unported_trainer_options_raise(tmp_path, monkeypatch):
    train, val = _loaders(tloader, tsession)
    model = tmm.MultiModal(tmm.MultiModalConfig(**TOY), device="cpu")
    with pytest.raises(NotImplementedError):
        MultiModalTrainer(model, train, val, OptimizerConfig(),
                          _tcfg(TrainerConfig, tmp_path, compile_retries=1))
    # epoch plots, ported since, build (tests/test_torch_plotting.py draws
    # them); a single-session trainer ignores the multi-session options,
    # as JAX's does
    for over in (dict(save_plot_every_n_epochs=5),
                 dict(mixed_session_batches=True),
                 dict(shard_resident_sessions=True)):
        MultiModalTrainer(model, train, val, OptimizerConfig(),
                          _tcfg(TrainerConfig, tmp_path, **over))
    # the resident path runs under a mesh, every step eager
    # (tests/test_torch_parallel_resident.py): a rank's StepGraphs never
    # captures; a capture in a world of more than one rank is refused
    from multi_modal_foundation_model_tpu_torch.train import cuda_graph

    monkeypatch.setattr(cuda_graph.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(cuda_graph.dist, "get_world_size",
                        lambda group=None: 2)
    ran = []
    eager = cuda_graph.StepGraphs("cpu", capture=False)
    eager._cuda = False
    eager.run(("k",), lambda: ran.append(1))
    eager.run(("k",), lambda: ran.append(1))
    assert ran == [1, 1] and not eager.graphs
    capturing = cuda_graph.StepGraphs("cpu")
    capturing._cuda = True          # as on the card
    with pytest.raises(NotImplementedError, match="3b"):
        capturing.run(("k",), lambda: ran.append(1))
    assert ran == [1, 1]


def test_eval_reload_needs_an_explicit_cpu(tmp_path):
    """Like every entry point, ``load_model_data_local`` defaults to the
    card and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tr = _port_trainer(tmp_path, None)
    tr.save_model("last")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tload.load_model_data_local(model_dir=str(tmp_path),
                                    test_session=_splits(tsession).test,
                                    checkpoint_name="last",
                                    max_time_length=T, max_space_length=N_AP)
