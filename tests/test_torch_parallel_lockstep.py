"""The port's data- and tensor-parallel trainers against the JAX package's
trainers under a mesh, and against the port's own single process.

The port's ranks are processes over gloo (``tests/torch_parallel_workers.py``,
no JAX in them); JAX runs on the 8 virtual CPU devices of ``conftest.py``
with its Pallas attention in interpret mode (``_flash_mha_tp`` under a
``model`` axis). The TOY geometry of ``tests/torch_parity.py`` with 4 heads,
the JAX initial weights on both sides (``params_from_jax``), dropout 0 and
the deterministic ``co-smooth`` menu:

- **dp = 2, tp = 2 and dp 2 x tp 2 against JAX ``build_mesh(dp, tp)``**:
  the step-0 loss within 1e-5 max(1, |loss|) and every gradient within rtol
  2e-3 / atol 1e-5 (the gates of JAX's
  ``test_tp_pallas_matches_single_device``), then three steps in lockstep
  at the trainer lockstep's gates (losses rtol 2e-5, parameters atol
  2e-5; the attention key biases, whose exact gradient is 0, left out as
  there). Every replicated gradient is bit-equal across the model group,
  and the parameters after the steps across the data group.
- **dp 2 x tp 2 at dropout 0.4** (embedding dropout 0.2, mixed objectives,
  the random MtM menu ``temporal``/``neuron``/``random``/``intra-region``)
  against the port's single process: the same gates, and the eval loss
  and R² after the steps within 1e-5 (predictions gathered over the data
  group). The draw offsets make every rank draw its slice of the
  single-process draw. The data
  ranks' masked counts differ there, and the mean of their own means
  misses the loss by more than the gate: the global denominator is what
  makes the step the single-device step.
- **BaselineTrainer dp = 2** against JAX's under ``build_mesh(2)``: three
  steps' losses and parameters at the lockstep gates, the eval R² within
  1e-5.
- **Checkpoint**: the dp 2 x tp 2 run's ``last`` checkpoint holds the
  single-device layout: a one-process trainer's ``restore`` gives the
  gathered parameters bit for bit and its step, and ``eval/loading.py``
  loads it.
"""


import copy

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from torch_parity import TOY
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import baseline as jbaseline
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
from multi_modal_foundation_model_tpu.parallel import build_mesh as jbuild
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.eval import loading as tload
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    baseline_params_from_jax, params_from_jax)

N_AP, T = TOY["n_channels"]["ap"], TOY["max_F"]
MASK = dict(channels=(1, 5, 20, 30), timesteps=(12, 15, 19))
STEPS, N_TRIALS, B = 3, 64, 8
LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-3, 1e-5
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
SPEC = dict(geometry=TOY, dropout=0.0, embed_dropout=0.0, mask=MASK,
            menu=["co-smooth"], mixed=False, n_trials=N_TRIALS,
            batch_size=B, steps=STEPS, remat=False)
LAYOUTS = [(2, 1), (1, 2), (2, 2)]


def _jax_loaders():
    sp = jsession.synthetic_splits(seed=0, n_trials=N_TRIALS,
                                   n_neurons=N_AP, n_timesteps=T)
    kw = dict(batch_size=B, max_time_length=T, max_space_length=N_AP)
    return (jloader.make_loader(sp.train, **kw),
            jloader.make_loader(sp.val, shuffle=False, **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jax_trainer(mesh, tmp):
    """JAX's trainer of the deterministic menu (one device for ``None``)."""
    cfg = jmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=JMP(**MASK), remat_layers=False)
    train, val = _jax_loaders()
    return jtrainer.MultiModalTrainer(
        jmm.MultiModal(cfg), train, val, JOC(lr=1e-3),
        jtrainer.TrainerConfig(num_epochs=2, log_dir=str(tmp), seed=0,
                               mask_type="input", mask_mode=("co-smooth",),
                               eval_every=10 ** 9), mesh=mesh)


def _under_mesh(tr, mesh):
    """A copy of the one-device trainer ``tr`` put under ``mesh`` as JAX's
    ``__init__`` does it (``mesh``, ``_tp_mesh``, the state through
    ``shard_tree``; its init is mesh-independent), which saves compiling
    its init once per mesh."""
    from multi_modal_foundation_model_tpu.parallel import (model_axis_size,
                                                           shard_tree)
    tr = copy.copy(tr)
    tr.mesh = mesh
    tr._tp_mesh = mesh if model_axis_size(mesh) > 1 else None
    tr._train_steps, tr._eval_steps = {}, {}
    tr.state = shard_tree(tr.state, mesh)
    return tr


def _jax_run(tr):
    """JAX's trainer ``tr``: the step-0 loss and gradients, then three
    steps (its ``_grad_scan_step``: the loss keyed by ``fold_in(base_key,
    step)``, ``apply_gradients``), their losses and the params after them.
    One compiled gradient serves every step."""
    tr.train_dataloader.set_epoch(0)
    batches = [tr._device_batch(b)
               for b, _ in zip(tr.train_dataloader, range(STEPS))]

    def loss_fn(params, batch, key):
        k_mask, k_drop = jax.random.split(key)
        out = tr.model.apply(
            {"params": params}, tr._build_mod_inputs(batch, None),
            masking_mode=0, mtm_modes=("co-smooth",), regions=tr.regions,
            training=True, rngs={"mask": k_mask, "dropout": k_drop})
        return out.loss

    grad_fn = tr._tp_wrap(jax.jit(jax.value_and_grad(loss_fn)))
    # one compiled update (eager, each optax op of each leaf compiles)
    apply = jax.jit(lambda state, grads: state.apply_gradients(grads=grads))
    losses, grads0 = [], None
    for step, batch in enumerate(batches):
        loss, grads = grad_fn(tr.state.params, batch,
                              jax.random.fold_in(tr.base_key, step))
        grads0 = grads if grads0 is None else grads0
        losses.append(float(loss))
        tr.state = apply(tr.state, grads)
    return dict(loss0=losses[0], grads=_np(grads0), losses=losses,
                final=_np(tr.state.params))


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """JAX's one-device trainer and its initial params (the same under
    every mesh) as the port's ``state_dict`` file."""
    tmp = tmp_path_factory.mktemp("init")
    tr = _jax_trainer(None, tmp)
    path = tmp / "init.pt"
    torch.save(params_from_jax(_np(tr.state.params),
                               tmm.MultiModalConfig(**TOY)), path)
    return tr, path


_RANKS, _RUNS = {}, {}


def _layout(dp, tp, jax_init, tmp_path_factory):
    """JAX under ``build_mesh(dp, tp)`` and the port's dp x tp ranks on the
    same init, once per layout. The first call starts every layout's ranks
    (8 processes), which run while JAX compiles."""
    tr, init = jax_init
    if not _RANKS:
        for d, t in LAYOUTS:
            tmp = tmp_path_factory.mktemp(f"dp{d}tp{t}")
            spec = dict(SPEC, dp=d, tp=t, init=str(init),
                        log_dir=str(tmp / "port"), save=(d, t) == (2, 2))
            _RANKS[d, t] = (workers.Ranks(spec, d * t, tmp / "ranks"), spec)
    if (dp, tp) not in _RUNS:
        want = _jax_run(_under_mesh(tr, jbuild(dp=dp, tp=tp)))
        ranks, spec = _RANKS[dp, tp]
        _RUNS[dp, tp] = (want, ranks.result(), spec)
    return _RUNS[dp, tp]


@pytest.fixture(params=LAYOUTS, ids=[f"dp{d}_tp{t}" for d, t in LAYOUTS])
def runs(request, jax_init, tmp_path_factory):
    return _layout(*request.param, jax_init, tmp_path_factory)


def test_step0_loss_and_gradients_match_jax_mesh(runs):
    want, got, _ = runs
    assert abs(got["loss0"] - want["loss0"]) < LOSS_TOL * max(
        1.0, abs(want["loss0"]))
    cfg = tmm.MultiModalConfig(**TOY)
    jgrads = params_from_jax(want["grads"], cfg)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    assert got["replicated_equal"]


def test_three_steps_in_lockstep_with_jax_mesh(runs):
    want, got, _ = runs
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    final = params_from_jax(want["final"], tmm.MultiModalConfig(**TOY))
    for name, p in got["params"].items():
        if name.endswith("key.bias"):
            continue        # exact gradient 0: Adam steps on f32 noise
        np.testing.assert_allclose(p.numpy(), final[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert got["data_equal"]


def test_checkpoint_restores_at_tp1(jax_init, tmp_path_factory):
    """The dp 2 x tp 2 run's checkpoint in a one-process trainer and in
    ``eval/loading.py``: the gathered parameters, bit for bit."""
    _, got, spec = _layout(2, 2, jax_init, tmp_path_factory)
    single = workers.trainer(spec, None)
    assert single.restore("last") == 0 and single.step == STEPS
    for name, p in single.model.state_dict().items():
        torch.testing.assert_close(p, got["params"][name], rtol=0, atol=0,
                                   msg=name)
    assert single.optimizer.count == STEPS
    sp = tload.load_model_data_local(
        model_dir=spec["log_dir"], checkpoint_name="last",
        test_session=jsession.synthetic_splits(
            seed=0, n_trials=N_TRIALS, n_neurons=N_AP, n_timesteps=T).test,
        max_time_length=T, max_space_length=N_AP, device="cpu")
    for name, p in sp[0].state_dict().items():
        torch.testing.assert_close(p, got["params"][name], rtol=0, atol=0,
                                   msg=name)


def test_dropout_step_matches_the_single_process(tmp_path):
    """dp 2 x tp 2 at dropout 0.4, mixed objectives, random masks: the
    port's single-process step, at the same gates."""
    init = tmm.MultiModal(tmm.MultiModalConfig(**TOY), device="cpu")
    torch.save(init.state_dict(), tmp_path / "init.pt")
    spec = dict(SPEC, dropout=0.4, embed_dropout=0.2, mixed=True,
                menu=["temporal", "neuron", "random", "intra-region"],
                init=str(tmp_path / "init.pt"), max_grad_norm=1.0)
    ranks = workers.Ranks(dict(spec, dp=2, tp=2,
                               log_dir=str(tmp_path / "four")), 4,
                          tmp_path / "ranks")
    want = workers.run(dict(spec, log_dir=str(tmp_path / "one")), None)
    got = ranks.result()
    assert got["modes"] == want["modes"]
    assert len({m for m, _ in got["modes"]}) == STEPS   # every objective
    assert abs(got["loss0"] - want["loss0"]) < LOSS_TOL * max(
        1.0, abs(want["loss0"]))
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want["grads"][name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    for name, p in got["params"].items():
        if name.endswith("key.bias"):
            continue
        np.testing.assert_allclose(p.numpy(), want["params"][name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert got["replicated_equal"] and got["data_equal"]
    # eval scores the global batch: the single process's loss and R²
    assert abs(got["eval_loss"] - want["eval_loss"]) <= 1e-5 * abs(
        want["eval_loss"])
    assert abs(got["eval_r2"] - want["eval_r2"]) <= 1e-5
    # the ranks' counts differ; averaging their own means is another loss
    assert got["counts"][0] != got["counts"][1]
    assert abs(got["mean_of_means"] - want["loss0"]) > LOSS_TOL * max(
        1.0, abs(want["loss0"]))


def test_baseline_dp2_matches_jax(tmp_path):
    train, val = _jax_loaders()
    jm = jbaseline.BaselineDecoder(in_channel=N_AP, out_channel=2)
    filt = {"input": ["ap"], "output": ["behavior"]}
    tr = jtrainer.BaselineTrainer(
        jm, train, val, JOC(lr=1e-3),
        jtrainer.TrainerConfig(num_epochs=2, log_dir=str(tmp_path / "j"),
                               seed=0),
        modal_filter=filt, mesh=jbuild(dp=2, tp=1))
    torch.save(baseline_params_from_jax(_np(tr.state.params)),
               tmp_path / "init.pt")
    ranks = workers.Ranks(
        dict(SPEC, baseline=True, dp=2, tp=1, init=str(tmp_path / "init.pt"),
             log_dir=str(tmp_path / "port")), 2, tmp_path / "ranks")
    step = tr._get_step()
    train.set_epoch(0)
    losses = []
    for b, _ in zip(train, range(STEPS)):
        tr.state, loss = step(tr.state, tr._data_dict(b))
        losses.append(float(loss))
    want_r2 = tr.eval_epoch()["eval_trial_avg_r2"]
    got = ranks.result()
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL, atol=0)
    final = baseline_params_from_jax(_np(tr.state.params))
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert abs(got["eval"] - float(want_r2)) < 1e-5
