"""The port's linear baselines and ``BaselineTrainer`` against the JAX
package's.

- **Forward**: ``BaselineEncoder`` (behavior -> spikes, flattened trial)
  and ``BaselineDecoder`` (spikes -> behavior, per bin) with the JAX
  model's initial weights carried by ``baseline_params_from_jax``:
  predictions within atol 1e-5, the loss within rtol 1e-6.
- **Lockstep**: a JAX ``BaselineTrainer`` and the port's run 2 epochs side
  by side in each direction from the same synthetic splits, the same
  initial weights and the same loader order, lr 1e-3, 14 AdamW updates
  (not fewer: with ``warmup_pct * total_steps < 2`` JAX clamps OneCycle's
  warm-up to one step where torch does not, ``train/schedule.py``). Per-step
  losses agree within rtol 2e-5, the final parameters within atol 2e-5
  (f32 sums in other orders), ``eval_epoch``'s ``eval_loss`` within rtol
  1e-5 and ``eval_trial_avg_r2`` within atol 1e-5.
- **Resume** is exact: 2 epochs straight equal 1 epoch, ``save_model``,
  ``restore("last")`` in a fresh trainer, 1 epoch, bit for bit; ``train``
  writes ``best`` and ``last`` with their meta files.
- Unported options raise, and ``device=None`` without a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import baseline as jbaseline
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.models import baseline as tbaseline
from multi_modal_foundation_model_tpu_torch.parallel import make_mesh
from multi_modal_foundation_model_tpu_torch.train import (
    BaselineTrainer, OptimizerConfig, TrainerConfig, load_checkpoint_meta)
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    baseline_params_from_jax)

N, T, N_BEH = 24, 20, 2
PRED_ATOL, LOSS_RTOL_FWD = 1e-5, 1e-6
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
EVAL_LOSS_RTOL, EVAL_R2_ATOL = 1e-5, 1e-5
FILTERS = {"encoding": {"input": ["behavior"], "output": ["ap"]},
           "decoding": {"input": ["ap"], "output": ["behavior"]}}


def _splits(pkg):
    return pkg.synthetic_splits(seed=0, n_trials=64, n_neurons=N,
                                n_timesteps=T)


def _loaders(loader_mod, session_mod, batch_size=8):
    sp = _splits(session_mod)
    kw = dict(batch_size=batch_size, max_time_length=T, max_space_length=N)
    return (loader_mod.make_loader(sp.train, **kw),
            loader_mod.make_loader(sp.val, shuffle=False, **kw))


def _jax_model(direction):
    if direction == "encoding":
        return jbaseline.BaselineEncoder(in_channel=N_BEH, out_channel=N,
                                         seq_len=T)
    return jbaseline.BaselineDecoder(in_channel=N, out_channel=N_BEH)


def _port_model(direction, params=None):
    if direction == "encoding":
        model = tbaseline.BaselineEncoder(N_BEH, N, seq_len=T, device="cpu")
    else:
        model = tbaseline.BaselineDecoder(N, N_BEH, device="cpu")
    if params is not None:
        model.load_state_dict(baseline_params_from_jax(params), strict=True)
    return model


def _data(direction, batch):
    src = {"ap": "spikes_data", "behavior": "target"}
    f = FILTERS[direction]
    return {"inputs": np.asarray(batch[src[f["input"][0]]]),
            "targets": np.asarray(batch[src[f["output"][0]]])}


@pytest.mark.parametrize("direction", ["encoding", "decoding"])
def test_forward_matches_jax(direction):
    train, _ = _loaders(jloader, jsession)
    data = _data(direction, next(iter(train)))
    jm = _jax_model(direction)
    params = jm.init(jax.random.PRNGKey(0), data)["params"]
    want = jm.apply({"params": params}, data)
    tm = _port_model(direction, params)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in data.items()})
    assert got.preds.shape == want.preds.shape
    np.testing.assert_allclose(got.preds.numpy(), np.asarray(want.preds),
                               atol=PRED_ATOL, rtol=0)
    np.testing.assert_allclose(float(got.loss), float(want.loss),
                               rtol=LOSS_RTOL_FWD, atol=0)
    assert got.loss.dtype == torch.float32
    # the state_dict names are the reference's
    assert set(tm.state_dict()) == {"layer.weight", "layer.bias"}


def _tcfg(cls, tmp, **over):
    kw = dict(num_epochs=2, log_dir=str(tmp), seed=0)
    kw.update(over)
    return cls(**kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per direction, the JAX trainer's 2 epochs: initial params, per-step
    losses, final params, its eval."""
    runs = {}
    for direction in FILTERS:
        train, val = _loaders(jloader, jsession)
        tr = jtrainer.BaselineTrainer(
            _jax_model(direction), train, val, JOC(lr=1e-3),
            _tcfg(jtrainer.TrainerConfig,
                  tmp_path_factory.mktemp(f"j_{direction}")),
            modal_filter=FILTERS[direction])
        init = jax.tree_util.tree_map(np.asarray, tr.state.params)
        losses = []
        step = tr._get_step()

        def recording(state, data, step=step):
            state, loss = step(state, data)
            losses.append(float(loss))
            return state, loss

        tr._step = recording
        for epoch in range(2):
            tr.train_epoch(epoch)
        final = jax.tree_util.tree_map(np.asarray, tr.state.params)
        ev = tr.eval_epoch()
        runs[direction] = (init, losses, final, ev)
    return runs


def _port_trainer(direction, tmp, params=None, **tcfg_over):
    train, val = _loaders(tloader, tsession)
    return BaselineTrainer(
        _port_model(direction, params), train, val,
        OptimizerConfig(lr=1e-3), _tcfg(TrainerConfig, tmp, **tcfg_over),
        modal_filter=FILTERS[direction])


@pytest.mark.parametrize("direction", ["encoding", "decoding"])
def test_trainer_lockstep_with_jax(jax_runs, direction, tmp_path):
    init, jlosses, jfinal, jev = jax_runs[direction]
    tr = _port_trainer(direction, tmp_path, init)
    losses = []
    for epoch in range(2):
        losses += tr.train_epoch(epoch)["step_losses"]
    assert len(losses) == len(jlosses) == 14 == tr.optimizer.count
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    want = baseline_params_from_jax(jfinal)
    for name, p in tr.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    ev = tr.eval_epoch()
    np.testing.assert_allclose(ev["eval_loss"], jev["eval_loss"],
                               rtol=EVAL_LOSS_RTOL, atol=0)
    np.testing.assert_allclose(ev["eval_trial_avg_r2"],
                               jev["eval_trial_avg_r2"],
                               atol=EVAL_R2_ATOL, rtol=0)
    assert ev["eval_gt"].shape == jev["eval_gt"].shape
    np.testing.assert_array_equal(ev["eval_gt"], jev["eval_gt"])


@pytest.mark.parametrize("direction", ["encoding", "decoding"])
def test_resume_is_exact(direction, tmp_path):
    a = _port_trainer(direction, tmp_path / "a")
    la = a.train_epoch(0)["step_losses"] + a.train_epoch(1)["step_losses"]

    b = _port_trainer(direction, tmp_path / "b")
    lb = b.train_epoch(0)["step_losses"]
    b.save_model("last", epoch=0)
    c = _port_trainer(direction, tmp_path / "b")
    assert c.restore("last") == 0 and c.step == b.step
    lb += c.train_epoch(1)["step_losses"]
    assert lb == la
    for (n, pa), pc in zip(a.model.state_dict().items(),
                           c.model.state_dict().values()):
        torch.testing.assert_close(pa, pc, atol=0, rtol=0, msg=n)


def test_train_writes_best_and_last_and_resumes_the_watermark(tmp_path):
    tr = _port_trainer("decoding", tmp_path)
    summary = tr.train()
    for name in ("best", "last"):
        assert (tmp_path / f"model_{name}.pt").exists()
        assert (tmp_path / f"model_{name}.json").exists()
    best = load_checkpoint_meta(str(tmp_path), "best")
    assert best["epoch"] == summary["best_epoch"]
    assert best["metric"] == pytest.approx(summary["best_eval_trial_avg_r2"])
    assert load_checkpoint_meta(str(tmp_path), "last")["epoch"] == 1
    assert [r["epoch"] for r in summary["history"]] == [0, 1]
    # a resumed run starts from the best watermark on disk
    again = _port_trainer("decoding", tmp_path)
    assert again.restore("last") == 1
    resumed = again.train(start_epoch=2)
    assert resumed["best_epoch"] == summary["best_epoch"]
    assert resumed["history"] == []


@pytest.mark.parametrize("what", ["plots", "mesh"])
def test_unported_options_raise(what, tmp_path):
    """Epoch plots and a mesh, both ported since. ``train()`` with
    ``save_plot_every_n_epochs=1`` draws JAX's files: the output
    modality's ``gt_pred`` figure every epoch, and a ``best_`` one on each
    new best. A one-rank mesh (data parallelism,
    ``tests/test_torch_parallel_lockstep.py``) trains as no mesh does, bit
    for bit."""
    train, val = _loaders(tloader, tsession)
    if what == "plots":
        tr = BaselineTrainer(_port_model("decoding"), train, val,
                             OptimizerConfig(),
                             _tcfg(TrainerConfig, tmp_path,
                                   save_plot_every_n_epochs=1),
                             modal_filter=FILTERS["decoding"])
        summary = tr.train()
        epochs = [r["epoch"] for r in summary["history"]]
        names = {p.name for p in tmp_path.glob("*.png")}
        assert {f"gt_pred_fig_behavior_{e}.png" for e in epochs} <= names
        assert f"best_gt_pred_fig_behavior_{summary['best_epoch']}.png" \
            in names
        assert all("gt_pred_fig_behavior_" in n for n in names)
        return
    runs = []
    for mesh in (None, make_mesh(1, 1)):
        tr = BaselineTrainer(_port_model("decoding"), train, val,
                             OptimizerConfig(), _tcfg(TrainerConfig,
                                                      tmp_path),
                             modal_filter=FILTERS["decoding"], mesh=mesh)
        runs.append(tr.train_epoch(0)["step_losses"])
    assert runs[0] == runs[1]


def test_device_none_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbaseline.BaselineEncoder(N_BEH, N, seq_len=T)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbaseline.BaselineDecoder(N, N_BEH)


def test_init_is_torch_default_from_the_generator():
    a = tbaseline.BaselineEncoder(N_BEH, N, seq_len=T, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    b = tbaseline.BaselineEncoder(N_BEH, N, seq_len=T, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    bound = 1.0 / np.sqrt(T * N_BEH)
    for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=n)
        assert float(pa.abs().max()) <= bound
        assert float(pa.abs().max()) > 0.9 * bound
    assert a.layer.weight.shape == (T * N, T * N_BEH)
    # JAX draws the same distribution: U(+-1/sqrt(fan_in))
    jp = _jax_model("encoding").init(
        jax.random.PRNGKey(0), {"inputs": jnp.zeros((1, T, N_BEH)),
                                "targets": jnp.zeros((1, T, N))})["params"]
    assert float(jnp.abs(jp["layer"]["kernel"]).max()) <= bound


@pytest.mark.parametrize("which", ["baseline", "multimodal"])
def test_factories_are_the_constructors_as_in_jax(which, tmp_path):
    """``make_baseline_trainer`` / ``make_multimodal_trainer`` take JAX's
    arguments and build the trainer the constructor builds: the same
    class, the same first epoch bit for bit."""
    import inspect

    from multi_modal_foundation_model_tpu_torch.train import (
        MultiModalTrainer, make_baseline_trainer, make_multimodal_trainer)
    make, jmake, cls = {
        "baseline": (make_baseline_trainer, jtrainer.make_baseline_trainer,
                     BaselineTrainer),
        "multimodal": (make_multimodal_trainer,
                       jtrainer.make_multimodal_trainer, MultiModalTrainer),
    }[which]
    assert (list(inspect.signature(make).parameters)
            == list(inspect.signature(jmake).parameters))

    def build(factory, tmp, state=None):
        train, val = _loaders(tloader, tsession)
        if which == "baseline":
            model, extra = _port_model("decoding"), dict(
                modal_filter=FILTERS["decoding"])
        else:
            from torch_parity import TOY
            from multi_modal_foundation_model_tpu_torch.models import (
                multimodal as tmm)
            model, extra = tmm.MultiModal(tmm.MultiModalConfig(**TOY),
                                          device="cpu"), {}
        if state is not None:
            model.load_state_dict(state)
        return factory(model, train, val, OptimizerConfig(lr=1e-3),
                       _tcfg(TrainerConfig, tmp), **extra)

    made = build(make, tmp_path / "a")
    direct = build(cls, tmp_path / "b", made.model.state_dict())
    assert type(made) is cls
    assert made.train_epoch(0)["step_losses"] == \
        direct.train_epoch(0)["step_losses"]
