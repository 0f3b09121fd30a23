"""The trainer's host-dispatch options in the port: the resident split,
K steps per dispatch, the seed table and the pieces under them.

- **Resident = host path.** ``device_resident_data`` gathers each batch on
  the device by index; with dropout 0.4 / 0.2, MtM schemes and mixed
  training it gives the host-batch path's per-step losses, parameters and
  eval results exactly (56 trials at B=16: a padded tail batch of 8).
- **K = 4 = K = 1** without mixed training (the same draws, steps and
  seed tables), exactly; the steps left over after the last whole group
  run as single steps (96 trials at B=20, K=2: 5 steps).
- **Draw order**: the port's group draws are JAX's
  ``_sample_group_modes`` sequence from the same generator.
- **Lockstep with JAX** under ``device_resident_data=True,
  steps_per_dispatch=4``: the JAX trainer's scan path and the port's,
  per-step losses within rtol 2e-5 and parameters within atol 2e-5 (the
  ``tests/test_torch_trainer.py`` gate and reasons), dropout 0.
- **Seed table**: ``MultiModal.seed_paths`` and ``utils.rng.seed_table``
  reproduce the model's ``fold_in`` tree entry by entry.
- **Philox plain version** (``ops/random.py``): Random123's known-answer
  vectors, and its byte and uniform layouts against a numpy Philox.
- **Width-1 dilation** is the identity; a device-side width gives the
  host width's result.
- **Optimizer**: the device-buffer update (``train/schedule.py``) against
  ``torch.optim.AdamW`` + ``OneCycleLR`` over 20 steps, then
  ``load_state_dict`` into a fresh optimizer and 5 more, parameters within
  atol 1e-6 (f32 AdamW in another order, scalars rounded to f32 first);
  ``load_state_dict`` copies into the tensors it holds.
- **Resume** on the resident path (K = 2) is exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_dropout import np_philox
from test_torch_trainer import (LOSS_RTOL, MASK, MENU, PARAM_ATOL, T, N_AP,
                                _loaders, _tcfg)
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
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.models.layers import (
    DecoderLayer, EncoderLayer)
from multi_modal_foundation_model_tpu_torch.ops import masking as tm
from multi_modal_foundation_model_tpu_torch.ops import random as trand
from multi_modal_foundation_model_tpu_torch.ops.masking import (
    MaskParams as TMP)
from multi_modal_foundation_model_tpu_torch.train import (
    MultiModalTrainer, OptimizerConfig, TrainerConfig)
from multi_modal_foundation_model_tpu_torch.train import schedule as tsch
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)
from multi_modal_foundation_model_tpu_torch.utils.rng import (fold_in,
                                                              seed_table)

RANDOM_MENU = ("temporal", "neuron", "inter-region", "random")


def _trainer(tmp, n_trials=56, batch_size=16, eval_loader=True,
             model_over=None, **tcfg_over):
    """A CPU trainer over a synthetic split of ``n_trials``, dropout 0.4 /
    0.2, the random MtM menu with mixed training (unless overridden)."""
    kw = dict(TOY, dropout=0.4, embed_dropout=0.2,
              mask_params=TMP(expand_prob=0.5, max_timespan=3))
    kw.update(model_over or {})
    model = tmm.MultiModal(tmm.MultiModalConfig(**kw), device="cpu")
    sess = tsession.synthetic_session(seed=0, n_trials=n_trials,
                                      n_neurons=N_AP, n_timesteps=T)
    lk = dict(batch_size=batch_size, max_time_length=T, max_space_length=N_AP)
    cfg = dict(num_epochs=2, log_dir=str(tmp), seed=0, mask_type="input",
               mask_mode=RANDOM_MENU, mixed_training=True, eval_every=1)
    cfg.update(tcfg_over)
    return MultiModalTrainer(
        model, tloader.make_loader(sess, **lk),
        tloader.make_loader(sess, shuffle=False, **lk) if eval_loader
        else None, OptimizerConfig(lr=1e-3), TrainerConfig(**cfg))


def _two_epochs(tr):
    return (tr.train_epoch(0)["step_losses"]
            + tr.train_epoch(1)["step_losses"])


def _assert_same_params(a, b):
    for (n, pa), pb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0, msg=n)


def test_resident_path_equals_host_path(tmp_path):
    host = _trainer(tmp_path / "h")
    res = _trainer(tmp_path / "r", device_resident_data=True)
    assert host.train_dataloader.n_trials % 16 == 8      # a padded tail
    lh, lr = _two_epochs(host), _two_epochs(res)
    assert len(lh) == 8 and lh == lr
    _assert_same_params(host, res)
    eh, er = host.eval_epoch(), res.eval_epoch()
    assert eh["eval_loss"] == er["eval_loss"]
    assert eh["eval_trial_avg_r2"] == er["eval_trial_avg_r2"]
    for mod in eh["eval_preds"]:
        np.testing.assert_array_equal(eh["eval_preds"][mod],
                                      er["eval_preds"][mod])
        assert len(er["eval_gt"][mod]) == 56


def test_k4_equals_k1_without_mixed_training(tmp_path):
    one = _trainer(tmp_path / "1", batch_size=8, eval_loader=False,
                   device_resident_data=True, mixed_training=False)
    four = _trainer(tmp_path / "4", batch_size=8, eval_loader=False,
                    device_resident_data=True, mixed_training=False,
                    steps_per_dispatch=4)
    groups = []
    dispatch = four._dispatch
    four._dispatch = lambda d, steps, m: (groups.append(len(steps))
                                          or dispatch(d, steps, m))
    assert _two_epochs(one) == _two_epochs(four)
    assert groups == [4, 1, 1, 1] * 2                  # 7 steps an epoch
    _assert_same_params(one, four)


def test_remainder_runs_as_single_steps(tmp_path):
    tr = _trainer(tmp_path, n_trials=96, batch_size=20, eval_loader=False,
                  device_resident_data=True, steps_per_dispatch=2)
    groups = []
    dispatch = tr._dispatch
    tr._dispatch = lambda d, steps, m: (groups.append(len(steps))
                                        or dispatch(d, steps, m))
    res = tr.train_epoch(0)
    assert groups == [2, 2, 1] and tr.step == 5
    assert len(res["step_losses"]) == 5
    assert res["train_loss"] == pytest.approx(sum(res["step_losses"]))


class _Draws:
    """What JAX's ``_sample_group_modes`` and ``_sample_modes`` read."""

    def __init__(self, mixed, schemes):
        self._host_rng = np.random.default_rng((0, 3, 0))
        self.mixed_training = mixed
        self.masking_schemes = schemes


@pytest.mark.parametrize("mixed", [True, False])
def test_group_draw_order_matches_jax(mixed, tmp_path):
    tr = _trainer(tmp_path, eval_loader=False, mixed_training=mixed)
    tr._reseed_host_rng(3)
    ref = _Draws(mixed, list(RANDOM_MENU))
    for n in (4, 4, 1, 3):
        want = jtrainer.MultiModalTrainer._sample_group_modes(ref, n)
        assert tr._sample_group_modes(n) == want
    want = jtrainer.MultiModalTrainer._sample_modes(ref)
    assert tr._sample_modes() == want
    if not mixed:          # the group stream is the K = 1 stream
        tr._reseed_host_rng(3)
        groups = [tr._sample_group_modes(2) for _ in range(3)]
        tr._reseed_host_rng(3)
        singles = [tr._sample_modes()[1] for _ in range(6)]
        assert [s for _, g in groups for s in g] == singles


@pytest.fixture(scope="module")
def jax_resident_run(tmp_path_factory):
    """JAX's trainer with ``device_resident_data=True,
    steps_per_dispatch=4``: 2 epochs of 7 steps (a scan group of 4 and 3
    single steps each); initial params, per-step losses, the host draws,
    final params."""
    cfg = jmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=JMP(**MASK))
    train, val = _loaders(jloader, jsession)
    tr = jtrainer.MultiModalTrainer(
        jmm.MultiModal(cfg), train, val, JOC(lr=1e-3),
        _tcfg(jtrainer.TrainerConfig, tmp_path_factory.mktemp("j"),
              device_resident_data=True, steps_per_dispatch=4))
    init = jax.tree_util.tree_map(np.asarray, tr.state.params)
    losses, draws = [], []
    for name in ("_get_multi_step_dr", "_get_train_step_dr"):
        get = getattr(tr, name)

        def recording(training_mode, use_mtm, get=get):
            step = get(training_mode, use_mtm)

            def run(*args):
                state, loss = step(*args)
                losses.extend(np.atleast_1d(np.asarray(loss)).tolist())
                return state, loss
            return run
        setattr(tr, name, recording)
    for name in ("_sample_group_modes", "_sample_modes"):
        sample = getattr(tr, name)
        setattr(tr, name, lambda *a, sample=sample: draws.append(
            sample(*a)) or draws[-1])
    for epoch in range(2):
        tr.train_epoch(epoch)
    final = jax.tree_util.tree_map(np.asarray, tr.state.params)
    return init, losses, draws, final


def test_resident_k4_lockstep_with_jax(jax_resident_run, tmp_path):
    init, jlosses, jdraws, jfinal = jax_resident_run
    cfg = tmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=TMP(**MASK))
    model = tmm.MultiModal(cfg, device="cpu")
    model.load_state_dict(params_from_jax(init, cfg))
    train, val = _loaders(tloader, tsession)
    tr = MultiModalTrainer(model, train, val, OptimizerConfig(lr=1e-3),
                           _tcfg(TrainerConfig, tmp_path,
                                 device_resident_data=True,
                                 steps_per_dispatch=4))
    draws = []
    for name in ("_sample_group_modes", "_sample_modes"):
        sample = getattr(tr, name)
        setattr(tr, name, lambda *a, sample=sample: draws.append(
            sample(*a)) or draws[-1])
    losses = _two_epochs(tr)
    assert draws == jdraws and len(losses) == 14
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    want = params_from_jax(jfinal, cfg)
    for name, p in tr.model.state_dict().items():
        if name.endswith("key.bias"):
            continue        # exact gradient 0: Adam steps on f32 noise
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_seed_table_reproduces_the_fold_in_tree():
    """Entry by entry, the sites the model's forward keyed before the
    table: masker fold_in(fold_in(fold_in(s, 0), i), 0 / 1), tokenizers
    fold_in(fold_in(s, 1), side, i), layers fold_in(fold_in(s, 1), 2 / 3,
    li) then each module's sites."""
    model = tmm.MultiModal(tmm.MultiModalConfig(**TOY), device="cpu")
    s = 987654321
    table = seed_table(s, model.seed_paths)
    mask, drop = fold_in(s, 0), fold_in(s, 1)
    want = []
    for i in range(2):
        want += [fold_in(fold_in(mask, i), 0), fold_in(fold_in(mask, i), 1)]
    for i in range(2):
        want += [fold_in(drop, 0, i), fold_in(drop, 1, i)]
    for li in range(TOY["n_enc_layers"]):
        layer = fold_in(drop, 2, li)
        attn = fold_in(layer, 0)
        want += [fold_in(attn, 0), fold_in(attn, 1), fold_in(layer, 1)]
    for li in range(TOY["n_dec_layers"]):
        layer = fold_in(drop, 3, li)
        for a in (0, 1):
            attn = fold_in(layer, a)
            want += [fold_in(attn, 0), fold_in(attn, 1)]
        want.append(fold_in(layer, 2))
    assert table.dtype == np.int64 and table.tolist() == want
    assert len(set(want)) == len(want) == (
        8 + 3 * TOY["n_enc_layers"] + 5 * TOY["n_dec_layers"])
    assert len(EncoderLayer.SEED_PATHS) == 3
    assert len(DecoderLayer.SEED_PATHS) == 5


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_plain_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32-10, with the key as host ints
    and as int64 tensors (a table entry); the byte draw under key 0 opens
    with the first vector's words, little-endian."""
    got = trand.philox4x32_10(*(torch.tensor([x]) for x in ctr), *key)
    assert tuple(int(x) for x in got) == want
    got = trand.philox4x32_10(*(torch.tensor([x]) for x in ctr),
                              *(torch.tensor(k) for k in key))
    assert tuple(int(x) for x in got) == want
    if key == (0, 0):
        b = trand.u8_bits_reference(0, (16,)).numpy()
        assert b.tobytes() == np.array(want, "<u4").tobytes()


@pytest.mark.parametrize("n", [1, 5, 16, 33, 1000])
def test_philox_draw_layouts_match_numpy(n):
    """Byte e: byte e % 16 of philox((e // 16, 0, stream, 0), key);
    uniform e: (word e % 4 of philox((e // 4, 0, stream, 1), key) >> 8)
    * 2^-24; the key's two 32-bit halves from the 64-bit seed."""
    seed, stream = 2 ** 40 + 77, 2
    key = (seed & 0xFFFFFFFF, seed >> 32)
    nb = -(-n // 16)
    w = np_philox([np.arange(nb), np.zeros(nb), np.full(nb, stream),
                   np.zeros(nb)], key)
    want = np.stack(w, -1).astype("<u4").view(np.uint8).reshape(-1)[:n]
    got = trand.u8_bits_reference(torch.tensor([seed]), (n,), stream)
    np.testing.assert_array_equal(got.numpy(), want)
    nb = -(-n // 4)
    w = np_philox([np.arange(nb), np.zeros(nb), np.full(nb, stream),
                   np.ones(nb)], key)
    words = np.stack(w, -1).reshape(-1)[:n]
    want = (words >> np.uint64(8)).astype(np.float32) * np.float32(2 ** -24)
    got = trand.uniform_reference(seed, (n,), stream)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 <= got.min() and got.max() < 1


def test_width_one_dilation_is_identity():
    rng = np.random.default_rng(0)
    m = torch.from_numpy((rng.random((6, 40)) > 0.8).astype(np.float32))
    assert torch.equal(tm.expand_timesteps(m, torch.tensor(1.0)), m.bool())
    assert torch.equal(tm.expand_timesteps(m, 1), m.bool())
    for w in (2, 3, 4, 7):
        assert torch.equal(tm.expand_timesteps(m, torch.tensor(float(w))),
                           tm.expand_timesteps(m, w))


def _adamw_pair(cfg, total, init):
    p_ref = torch.nn.Parameter(torch.from_numpy(init.copy()))
    ref = torch.optim.AdamW([p_ref], lr=cfg.lr, betas=(0.9, 0.999),
                            eps=cfg.eps, weight_decay=cfg.wd)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        ref, max_lr=cfg.lr, total_steps=total, pct_start=cfg.warmup_pct,
        anneal_strategy="cos", cycle_momentum=cfg.cycle_momentum,
        base_momentum=cfg.base_momentum, max_momentum=cfg.max_momentum,
        div_factor=cfg.div_factor, final_div_factor=cfg.final_div_factor)
    return p_ref, ref, sched


def test_device_buffer_optimizer_matches_torch_adamw():
    cfg = OptimizerConfig(lr=3e-3, wd=0.05)
    rng = np.random.default_rng(2)
    init = (0.1 * rng.normal(size=(7, 5))).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(25)]
    p_ref, ref, sched = _adamw_pair(cfg, 25, init)
    p = torch.nn.Parameter(torch.from_numpy(init.copy()))
    p.grad = grad_buf = torch.zeros_like(p)
    opt = tsch.Optimizer([p], cfg, 25)

    def both(g):
        assert opt.lr == sched.get_last_lr()[0]
        p_ref.grad = torch.from_numpy(g.copy())
        ref.step()
        sched.step()
        p.grad.copy_(torch.from_numpy(g))
        opt.step()
        assert p.grad is grad_buf and not p.grad.any()   # zeroed in place
        torch.testing.assert_close(p.detach(), p_ref.detach(), atol=1e-6,
                                   rtol=0)

    for g in grads[:20]:
        both(g)
    state = opt.state_dict()
    p2 = torch.nn.Parameter(p.detach().clone())
    p2.grad = torch.zeros_like(p2)
    opt2 = tsch.Optimizer([p2], cfg, 25)
    held = [t.data_ptr() for t in opt2.exp_avg + opt2.exp_avg_sq]
    opt2.load_state_dict(state)
    assert [t.data_ptr() for t in opt2.exp_avg + opt2.exp_avg_sq] == held
    assert opt2.count == 20 and opt2.lr == opt.lr
    p, opt, grad_buf = p2, opt2, p2.grad
    for g in grads[20:]:
        both(g)


def test_resume_on_the_resident_path_is_exact(tmp_path):
    kw = dict(eval_loader=False, device_resident_data=True,
              steps_per_dispatch=2)
    a = _trainer(tmp_path / "a", **kw)
    la = _two_epochs(a)
    b = _trainer(tmp_path / "b", **kw)
    lb = b.train_epoch(0)["step_losses"]
    b.save_model("last", epoch=0)
    c = _trainer(tmp_path / "b", **kw)
    held = [p.data_ptr() for p in c.model.parameters()]
    assert c.restore("last") == 0 and c.step == b.step
    assert [p.data_ptr() for p in c.model.parameters()] == held
    lb += c.train_epoch(1)["step_losses"]
    assert lb == la
    _assert_same_params(a, c)


def test_trainer_config_runs_the_three_options(tmp_path):
    tr = _trainer(tmp_path, eval_loader=False, device_resident_data=True,
                  steps_per_dispatch=3, prefetch_depth=2)
    assert tr.tcfg.unported() == []
    res = tr.train_epoch(0)
    assert np.isfinite(res["train_loss"]) and len(res["step_losses"]) == 4
    bad = dataclasses.replace(tr.tcfg, mixed_session_batches=True)
    assert bad.unported() == ["mixed_session_batches"]
