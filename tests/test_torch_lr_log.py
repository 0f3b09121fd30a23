"""The learning rate ``MultiModalTrainer`` logs per epoch.

The port logs the rate of the next optimizer update
(``Optimizer.lr``: the OneCycle schedule at the update count). JAX logs
``schedule(state.step)`` (``train/trainer.py:753`` there), where
``state.step`` counts mini-steps while optax's ``MultiSteps`` runs the
schedule on updates. So:

- with ``gradient_accumulation_steps=2`` the port's logged rate is the
  schedule at ``steps // 2`` (the port's choice, pinned here), not at the
  mini-step count JAX would read it at;
- with ``gradient_accumulation_steps=1`` both read the schedule at the
  same count, and the port's rate equals JAX's schedule within rtol 1e-6
  and atol 4 f32 ulps of the peak rate (JAX evaluates the cosine in f32,
  whose rounding scales with its terms, of the size of the peak rate, not
  with the annealed result; torch's scheduler computes in f64).
"""

import json

import numpy as np
import pytest

from torch_parity import TOY
from multi_modal_foundation_model_tpu.train import schedule as jschedule
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.train import (
    MultiModalTrainer, OptimizerConfig, TrainerConfig)

N_AP, T = TOY["n_channels"]["ap"], TOY["max_F"]
LR = 1e-3
EPOCHS, LR_RTOL, LR_ATOL = 3, 1e-6, 4 * 2.0 ** -23 * LR


def _logged_lrs(tmp_path, k):
    sp = tsession.synthetic_splits(seed=0, n_trials=48, n_neurons=N_AP,
                                   n_timesteps=T)
    kw = dict(batch_size=8, max_time_length=T, max_space_length=N_AP)
    train = tloader.make_loader(sp.train, **kw)
    cfg = tmm.MultiModalConfig(
        **{**TOY, "n_enc_layers": 1, "n_dec_layers": 1},
        dropout=0.0, embed_dropout=0.0)
    ocfg = OptimizerConfig(lr=LR, gradient_accumulation_steps=k)
    tr = MultiModalTrainer(
        tmm.MultiModal(cfg, device="cpu"), train, None, ocfg,
        TrainerConfig(num_epochs=EPOCHS, log_dir=str(tmp_path), seed=0))
    tr.train()
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    lrs = [r["lr"] for r in rows if "epoch" in r]
    return lrs, len(train), tr


@pytest.mark.parametrize("k", [1, 2])
def test_logged_lr_is_the_next_updates_rate(tmp_path, k):
    lrs, per_epoch, tr = _logged_lrs(tmp_path, k)
    assert len(lrs) == EPOCHS
    total = EPOCHS * per_epoch // k
    _, jax_schedule = jschedule.make_optimizer(
        jschedule.OptimizerConfig(lr=LR, gradient_accumulation_steps=k),
        total)
    for epoch, lr in enumerate(lrs):
        mini_steps = (epoch + 1) * per_epoch
        assert lr == tr.optimizer.schedule_at(mini_steps // k)[0]
        if k == 1:
            np.testing.assert_allclose(lr, float(jax_schedule(mini_steps)),
                                       rtol=LR_RTOL, atol=LR_ATOL)
        elif epoch < EPOCHS - 1:
            # JAX would log the schedule at the mini-step count
            assert not np.isclose(lr, float(jax_schedule(mini_steps)),
                                  rtol=1e-3)
