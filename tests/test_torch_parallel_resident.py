"""The single-session ``MultiModalTrainer``'s resident path at dp = 2
against JAX's under ``build_mesh(2)``: the split uploaded whole on every
rank, each step gathering the rank's rows of the global batch, eagerly;
K = 1 and K = 2 (two steps a group, the leftover step single), one epoch
each in lockstep at the gates of ``tests/torch_ms_mesh.py`` (the TOY
model of ``tests/torch_parity.py``, dropout 0, the co-smooth menu, JAX's
initial weights)."""

import jax
import numpy as np
import torch

import torch_parallel_workers as workers
from torch_ms_mesh import assert_epoch, jax_epoch, np_tree, under_mesh
from torch_parity import TOY
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
from multi_modal_foundation_model_tpu.parallel import build_mesh
from multi_modal_foundation_model_tpu.train import trainer as jtrainer
from multi_modal_foundation_model_tpu.train.schedule import (
    OptimizerConfig as JOC)
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

N_AP, T = TOY["n_channels"]["ap"], TOY["max_F"]
MASK = dict(channels=(1, 5, 20, 30), timesteps=(12, 15, 19))
N_TRIALS, B = 64, 8
PATHS = {"k1": dict(device_resident_data=True),
         "k2": dict(device_resident_data=True, steps_per_dispatch=2)}


def test_resident_dp2_in_lockstep_with_jax_mesh(tmp_path):
    cfg = jmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=JMP(**MASK), remat_layers=False)
    sp = jsession.synthetic_splits(seed=0, n_trials=N_TRIALS, n_neurons=N_AP,
                                   n_timesteps=T)
    kw = dict(batch_size=B, max_time_length=T, max_space_length=N_AP)
    tr = jtrainer.MultiModalTrainer(
        jmm.MultiModal(cfg), jloader.make_loader(sp.train, **kw),
        jloader.make_loader(sp.val, shuffle=False, **kw), JOC(lr=1e-3),
        jtrainer.TrainerConfig(num_epochs=2, log_dir=str(tmp_path / "j"),
                               seed=0, mask_type="input",
                               mask_mode=("co-smooth",), eval_every=10 ** 9))
    tcfg = tmm.MultiModalConfig(**TOY)
    torch.save(params_from_jax(np_tree(tr.state.params), tcfg),
               tmp_path / "init.pt")
    ranks = workers.Ranks(dict(
        kind="mm", geometry=TOY, dropout=0.0, embed_dropout=0.0, mask=MASK,
        menu=["co-smooth"], mixed=False, n_trials=N_TRIALS, batch_size=B,
        remat=False, dp=2, tp=1, init=str(tmp_path / "init.pt"),
        log_dir=str(tmp_path / "port"),
        paths=[dict(name=n, over=o) for n, o in PATHS.items()]), 2,
        tmp_path / "ranks")
    jt = under_mesh(tr, build_mesh(dp=2))
    want = {name: jax_epoch(jt, over) for name, over in PATHS.items()}
    got = ranks.result()
    for name in PATHS:
        assert len(got[name]["losses"]) == 7
        assert_epoch(got[name], want[name], cfg=tcfg)
    # the eval gathers the global batch on every rank
    assert np.isfinite(got["k1"]["eval_r2"])
