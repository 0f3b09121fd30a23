"""Loading a checkpoint the PyTorch reference trained, in the port and in
the JAX package.

No reference checkpoint ships with the repository, so the tests make them:
JAX's ``params_to_reference_state_dict`` writes a toy model's params
(``torch_parity.TOY``: 24 + 2 channels, T=20, H=64, 4 heads, 2+2 layers)
in the reference's names, with shared and with unshared modality
embeddings, plus a key the reference would carry and the map does not
name; the whole-module pickle comes from a stand-in ``nn.Module`` defined
in a module that only ``reference_src`` makes importable. Tolerances:

- the same ``.pt`` through JAX's and the port's
  ``load_reference_checkpoint``: the eval forward's predictions atol 1e-5
  and loss rtol 1e-5 (f32; JAX's attention through Pallas in interpret
  mode);
- the file forms against each other, and the converter's round trip
  (``to-port`` then ``to-reference``): bit for bit;
- the refusals (``ap`` width, a missing key, unequal shared tables): the
  exception types JAX raises;
- ``eval_multi_modal --reference_ckpt`` on the CPU: finite results;
- a trainer resumed from the converted, params-only checkpoint (a
  warning, a fresh optimizer, the stored step) against JAX's: the trainer
  lockstep's gates over the first epoch; a truncated file raises.
"""

import math
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from torch_parity import (N_AP, N_BEH, T, TOY, jax_inputs, jax_model,
                          make_batch, torch_inputs)
from multi_modal_foundation_model_tpu.eval.loading import (
    load_reference_checkpoint as jax_load)
from multi_modal_foundation_model_tpu.utils.torch_convert import (
    params_to_reference_state_dict)
from multi_modal_foundation_model_tpu_torch.eval import (
    load_model_data_local, load_reference_checkpoint)
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.scripts import (
    convert_checkpoint, eval_multi_modal)

PRED_ATOL, LOSS_RTOL = 1e-5, 1e-5
CHANNELS = {"ap": N_AP, "behavior": N_BEH}
HEADS = dict(n_heads=TOY["n_heads"])
EXTRA = "masker.unused_buffer"          # a key the map does not name


def _reference_sd(share: bool) -> dict:
    """A toy model's params in the reference's names (JAX's own
    converter), as torch tensors, with an extra key."""
    _, params = jax_model(share_modality_embeddings=share)
    sd = params_to_reference_state_dict(params,
                                        share_modality_embeddings=share)
    out = {k: torch.from_numpy(np.array(v))
           for k, v in sd.items()}
    out[EXTRA] = torch.zeros(3)
    return out


def _batch():
    spikes, beh, attn, ts = make_batch(5, 4)
    ap_eval = np.zeros_like(spikes, np.int32)
    ap_eval[:, 14:] = 1
    return spikes, beh, attn, ts, ap_eval, np.zeros_like(beh, np.int32)


def _port_forward(model):
    with torch.no_grad():
        return model(torch_inputs(*_batch()))


@pytest.mark.parametrize("share", [True, False], ids=["shared", "unshared"])
def test_reference_ckpt_matches_jax(share, tmp_path):
    path = tmp_path / "ref.pt"
    torch.save(_reference_sd(share), path)
    over = dict(HEADS, share_modality_embeddings=share)
    jmodel, jparams = jax_load(str(path), CHANNELS, max_F=T, **over)
    tmodel = load_reference_checkpoint(str(path), CHANNELS, max_F=T,
                                       device="cpu", **over)
    assert tmodel.config.n_enc_layers == TOY["n_enc_layers"]
    assert tmodel.config.inter_size == TOY["inter_size"]
    assert tmodel.config.mask_params.ratio == 0.0
    assert not tmodel.config.force_active
    want = jmodel.apply({"params": jparams}, jax_inputs(*_batch()))
    got = _port_forward(tmodel)
    for mod in ("ap", "behavior"):
        np.testing.assert_allclose(got.mod_preds[mod].numpy(),
                                   np.asarray(want.mod_preds[mod]),
                                   atol=PRED_ATOL, rtol=0, err_msg=mod)
    np.testing.assert_allclose(float(got.loss), float(want.loss),
                               rtol=LOSS_RTOL)


_STAND_IN = '''
import torch


class ReferenceStandIn(torch.nn.Module):
    """Pickled whole, as the reference pickles its model."""

    def __init__(self, sd):
        super().__init__()
        self.sd = sd

    def state_dict(self, *args, **kwargs):
        return self.sd
'''


def test_file_forms_load(tmp_path):
    """A plain ``state_dict``, ``{'model': sd}``, ``{'state_dict': sd}``
    and the whole-module pickle (bare and under ``'model'``; a warning,
    then full unpickling with ``reference_src`` on ``sys.path``) give the
    same model, bit for bit."""
    sd = _reference_sd(True)
    src = tmp_path / "refsrc"
    src.mkdir()
    (src / "ref_stand_in.py").write_text(_STAND_IN)
    sys.path.insert(0, str(src))
    try:
        import ref_stand_in
        module = ref_stand_in.ReferenceStandIn(sd)
        forms = {"plain": sd, "model": {"model": sd, "epoch": 3},
                 "state_dict": {"state_dict": sd},
                 "pickle": module, "pickle_model": {"model": module}}
        for name, obj in forms.items():
            torch.save(obj, tmp_path / f"{name}.pt")
    finally:
        sys.path.remove(str(src))
        sys.modules.pop("ref_stand_in", None)
    base = _port_forward(load_reference_checkpoint(
        str(tmp_path / "plain.pt"), CHANNELS, max_F=T, device="cpu",
        **HEADS))
    for name in forms:
        path = str(tmp_path / f"{name}.pt")
        kw = dict(max_F=T, device="cpu", **HEADS)
        if name.startswith("pickle"):
            with pytest.warns(UserWarning, match="weights_only=False"):
                with pytest.raises(ModuleNotFoundError):   # no source
                    load_reference_checkpoint(path, CHANNELS, **kw)
            try:
                with pytest.warns(UserWarning, match="weights_only=False"):
                    model = load_reference_checkpoint(
                        path, CHANNELS, reference_src=str(src), **kw)
            finally:
                if str(src) in sys.path:
                    sys.path.remove(str(src))
                sys.modules.pop("ref_stand_in", None)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                model = load_reference_checkpoint(path, CHANNELS, **kw)
        out = _port_forward(model)
        for mod in ("ap", "behavior"):
            torch.testing.assert_close(out.mod_preds[mod],
                                       base.mod_preds[mod], atol=0, rtol=0)


def test_refusals_match_jax(tmp_path):
    """A wrong ``ap`` width (ValueError), a missing key (KeyError) and
    unequal shared modality tables (ValueError) raise, on both sides."""
    sd = _reference_sd(True)
    cases = {}
    cases["width"] = (sd, dict(CHANNELS, ap=N_AP + 1), ValueError)
    missing = dict(sd)
    del missing["decoder.1.cross_attn.value.weight"]
    cases["missing"] = (missing, CHANNELS, KeyError)
    unequal = dict(sd)
    key = "decoder_embeddings.ap.embedder.mod_emb.weight"
    unequal[key] = unequal[key] + 1.0
    cases["unequal"] = (unequal, CHANNELS, ValueError)
    for name, (obj, channels, exc) in cases.items():
        path = str(tmp_path / f"{name}.pt")
        torch.save(obj, path)
        with pytest.raises(exc):
            jax_load(path, channels, max_F=T, **HEADS)
        with pytest.raises(exc):
            load_reference_checkpoint(path, channels, max_F=T, device="cpu",
                                      **HEADS)


def test_converter_round_trips(tmp_path):
    """``to-port`` writes a checkpoint dir that ``load_model_data_local``
    reads (the same forward, bit for bit); ``to-reference`` writes back
    every tensor the map names, bit for bit (the extra key is not one).
    ``to-reference`` refuses a session-stitched checkpoint; ``to-port``
    runs on the card unless asked for the CPU."""
    from multi_modal_foundation_model_tpu_torch.data.session import (
        synthetic_splits)
    from multi_modal_foundation_model_tpu_torch.eval.loading import (
        save_model_config)
    from multi_modal_foundation_model_tpu_torch.train.checkpoint import (
        save_checkpoint)

    sd = _reference_sd(True)
    torch.save(sd, tmp_path / "ref.pt")
    out_dir = tmp_path / "port"
    # n_heads is not in the reference's shapes: the converter builds the
    # default 8 heads, which H=64 allows; the weights do not depend on it
    convert_checkpoint.main(["to-port", str(tmp_path / "ref.pt"),
                             str(out_dir), "--n-neurons", str(N_AP),
                             "--max-F", str(T), "--device", "cpu"])
    model, _ = load_model_data_local(
        model_dir=str(out_dir), test_session=synthetic_splits(
            seed=0, n_trials=10, n_neurons=N_AP, n_timesteps=T).test,
        max_time_length=T, device="cpu")
    direct = load_reference_checkpoint(str(tmp_path / "ref.pt"), CHANNELS,
                                       max_F=T, device="cpu")
    for mod in ("ap", "behavior"):
        torch.testing.assert_close(_port_forward(model).mod_preds[mod],
                                   _port_forward(direct).mod_preds[mod],
                                   atol=0, rtol=0)
    convert_checkpoint.main(["to-reference", str(out_dir / "model_best.pt"),
                             str(tmp_path / "back.pt")])
    back = torch.load(tmp_path / "back.pt", weights_only=True)
    assert set(back) == set(sd) - {EXTRA}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k

    stitched = tmm.MultiModal(tmm.MultiModalConfig(**TOY, n_sessions=2),
                              device="cpu")
    st_dir = tmp_path / "stitched"
    save_model_config(str(st_dir), stitched.config)
    save_checkpoint(str(st_dir), "best", {"model": stitched.state_dict()})
    with pytest.raises(ValueError, match="session-stitched"):
        convert_checkpoint.main(["to-reference", str(st_dir / "model_best.pt"),
                                 str(tmp_path / "x.pt")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert_checkpoint.main(["to-port", str(tmp_path / "ref.pt"),
                                     str(tmp_path / "card"), "--n-neurons",
                                     str(N_AP), "--max-F", str(T)])


def test_eval_script_reference_ckpt_on_cpu(tmp_path):
    """``eval_multi_modal --reference_ckpt`` on a synthetic session of 24
    neurons (a reference checkpoint of the session's width, T=100, 1+1
    layers, H=64, the default 8 heads): all six modes, finite results,
    artifacts under ``<base_path>/reference_ckpt_eval``."""
    cfg = tmm.MultiModalConfig(
        n_channels=CHANNELS, max_F=100, hidden_size=64, n_enc_layers=1,
        n_dec_layers=1, inter_size=128)
    model = tmm.MultiModal(cfg, device="cpu")
    torch.save({"model": model.state_dict()}, tmp_path / "ref.pt")
    results = eval_multi_modal.main(
        ["--synthetic", "--n_neurons", str(N_AP), "--n_trials", "40",
         "--device", "cpu", "--base_path", str(tmp_path),
         "--reference_ckpt", str(tmp_path / "ref.pt"), "--use_MtM",
         "--co_smooth", "--forward_pred", "--inter_region",
         "--intra_region"])
    out = tmp_path / "reference_ckpt_eval" / "eval"
    for mode in ("per_neuron", "forward_pred", "inter_region",
                 "intra_region", "modal_spike", "modal_behavior"):
        assert (out / mode / "bps.npy").exists()
    assert (out / "results.json").exists()
    for v in results.values():
        vals = v.values() if isinstance(v, dict) else [v]
        assert all(math.isfinite(x) or math.isnan(x) for x in vals)
    assert any(math.isfinite(v) for v in results.values()
               if not isinstance(v, dict))


def test_params_only_checkpoint_resumes_as_jax(tmp_path):
    """Both trainers resume from a converted reference checkpoint (the
    port's ``to-port`` output, JAX's ``to-flax`` form: params only): each
    restores the params, keeps a fresh optimizer and warns; the first
    epoch after that (dropout 0, the co-smooth / forward-pred menu) holds
    the trainer lockstep's gates (losses rtol 2e-5, params atol 2e-5, the
    key biases left out). A step stored beside the params is restored on
    both sides; a truncated file still raises."""
    from multi_modal_foundation_model_tpu.data import loader as jloader
    from multi_modal_foundation_model_tpu.data import session as jsession
    from multi_modal_foundation_model_tpu.models import multimodal as jmm
    from multi_modal_foundation_model_tpu.ops.masking import MaskParams as JMP
    from multi_modal_foundation_model_tpu.train import trainer as jtrainer
    from multi_modal_foundation_model_tpu.train.checkpoint import (
        save_checkpoint as jax_save)
    from multi_modal_foundation_model_tpu.train.schedule import (
        OptimizerConfig as JOC)
    from multi_modal_foundation_model_tpu_torch.data import loader as tloader
    from multi_modal_foundation_model_tpu_torch.data import session as tsession
    from multi_modal_foundation_model_tpu_torch.ops.masking import MaskParams
    from multi_modal_foundation_model_tpu_torch.train import (
        MultiModalTrainer, OptimizerConfig, TrainerConfig)
    from multi_modal_foundation_model_tpu_torch.train.checkpoint import (
        save_checkpoint)

    mask = dict(channels=(1, 5, 20, 30), timesteps=(12, 15, 19))
    menu = ("co-smooth", "forward-pred")

    def tcfg(cls, log_dir):
        return cls(num_epochs=2, log_dir=str(log_dir), seed=0,
                   mask_type="input", mask_mode=menu, mixed_training=True,
                   eval_every=10 ** 9)

    def loaders(loader_mod, session_mod):
        sp = session_mod.synthetic_splits(seed=0, n_trials=64,
                                          n_neurons=N_AP, n_timesteps=T)
        kw = dict(batch_size=8, max_time_length=T, max_space_length=N_AP)
        return (loader_mod.make_loader(sp.train, **kw),
                loader_mod.make_loader(sp.val, shuffle=False, **kw))

    torch.save(_reference_sd(True), tmp_path / "ref.pt")
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    convert_checkpoint.main(["to-port", str(tmp_path / "ref.pt"),
                             str(port_dir), "--n-neurons", str(N_AP),
                             "--max-F", str(T), "--name", "last",
                             "--device", "cpu"])
    # JAX's to-flax: the reference's params, nothing else
    _, jparams = jax_load(str(tmp_path / "ref.pt"), n_channels=CHANNELS,
                          max_F=T)
    jax_save(str(jax_dir), "last", {"params": jparams})

    cfg = tmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                               mask_params=MaskParams(**mask),
                               remat_layers=False)
    port = MultiModalTrainer(tmm.MultiModal(cfg, device="cpu"),
                             *loaders(tloader, tsession),
                             OptimizerConfig(lr=1e-3),
                             tcfg(TrainerConfig, port_dir))
    with pytest.warns(UserWarning, match="params-only"):
        assert port.restore("last") == 0
    assert port.step == 0 and port.optimizer.count == 0
    jcfg = jmm.MultiModalConfig(**TOY, dropout=0.0, embed_dropout=0.0,
                                mask_params=JMP(**mask), remat_layers=False)
    jtr = jtrainer.MultiModalTrainer(
        jmm.MultiModal(jcfg), *loaders(jloader, jsession), JOC(lr=1e-3),
        tcfg(jtrainer.TrainerConfig, jax_dir))
    with pytest.warns(UserWarning, match="params-only"):
        jtr.restore("last")
    jlosses = []
    get_step = jtr._get_train_step

    def recording(*a):
        step = get_step(*a)

        def run(*args):
            state, loss = step(*args)
            jlosses.append(float(loss))
            return state, loss
        return run

    jtr._get_train_step = recording
    jtr.train_epoch(0)
    losses = port.train_epoch(0)["step_losses"]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=0)
    from multi_modal_foundation_model_tpu_torch.utils.convert import (
        params_from_jax)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jtr.state.params), cfg)
    for name, p in port.model.state_dict().items():
        if not name.endswith("key.bias"):
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       atol=2e-5, rtol=0, err_msg=name)

    # a stored step comes back with the params (JAX: state.step)
    tree = torch.load(port_dir / "model_last.pt", weights_only=True)
    save_checkpoint(str(port_dir), "stepped", dict(tree, step=5))
    jax_save(str(jax_dir), "stepped", {"params": jparams, "step": 5})
    with pytest.warns(UserWarning, match="params-only"):
        port.restore("stepped")
    with pytest.warns(UserWarning, match="params-only"):
        jtr.restore("stepped")
    assert port.step == int(jtr.state.step) == 5
    # a file that cannot be read raises, and is not taken for params-only
    raw = (port_dir / "model_last.pt").read_bytes()
    (port_dir / "model_cut.pt").write_bytes(raw[:len(raw) // 2])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(Exception) as err:
            port.restore("cut")
    assert not isinstance(err.value, UserWarning)
