"""Repairs of the port's first slice against the JAX package.

- **Fixup init.** ``MultiModal(config)`` with ``fixup_init`` (the default,
  ``mm.yaml:49,78``) rescales ``out_proj``/``up_proj``/``down_proj`` by
  ``0.67 L**-0.25`` and ``value`` by a further sqrt(2), as JAX's init does.
- **flax-default Linears.** JAX builds ``decoder_proj_context`` and the
  output heads as plain ``MXUDense``: lecun-normal kernel (truncated at 2
  std, so max |w| sqrt(fan_in) <= 2 / 0.8796), zero bias.

  The kind and scale of every Linear parameter are read off a
  JAX-initialised tree (max |w| * sqrt(fan_in): 0, the lecun bound, or,
  for 1000+ elements, snapped to the nearest of 1, f, f*sqrt(2)); the
  port's max |w| must stay
  within that bound and, for tensors of 1000+ elements, reach 90% of it
  (so an unscaled or a doubly scaled init both fail).
- **Loader order.** With and without shuffle, with a ragged tail, over
  three epochs, the port's loader yields JAX's indices and batches.
- **MtM menu ids mask whatever ``force_active`` says.** JAX's menu path
  (``apply_mask_by_id``) calls ``apply_mask`` with its default
  ``active=True``, so a model with ``force_active=False`` evaluated with
  ``training=False`` under an int ``masking_mode`` (the trainer's MtM
  ``eval_epoch``) still masks and scores. The port gives the same
  element mask: the same nonzero ``mod_n_examples`` as JAX's, on the
  same inputs and weights, for a fixed menu scheme (forward-pred) and a
  region scheme with one candidate region (inter-region).
"""

import math

import jax
import numpy as np
import pytest
import torch

from torch_parity import (TOY, jax_inputs, jax_model, make_batch,
                          port_model, torch_inputs)
from multi_modal_foundation_model_tpu.data import loader as jloader
from multi_modal_foundation_model_tpu.data import session as jsession
from multi_modal_foundation_model_tpu.ops import masking as jmask
from multi_modal_foundation_model_tpu_torch.data import loader as tloader
from multi_modal_foundation_model_tpu_torch.data import session as tsession
from multi_modal_foundation_model_tpu_torch.models import layers as tl
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import masking as tmask
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)

GEOM = dict(TOY, n_enc_layers=3, n_dec_layers=2, hidden_size=128)


LECUN = 2.0 / 0.87962566103423978   # max |w| sqrt(fan_in), truncated


def _bound_factor(ratio, n_layers, numel):
    """The init scale JAX used, from max |w| sqrt(fan_in); a tensor under
    1000 elements is too small to tell fixup from torch's default by its
    max, and only the large layer weights are fixup-scaled."""
    if ratio == 0.0:
        return 0.0                          # flax's zero bias
    if ratio > 1.2:
        return LECUN
    if numel < 1000:
        return 1.0
    f = 0.67 * n_layers ** -0.25
    cands = (1.0, f, f * math.sqrt(2))
    return min(cands, key=lambda c: abs(math.log(ratio / c)))


def test_fixup_init_matches_jax_bounds():
    _, jparams = jax_model(geometry=GEOM, seed=3)
    cfg = tmm.MultiModalConfig(**GEOM)
    jsd = params_from_jax(jparams, cfg)
    model = tmm.MultiModal(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    kinds = {}
    for name, jw in jsd.items():
        if name.endswith(("mod_emb.weight", "pos_embed.weight")) \
                or "norm" in name or ".ln" in name:
            continue                          # N(0, 1) tables, LN params
        layer = name.rsplit(".", 1)[0]
        fan_in = jsd[layer + ".weight"].shape[-1]
        n_layers = (cfg.n_enc_layers if name.startswith("encoder.")
                    else cfg.n_dec_layers)
        factor = _bound_factor(jw.abs().max().item() * math.sqrt(fan_in),
                               n_layers, jw.numel())
        bound = factor / math.sqrt(fan_in)
        got = sd[name].abs().max().item()
        assert got <= bound * (1 + 1e-6), (name, got, bound)
        if jw.numel() >= 1000:
            assert got >= 0.9 * bound, (name, got, bound)
        kinds.setdefault(factor if factor in (0.0, LECUN, 1.0) else "fixup",
                         set()).add(name.split(".", 2)[-1]
                                    if name.startswith(("encoder.",
                                                        "decoder."))
                                    else name)
    # read off JAX's tree: fixup on weights only, no q/k/tokenizers
    assert kinds["fixup"] == {"attn.out_proj.weight", "attn.value.weight",
                              "mlp.up_proj.weight", "mlp.down_proj.weight",
                              "cross_attn.out_proj.weight",
                              "cross_attn.value.weight"}
    assert kinds[LECUN] == {"decoder_proj_context.weight",
                            "decoder_embeddings.ap.out.weight",
                            "decoder_embeddings.behavior.out.weight"}
    assert kinds[0.0] == {"decoder_proj_context.bias",
                          "decoder_embeddings.ap.out.bias",
                          "decoder_embeddings.behavior.out.bias"}


def test_fixup_factor_and_off_switch():
    assert tl.fixup_factor(5) == pytest.approx(0.67 * 5 ** -0.25)
    assert tl.fixup_factor(5, value=True) == pytest.approx(
        0.67 * 5 ** -0.25 * math.sqrt(2))
    cfg = tmm.MultiModalConfig(**GEOM, fixup_init=False)
    model = tmm.MultiModal(cfg, device="cpu")
    w = model.encoder[0].attn.out_proj.weight
    assert w.abs().max().item() > 0.9 / math.sqrt(w.shape[1])


def _loaders(shuffle, n_trials=21, batch_size=8, **kw):
    sess_kw = dict(seed=4, n_trials=n_trials, n_neurons=24, n_timesteps=20)
    lkw = dict(batch_size=batch_size, max_time_length=20,
               max_space_length=24, shuffle=shuffle, seed=7, **kw)
    return (jloader.make_loader(jsession.synthetic_session(**sess_kw),
                                **lkw),
            tloader.make_loader(tsession.synthetic_session(**sess_kw),
                                **lkw))


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_matches_jax_over_three_epochs(shuffle, drop_last):
    """21 trials in batches of 8: a ragged tail of 5, padded or dropped."""
    j, t = _loaders(shuffle, drop_last=drop_last)
    assert len(j) == len(t)
    for epoch in range(3):
        jb, tb = list(j), list(t)              # each pass advances epoch
        assert len(jb) == len(tb) == len(t)
        for a, b in zip(jb, tb):
            assert a["n_real"] == b["n_real"]
            for k in ("spikes_data", "target", "time_attn_mask",
                      "space_attn_mask", "spikes_timestamps"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for epoch in (0, 5):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for (ji, jv, jn), (ti, tv, tn) in zip(j.iter_index_batches(),
                                              t.iter_index_batches()):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tv, jv)
            assert tn == jn


def test_loader_unported_samplers_raise():
    """The samplers, unported until the multi-session port, order the
    trials as JAX's do (``stitching=True`` is the stitch sampler); an
    unknown sampler name raises."""
    sess = tsession.synthetic_session(seed=0, n_trials=4, n_neurons=8,
                                      n_timesteps=5)
    jsess = jsession.synthetic_session(seed=0, n_trials=4, n_neurons=8,
                                       n_timesteps=5)
    kw = dict(batch_size=2, max_time_length=5, max_space_length=8)
    for ok in (dict(sampler="length_grouped"), dict(sampler="stitch"),
               dict(stitching=True)):
        t = tloader.make_loader(sess, **kw, **ok)
        j = jloader.make_loader(jsess, **kw, **ok)
        assert t.sampler == j.sampler
        for a, b in zip(j.iter_index_batches(), t.iter_index_batches()):
            np.testing.assert_array_equal(b[0], a[0])
    arrays = tloader.make_loader(sess, **kw).arrays
    assert tloader.DataLoader(arrays, 2, sampler="stitch").sampler == \
        "stitch"
    with pytest.raises(ValueError):
        tloader.DataLoader(arrays, 2, sampler="bogus")


MTM_MENU = ("forward-pred", "inter-region")
FWD_STEPS = (15, 16, 17, 18, 19)


@pytest.fixture(scope="module")
def inactive_models():
    """JAX and port models with ``force_active=False`` on one set of
    weights, forward-pred over the last 5 bins."""
    jmodel, jparams = jax_model(
        seed=4, force_active=False,
        mask_params=jmask.MaskParams(ratio=0.3, timesteps=FWD_STEPS))
    tmodel = port_model(
        jparams, force_active=False,
        mask_params=tmask.MaskParams(ratio=0.3, timesteps=FWD_STEPS))
    return jmodel, jparams, tmodel


@pytest.mark.parametrize("mode_id", [0, 1], ids=MTM_MENU)
def test_mtm_menu_id_masks_without_force_active(inactive_models, mode_id):
    """``training=False``, ``force_active=False``, an int ``masking_mode``:
    the port masks as JAX does. Forward-pred is fixed, so every output
    agrees; inter-region samples one region of the one candidate on the
    spike modality (fixed) and degrades to temporal masking on behavior
    (random on both sides, from different generators), so the spike
    modality's masked count is compared and behavior's is only nonzero."""
    jmodel, jparams, tmodel = inactive_models
    spikes, beh, attn, ts = make_batch(21, 3)
    zeros = (np.zeros_like(spikes, np.int32), np.zeros_like(beh, np.int32))
    ids = np.repeat(np.arange(2, dtype=np.int32), spikes.shape[-1] // 2)
    vocab = {"A": 0, "B": 1}
    jreg = jmask.RegionSets.build(ids, ("A",), ("A",), vocab)
    treg = tmask.RegionSets.build(ids, ("A",), ("A",), vocab)
    want = jmodel.apply({"params": jparams},
                        jax_inputs(spikes, beh, attn, ts, *zeros),
                        masking_mode=mode_id, mtm_modes=MTM_MENU,
                        regions=jreg, training=False,
                        rngs={"mask": jax.random.PRNGKey(5)})
    with torch.inference_mode():
        got = tmodel(torch_inputs(spikes, beh, attn, ts, *zeros),
                     masking_mode=mode_id, mtm_modes=MTM_MENU,
                     regions=treg, training=False, seed=5)
    n_ap = float(want.mod_n_examples["ap"])
    want_ap = (3 * len(FWD_STEPS) * spikes.shape[-1] if mode_id == 0
               else 3 * spikes.shape[1] * int((ids == 0).sum()))
    assert n_ap == want_ap
    assert got.mod_n_examples["ap"].item() == n_ap
    if mode_id == 0:
        for mod in ("ap", "behavior"):
            assert got.mod_n_examples[mod].item() == float(
                want.mod_n_examples[mod]) > 0
            np.testing.assert_allclose(got.mod_preds[mod].numpy(),
                                       np.asarray(want.mod_preds[mod]),
                                       atol=1e-4, rtol=0, err_msg=mod)
            np.testing.assert_allclose(got.mod_loss[mod].item(),
                                       float(want.mod_loss[mod]),
                                       rtol=1e-5, atol=1e-6, err_msg=mod)
    else:
        assert float(want.mod_n_examples["behavior"]) > 0
        assert got.mod_n_examples["behavior"].item() > 0
    # the string-mode path still follows force_active: nothing masked
    with torch.inference_mode():
        off = tmodel(torch_inputs(spikes, beh, attn, ts, *zeros),
                     masking_mode=MTM_MENU[mode_id], regions=treg,
                     training=False, seed=5)
    assert off.mod_n_examples["ap"].item() == 0
