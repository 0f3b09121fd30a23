"""Model-config sidecar I/O and checkpoint loading for the eval.

The port's copy of ``multi_modal_foundation_model_tpu/eval/loading.py``:
``save_model_config``/``load_model_config`` (``model_config.json``; the
port and the JAX package read each other's file) and
``load_model_data_local`` (:39-73), which rebuilds a trained model from a
port checkpoint with the masker disabled by configuration (``ratio=0``,
``force_active=False``) and builds the full-test-set loader in trial order;
``load_multisession_model_data_local`` (:76-129) does the same for a
session-stitched checkpoint and its ``sessions.json`` sidecar;
``load_reference_checkpoint`` (:131-225) loads a checkpoint that the
PyTorch reference trained.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from ..data.loader import DataLoader, make_loader
from ..data.session import SessionData
from ..models.multimodal import MultiModal, MultiModalConfig
from ..utils.convert import reference_state_dict_select
from ..utils.device import DeviceLike


def save_model_config(log_dir: str, config: MultiModalConfig) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "model_config.json")
    with open(path, "w") as f:
        json.dump(config.to_json_dict(), f, indent=1)
    return path


def load_model_config(log_dir: str) -> MultiModalConfig:
    with open(os.path.join(log_dir, "model_config.json")) as f:
        return MultiModalConfig.from_json_dict(json.load(f))


def _eval_model(model_dir: str, config: MultiModalConfig,
                checkpoint_name: str, device: DeviceLike) -> MultiModal:
    """``config``'s model, masker off, carrying the checkpoint's weights."""
    # imported here: the train package imports this module
    from ..train.checkpoint import restore_checkpoint

    config = dataclasses.replace(
        config,
        mask_params=dataclasses.replace(config.mask_params, ratio=0.0),
        force_active=False)
    model = MultiModal(config, device=device)
    tree = restore_checkpoint(model_dir, checkpoint_name,
                              map_location=next(model.parameters()).device)
    model.load_state_dict(tree["model"])
    return model


def load_model_data_local(
    *,
    model_dir: str,
    test_session: SessionData,
    checkpoint_name: str = "best",
    max_time_length: int = 100,
    max_space_length: Optional[int] = None,
    seed: int = 42,
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[MultiModal, DataLoader]:
    """(model carrying the checkpoint's weights, full-test-set loader).

    JAX returns (model, params, loader); the port's model holds its
    parameters. Held-out masking at eval time arrives through explicit
    ``eval_mask`` tensors, so the masker is switched off."""
    config = load_model_config(model_dir)
    model = _eval_model(model_dir, config, checkpoint_name, device)
    n_space = max_space_length or config.n_channels["ap"]
    loader = make_loader(
        test_session,
        batch_size=batch_size or test_session.n_trials,
        max_time_length=max_time_length,
        max_space_length=n_space,
        shuffle=False,
        seed=seed,
    )
    return model, loader


def load_multisession_model_data_local(
    *,
    model_dir: str,
    test_sessions: Dict[str, SessionData],
    checkpoint_name: str = "best",
    max_time_length: int = 100,
    seed: int = 42,
    device: DeviceLike = None,
) -> Tuple[MultiModal, Dict[str, DataLoader], Dict[str, int]]:
    """(model carrying a session-stitched checkpoint's weights, {eid:
    full-test-set loader}, eid_to_sid) from ``model_dir`` and its
    ``sessions.json`` sidecar (written by ``train_multi_session``): every
    session padded to the checkpoint's ``N_max``, so the stitched forward
    runs at its trained width. Raises ``ValueError`` for a single-session
    checkpoint and for an eid the checkpoint did not train on."""
    config = load_model_config(model_dir)
    if config.n_sessions <= 1:
        raise ValueError(
            f"{model_dir} holds a single-session checkpoint "
            "(n_sessions=1); use load_model_data_local")
    with open(os.path.join(model_dir, "sessions.json")) as f:
        meta = json.load(f)
    eid_to_sid = {e: i for i, e in enumerate(meta["eids"])}
    missing = set(test_sessions) - set(eid_to_sid)
    if missing:
        raise ValueError(
            f"sessions {sorted(missing)} not in the checkpoint's "
            f"sessions.json (trained eids: {meta['eids']})")
    model = _eval_model(model_dir, config, checkpoint_name, device)
    loaders = {
        eid: make_loader(
            sess, batch_size=sess.n_trials,
            max_time_length=max_time_length,
            max_space_length=int(meta["n_max"]), shuffle=False, seed=seed)
        for eid, sess in test_sessions.items()}
    return model, loaders, eid_to_sid


def _reference_state_dict(obj) -> Dict[str, Any]:
    """The ``state_dict`` in a loaded reference checkpoint, in JAX's order
    of forms (:180-192)."""
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    if isinstance(obj, dict) and hasattr(obj.get("model"), "state_dict"):
        return obj["model"].state_dict()
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        return obj["state_dict"]
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        return obj["model"]
    if isinstance(obj, dict):
        return obj
    raise ValueError(f"unrecognized checkpoint object: {type(obj)}")


def load_reference_checkpoint(
    path: str,
    n_channels: Dict[str, int],
    max_F: int = 100,
    reference_src: Optional[str] = None,
    device: DeviceLike = None,
    **config_overrides,
) -> MultiModal:
    """A checkpoint the PyTorch reference trained, as the port's model on
    ``device`` (default: the card), masker off (``ratio=0``,
    ``force_active=False``), ready for ``co_smoothing_eval``.

    Reads every form JAX reads (:131-225): a plain ``state_dict``, one
    under ``'model'`` or ``'state_dict'``, or a whole-module pickle (the
    reference's ``{'model': <nn.Module>, ...}``). ``torch.load`` runs with
    ``weights_only=True`` first; a file that needs more warns and is
    unpickled in full (only for checkpoints you trust), with
    ``reference_src`` put on ``sys.path`` so the pickled classes import.
    The encoder and decoder depth, the width, the FFN width and the
    tokenizer multiplier come from the ``state_dict``; ``n_heads`` cannot
    (it changes no shape) and comes from ``config_overrides``, as in JAX.
    An ``ap`` width other than ``n_channels['ap']`` raises
    ``ValueError``. The weights go through
    ``utils.convert.reference_state_dict_select`` (JAX's key selection)
    and load strictly."""
    if reference_src and reference_src not in sys.path:
        sys.path.insert(0, reference_src)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        warnings.warn(
            f"{path} is not a plain-tensor checkpoint; falling back to "
            "weights_only=False (full unpickling: only do this for "
            "checkpoints you trust, e.g. the reference's whole-module "
            "pickles)", stacklevel=2)
        obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = _reference_state_dict(obj)

    n_enc = 1 + max((int(k.split(".")[1]) for k in sd
                     if k.startswith("encoder.")), default=4)
    n_dec = 1 + max((int(k.split(".")[1]) for k in sd
                     if k.startswith("decoder.")), default=4)
    hidden = sd["encoder_norm.weight"].shape[0]
    inter = sd["encoder.0.mlp.up_proj.weight"].shape[0]
    ap_tok = sd["encoder_embeddings.ap.embedder.token_embed.weight"]
    mult = max(1, round(ap_tok.shape[0] / max(ap_tok.shape[1], 1)))
    if ap_tok.shape[1] != n_channels.get("ap"):
        raise ValueError(
            f"checkpoint expects {ap_tok.shape[1]} 'ap' channels, "
            f"caller provided {n_channels.get('ap')}")

    kw: Dict[str, Any] = dict(
        n_channels=dict(n_channels), max_F=max_F, hidden_size=hidden,
        n_enc_layers=n_enc, n_dec_layers=n_dec, inter_size=inter,
        mult=mult, force_active=False)
    kw.update(config_overrides)
    config = MultiModalConfig(**kw)
    config = dataclasses.replace(
        config,
        mask_params=dataclasses.replace(config.mask_params, ratio=0.0))
    weights = reference_state_dict_select(
        sd, avail_mod=config.avail_mod, n_enc_layers=n_enc,
        n_dec_layers=n_dec,
        share_modality_embeddings=config.share_modality_embeddings)
    model = MultiModal(config, device=device)
    model.load_state_dict(weights, strict=True)
    return model
