"""JAX param trees -> the port's ``state_dict``.

The port's own copy of the JAX package's ``params_to_reference_state_dict``
(``utils/torch_convert.py:159-221`` there): the port's modules carry the
reference ``state_dict`` names, so a JAX ``MultiModal``'s params (as a
nested dict of numpy arrays) map onto them and load with
``load_state_dict(strict=True)``. Dense kernels ``(in, out)`` transpose to
Linear weights ``(out, in)``; LayerNorm ``scale`` is ``weight``. With
shared modality embeddings the table is emitted under both the encoder and
the decoder key, as the port's shared ``nn.Embedding`` appears under both.
``baseline_params_from_jax`` does the same for the linear baselines, and
``factors_projection_params_from_jax`` for a ``FactorsProjection``.

``reference_state_dict_select`` takes a reference-trained ``state_dict``
(its names are the port's) to the port's, reading only the keys the JAX
package's ``reference_state_dict_to_params`` reads
(``utils/torch_convert.py:88-147`` there): extra keys are ignored,
``pos_embed`` is read where present, a bias where present, a missing key
raises ``KeyError``, and with shared modality embeddings the encoder's and
the decoder's ``mod_emb`` tables must be equal (``ValueError``). The port
then loads the result with ``load_state_dict(strict=True)``.

A session-stitched model (``n_sessions > 1``) has parameters the reference
has no model for, so no reference ``state_dict`` name exists for them: the
port names them after their flax paths, and the JAX package's
``utils/torch_convert.py`` does not map them; they are mapped here straight
from the JAX params. The ``ap`` tokenizers' ``token_embed_kernel`` (S,
N_max, mult * H) and ``token_embed_bias`` (S, mult * H) keep their flax
names and layouts under ``<side>_embeddings.ap.embedder.``, beside the
shared ``projection`` Linear; the stitched head's ``kernel`` (S, H, N_max)
and ``bias`` (S, N_max) sit under ``decoder_embeddings.ap.out.``; the
session table ``session_emb/embedding`` is ``session_emb.weight``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

_NORM_NAMES = ("ln1", "query_norm", "context_norm", "ln2")


def _flat(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def params_from_jax(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """``state_dict`` (f32 CPU tensors) of a port ``MultiModal`` built with
    ``config`` from the JAX ``MultiModal`` params of the same config."""
    flat = _flat(params)
    sd: Dict[str, np.ndarray] = {}

    def linear(ref_key, path):
        sd[ref_key + ".weight"] = flat[path + ("kernel",)].T
        if path + ("bias",) in flat:
            sd[ref_key + ".bias"] = flat[path + ("bias",)]

    def norm(ref_key, path):
        scale = flat[path + ("scale",)]
        if scale.ndim == 0:                      # ScaleNorm
            sd[ref_key + ".scale"] = scale
        else:
            sd[ref_key + ".weight"] = scale
            sd[ref_key + ".bias"] = flat[path + ("bias",)]

    stitched = config.n_sessions > 1
    for m in config.avail_mod:
        for side, tok, mod_emb, pos_emb in (
                ("encoder_embeddings", f"encoder_tokenizers_{m}",
                 f"enc_mod_emb_{m}", f"enc_pos_emb_{m}"),
                ("decoder_embeddings", f"decoder_tokenizers_{m}",
                 f"dec_mod_emb_{m}", f"dec_pos_emb_{m}")):
            emb = f"{side}.{m}.embedder"
            if stitched and m == "ap":
                for leaf in ("token_embed_kernel", "token_embed_bias"):
                    if (tok, leaf) in flat:
                        sd[f"{emb}.{leaf}"] = flat[(tok, leaf)]
            else:
                linear(f"{emb}.token_embed", (tok, "token_embed"))
            linear(f"{emb}.projection", (tok, "projection"))
            src = (f"enc_mod_emb_{m}" if config.share_modality_embeddings
                   else mod_emb)
            sd[f"{emb}.mod_emb.weight"] = flat[(src, "embedding")]
            if config.use_pos:
                sd[f"{emb}.pos_embed.weight"] = flat[(pos_emb, "embedding")]
        if stitched and m == "ap":
            for leaf in ("kernel", "bias"):
                sd[f"decoder_embeddings.{m}.out.{leaf}"] = \
                    flat[(f"out_proj_{m}", leaf)]
        else:
            linear(f"decoder_embeddings.{m}.out", (f"out_proj_{m}",))
    if stitched:
        sd["session_emb.weight"] = flat[("session_emb", "embedding")]

    for i in range(config.n_enc_layers):
        for n in ("ln1", "ln2"):
            norm(f"encoder.{i}.{n}", (f"encoder_{i}", n))
        for n in ("query", "key", "value", "out_proj"):
            linear(f"encoder.{i}.attn.{n}", (f"encoder_{i}", "attn", n))
        for n in ("up_proj", "down_proj"):
            linear(f"encoder.{i}.mlp.{n}", (f"encoder_{i}", "mlp", n))
    norm("encoder_norm", ("encoder_norm",))
    linear("decoder_proj_context", ("decoder_proj_context",))
    for i in range(config.n_dec_layers):
        for n in _NORM_NAMES:
            norm(f"decoder.{i}.{n}", (f"decoder_{i}", n))
        for blk in ("attn", "cross_attn"):
            for n in ("query", "key", "value", "out_proj"):
                linear(f"decoder.{i}.{blk}.{n}", (f"decoder_{i}", blk, n))
        for n in ("up_proj", "down_proj"):
            linear(f"decoder.{i}.mlp.{n}", (f"decoder_{i}", "mlp", n))
    norm("decoder_norm", ("decoder_norm",))

    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def reference_state_dict_select(
    sd: Mapping, avail_mod=("ap", "behavior"), n_enc_layers: int = 5,
    n_dec_layers: int = 5, share_modality_embeddings: bool = True,
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (f32 CPU tensors) from a reference
    ``state_dict`` (tensors or numpy arrays): the keys the JAX package's
    ``reference_state_dict_to_params`` reads, in its order (module
    docstring)."""
    out: Dict[str, torch.Tensor] = {}

    def take(key):
        v = sd[key]
        v = v.detach().cpu() if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.asarray(v))
        out[key] = v.to(torch.float32).clone()

    def linear(key):
        take(key + ".weight")
        if key + ".bias" in sd:
            take(key + ".bias")

    def norm(key):
        if key + ".weight" in sd:                       # LayerNorm
            take(key + ".weight")
            take(key + ".bias")
        else:                                           # ScaleNorm
            take(key + ".scale")

    for m in avail_mod:
        for side in ("encoder_embeddings", "decoder_embeddings"):
            emb = f"{side}.{m}.embedder"
            linear(f"{emb}.token_embed")
            linear(f"{emb}.projection")
            take(f"{emb}.mod_emb.weight")
            if side == "decoder_embeddings" and share_modality_embeddings:
                enc = out[f"encoder_embeddings.{m}.embedder.mod_emb.weight"]
                if not torch.equal(enc, out[f"{emb}.mod_emb.weight"]):
                    raise ValueError(
                        f"share_modality_embeddings=True but encoder/decoder "
                        f"mod_emb for '{m}' differ in the state_dict")
            if f"{emb}.pos_embed.weight" in sd:
                take(f"{emb}.pos_embed.weight")
        linear(f"decoder_embeddings.{m}.out")
    for i in range(n_enc_layers):
        for n in ("ln1", "ln2"):
            norm(f"encoder.{i}.{n}")
        for n in ("query", "key", "value", "out_proj"):
            linear(f"encoder.{i}.attn.{n}")
        for n in ("up_proj", "down_proj"):
            linear(f"encoder.{i}.mlp.{n}")
    norm("encoder_norm")
    linear("decoder_proj_context")
    for i in range(n_dec_layers):
        for n in _NORM_NAMES:
            norm(f"decoder.{i}.{n}")
        for blk in ("attn", "cross_attn"):
            for n in ("query", "key", "value", "out_proj"):
                linear(f"decoder.{i}.{blk}.{n}")
        for n in ("up_proj", "down_proj"):
            linear(f"decoder.{i}.mlp.{n}")
    norm("decoder_norm")
    return out


def baseline_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` (f32 CPU tensors) of a port ``BaselineEncoder`` /
    ``BaselineDecoder`` from the JAX model's params: ``layer.kernel (in,
    out)`` -> ``layer.weight (out, in)``, ``layer.bias`` -> ``layer.bias``."""
    layer = params["layer"]
    return {"layer.weight": torch.from_numpy(np.array(
                np.asarray(layer["kernel"]).T, dtype=np.float32)),
            "layer.bias": torch.from_numpy(np.array(
                layer["bias"], dtype=np.float32))}


def factors_projection_params_from_jax(params: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """``state_dict`` (f32 CPU tensors) of a port ``FactorsProjection`` from
    the JAX module's params: ``proj.kernel (in, out)`` -> ``proj.weight
    (out, in)``, ``proj.bias`` -> ``proj.bias`` where present (an inactive
    module has no params)."""
    if "proj" not in params:
        return {}
    proj = params["proj"]
    out = {"proj.weight": torch.from_numpy(np.array(
        np.asarray(proj["kernel"]).T, dtype=np.float32))}
    if "bias" in proj:
        out["proj.bias"] = torch.from_numpy(np.array(proj["bias"],
                                                     dtype=np.float32))
    return out
