"""Tensor-parallel partitioning: parameter name -> sharded dimension.

The port's counterpart of ``multi_modal_foundation_model_tpu/parallel/
partition.py``: the same Megatron pattern over the port's ``state_dict``
names (the reference's, ``utils/torch_convert.py:21-40`` of the JAX
package), in the same order, first match wins (``partition_rules``):

- attention ``query`` / ``key`` / ``value`` column-parallel (heads split
  over the ``model`` axis), ``out_proj`` row-parallel;
- MLP ``up_proj`` column-parallel, ``down_proj`` row-parallel;
- the tokenizers' ``token_embed`` column-parallel over its intermediate
  width, ``projection`` row-parallel;
- everything else replicated.

A spec names a mesh axis (or ``None``) per dimension of the leaf as the
port stores it: a Linear's weight is ``(out, in)``, JAX's kernel ``(in,
out)``, so a column-parallel weight shards dimension 0 here where JAX
shards the last; the stitched ``(S, N, inter)`` kernels keep JAX's layout.
A spec shorter than the leaf is left-padded with ``None`` (JAX
``_pad_spec``), and a dimension that does not divide the axis falls back
to replication (JAX ``spec_for``, :87-105), so the 2-channel behavior
tokenizer stays replicated wherever its 4-wide intermediate does not
divide the model axis.

One departure, so that the rules and the kernel call cannot disagree: an
attention's projections are sharded only when its heads divide the
``model`` axis (``module_placements``). JAX shards them by the rules alone
and runs such an attention unsharded (``_tp_mesh_axis``, ``ops/
attention.py:504-512``), which XLA reshards around; the port has no
resharding, so it keeps that attention whole on every rank.

``shard_module`` slices each parameter to its rank's shard in place and
tells the modules how they are split (``Dense.tp``, an attention's local
heads and their offset, ``module.mesh`` for the draw offsets);
``gather_full`` / ``full_state_dict`` and ``shard_state_dict`` move
between a rank's shards and the single-device layout that checkpoints
hold.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh, all_gather_cat

Spec = Tuple[Optional[str], ...]

# a Linear's weight is (out, in): column-parallel shards out, row-parallel
# shards in; raw (..., in, out) kernels (the stitched tokenizer) shard out
_COL = ("model", None)
_ROW = (None, "model")
_VEC = ("model",)
_RAW_COL = (None, "model")
_TOKENIZER = r".*_embeddings\.[^.]+\.embedder\."


def partition_rules() -> List[Tuple[str, Spec]]:
    """Ordered (regex, spec) rules over the port's parameter names (JAX
    ``partition_rules``, ``partition.py:46-74``)."""
    return [
        (r".*\.(attn|cross_attn)\.(query|key|value)\.weight", _COL),
        (r".*\.(attn|cross_attn)\.(query|key|value)\.bias", _VEC),
        (r".*\.(attn|cross_attn)\.out_proj\.weight", _ROW),
        (r".*\.mlp\.up_proj\.weight", _COL),
        (r".*\.mlp\.up_proj\.bias", _VEC),
        (r".*\.mlp\.down_proj\.weight", _ROW),
        # tokenizers: the Dense token_embed and the stitched
        # (S, N, inter) / (S, inter) leaves, then the projection
        (_TOKENIZER + r"token_embed\.weight", _COL),
        (_TOKENIZER + r"token_embed_kernel", _RAW_COL),
        (_TOKENIZER + r"token_embed(\.bias|_bias)", _VEC),
        (_TOKENIZER + r"projection\.weight", _ROW),
        (r".*", ()),
    ]


def _pad_spec(spec: Spec, rank: int) -> Optional[Spec]:
    if len(spec) > rank:
        return None
    return (None,) * (rank - len(spec)) + tuple(spec)


def spec_for(name: str, shape: Sequence[int], mesh: Optional[Mesh],
             rules=None) -> Spec:
    """The spec of one leaf, any axis whose dimension does not divide the
    mesh axis degraded to replication; canonical (no trailing ``None``)."""
    sizes = {} if mesh is None else mesh.shape
    for pattern, spec in rules or partition_rules():
        if re.fullmatch(pattern, name):
            padded = _pad_spec(spec, len(shape))
            if padded is None:
                return ()
            out = [axis if axis is not None and sizes.get(axis, 1) > 1
                   and dim % sizes[axis] == 0 else None
                   for dim, axis in zip(shape, padded)]
            while out and out[-1] is None:
                out.pop()
            return tuple(out)
    return ()


def _model_dim(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def module_placements(model: torch.nn.Module, mesh: Optional[Mesh]
                      ) -> Dict[str, Optional[int]]:
    """Per parameter name (``named_parameters`` order, shared tables once),
    the dimension sharded over the ``model`` axis, or None: the rules, and
    an attention whose heads do not divide the axis kept whole."""
    from ..models.layers import Attention, CrossAttention

    out = {name: _model_dim(spec_for(name, p.shape, mesh))
           for name, p in model.named_parameters()}
    tp = 1 if mesh is None else mesh.tp
    for prefix, mod in model.named_modules():
        if isinstance(mod, (Attention, CrossAttention)) \
                and mod.n_heads % tp:
            for name, _ in mod.named_parameters(prefix=prefix):
                out[name] = None
    return out


def _narrow(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.m * n, n)


@torch.no_grad()
def shard_module(model: torch.nn.Module, mesh: Optional[Mesh]
                 ) -> Dict[str, Optional[int]]:
    """Slice every parameter of ``model`` to this rank's shard in place
    (the same ``Parameter`` objects, so an optimizer built after sees the
    shards), mark each sharded one with ``tp_dim``, and tell the modules
    how they are split: every module gets ``mesh`` (the draw offsets of
    dropout and the masker), a sharded ``Dense`` its ``tp`` ("col" or
    "row") and new width, an attention its local heads and their offset,
    a session-stitched tokenizer ``tp = "col"`` when its ``(S, N, inter)``
    kernel and ``(S, inter)`` bias keep this rank's columns of ``inter``
    (JAX ``partition.py:64-69``; its ``projection`` is the row-parallel
    ``Dense`` after it, the stitched head stays replicated). Returns the
    placements."""
    from ..models.layers import (Attention, CrossAttention, Dense,
                                 SessionStitchedTokenizer)

    if mesh is None:
        return {}
    placements = module_placements(model, mesh)
    for mod in model.modules():
        mod.mesh = mesh
    for name, p in model.named_parameters():
        dim = placements[name]
        if dim is not None:
            p.data = _narrow(p.data, dim, mesh).contiguous().clone()
            p.tp_dim = dim
    for mod in model.modules():
        if isinstance(mod, Dense):
            dim = getattr(mod.weight, "tp_dim", None)
            if dim is not None:
                mod.tp = "col" if dim == 0 else "row"
                mod.out_features, mod.in_features = mod.weight.shape
        elif isinstance(mod, (Attention, CrossAttention)) \
                and getattr(mod.query.weight, "tp_dim", None) is not None:
            mod.n_heads //= mesh.tp
            mod.head0 = mesh.m * mod.n_heads
        elif isinstance(mod, SessionStitchedTokenizer) and getattr(
                mod.token_embed_kernel, "tp_dim", None) is not None:
            mod.tp = "col"
    return placements


def gather_full(t: torch.Tensor, dim: Optional[int],
                mesh: Optional[Mesh]) -> torch.Tensor:
    """The single-device tensor of a shard (``dim`` None: ``t`` itself),
    gathered over the model group: a collective, every rank calls it."""
    if dim is None or mesh is None:
        return t
    return all_gather_cat(t, mesh.model_group, dim)


def shard_tensor(t: torch.Tensor, dim: Optional[int],
                 mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's shard of a single-device tensor."""
    if dim is None or mesh is None:
        return t
    return _narrow(t, dim, mesh).contiguous()


def full_state_dict(model: torch.nn.Module, mesh: Optional[Mesh]
                    ) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the single-device layout (the sharded
    entries gathered): a collective."""
    dims = {name: getattr(p, "tp_dim", None)
            for name, p in model.named_parameters(remove_duplicate=False)}
    return {name: gather_full(t, dims.get(name), mesh)
            for name, t in model.state_dict().items()}


def shard_state_dict(sd: Dict[str, torch.Tensor], model: torch.nn.Module,
                     mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A single-device ``state_dict`` cut to this rank's shards of
    ``model``."""
    dims = {name: getattr(p, "tp_dim", None)
            for name, p in model.named_parameters(remove_duplicate=False)}
    return {name: shard_tensor(t, dims.get(name), mesh)
            for name, t in sd.items()}
