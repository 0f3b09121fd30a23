"""Transformer building blocks and tokenizers (``nn.Module``).

Port of ``multi_modal_foundation_model_tpu/models/layers.py``. Parameter
names are the reference ``state_dict`` names
(``utils/torch_convert.py:21-40`` of the JAX package), with separate
``query``/``key``/``value`` Linears; the projections that share an input
run as ONE GEMM over the concatenated weights at apply time, as the JAX
package's ``_fused_proj`` does, and the q/k/v column views of that product
go to the attention kernels without a copy.

- ``MXUDense`` is ``Dense``, an ``nn.Linear`` with JAX's ``dtype``: with a
  compute dtype, x, weight and bias are cast to it and the product runs in
  it (``_apply_dense``, :153-162; the weights stay f32 master copies and
  their gradients come back through the casts); without one, the
  operands' own dtype. ``MXUEmbed`` is ``nn.Embedding`` (f32 tables). Their
  JAX custom backward passes (:105-150, :533-577) only move the plain
  linear and embedding gradients onto the TPU's matrix unit, so autograd
  is their port.
- Every module takes the compute dtype as JAX's do (``dtype=``): the
  tokenizers, attention projections, MLPs and their layer dropout run in
  it, the norms output it (``_norm``, :459-468). Casts are explicit; no
  ``torch.autocast``, whose op policy is not JAX's.
- Initialization is JAX's, drawn from an explicit ``torch.Generator``:
  torch's default (U(+-1/sqrt(fan_in)) for Linear weight and bias, N(0, 1)
  for embeddings; ``reset_parameters_``), then, with ``config.fixup_init``,
  ``fixup_init_`` rescales ``out_proj``, ``up_proj`` and ``down_proj`` by
  ``0.67 * L**-0.25`` and ``value`` by a further sqrt(2), L being the
  n_layers of the owning stack (JAX :80-87); biases, ``query``, ``key``
  and the tokenizers keep the torch default. The two Linears JAX builds
  as plain ``MXUDense`` (``decoder_proj_context`` and the output heads)
  take flax's default instead: ``lecun_normal_``.
- Dropout is JAX's default u8 policy (``U8_DROPOUT_BITS``, :211-240): keep
  iff a random byte >= t, t = round(rate * 256) clamped to 255, survivors
  divided by the exact keep probability (256 - t) / 256. Attention
  probabilities drop inside the kernel (``ops/attention.py``). A module
  drops only when its forward gets ``seeds`` (``None`` is the eval
  forward): a slice of the step's seed table (``utils/rng.py``), one int64
  entry per random site of the module in the order of its ``SEED_PATHS``,
  on the device. The bytes are Philox draws keyed by the entry on the
  device (``ops/random.py``; the kernel in ``csrc/random.cu``), so a
  ``torch.utils.checkpoint`` recompute and a CUDA-graph replay draw what
  the eager step with those seeds draws.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MaskSpec, multi_head_attention
from ..ops.layernorm import LayerNorm
from ..ops.random import SeedLike, u8_bits


def _gelu_tanh(x):
    # flax nn.gelu defaults to the tanh approximation; torch's to the erf
    return F.gelu(x, approximate="tanh")


ACT2FN = {
    "gelu": _gelu_tanh,
    "relu": F.relu,
    "silu": F.silu,
    "softsign": F.softsign,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


@torch.no_grad()
def reset_parameters_(module: nn.Module, generator: torch.Generator) -> None:
    """Torch-default init of every Linear and Embedding under ``module``,
    drawn in module order from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)


@torch.no_grad()
def lecun_normal_(linear: nn.Linear, generator: torch.Generator) -> None:
    """flax's default Dense init: kernel ``lecun_normal`` (a normal of std
    sqrt(1/fan_in) / 0.8796..., truncated at 2 std, so the kept part has
    variance 1/fan_in), bias zero."""
    std = math.sqrt(1.0 / linear.in_features) / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    if linear.bias is not None:
        linear.bias.zero_()


def fixup_factor(n_layers: int, value: bool = False) -> float:
    """JAX ``fixup_scaled_init``'s scale: ``0.67 * n_layers**-0.25``, x
    sqrt(2) for value kernels."""
    factor = 0.67 * float(n_layers) ** (-0.25)
    return factor * math.sqrt(2.0) if value else factor


@torch.no_grad()
def fixup_init_(layer: nn.Module, n_layers: int) -> None:
    """Fixup rescaling of an Encoder/DecoderLayer's torch-default weights:
    every attention's ``out_proj`` and the MLP's ``up_proj``/``down_proj``
    by ``fixup_factor(n_layers)``, every ``value`` by
    ``fixup_factor(n_layers, value=True)``. Biases are left alone."""
    for m in layer.modules():
        if isinstance(m, (Attention, CrossAttention)):
            m.out_proj.weight.mul_(fixup_factor(n_layers))
            m.value.weight.mul_(fixup_factor(n_layers, value=True))
        elif isinstance(m, MLP):
            m.up_proj.weight.mul_(fixup_factor(n_layers))
            m.down_proj.weight.mul_(fixup_factor(n_layers))


def dropout_keep_threshold(rate: float):
    """(t, keep probability) of the u8 policy: drop iff byte < t, with
    t = round(rate * 256) clamped to 255 (t = 256 would overflow the
    byte; ROADMAP, JAX :237-240)."""
    t = min(int(round(rate * 256.0)), 255)
    return t, (256 - t) / 256.0


def dropout_u8(x: torch.Tensor, rate: float,
               seed: Optional[SeedLike]) -> torch.Tensor:
    """Layer dropout (JAX ``ReplayDropout`` under ``U8_DROPOUT_BITS``):
    identity without a seed or at rate 0, zeros at rate 1, else one random
    Philox byte per element keyed by ``seed`` (a seed-table entry, or a
    host int copied to x's device)."""
    if seed is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    t, keep_p = dropout_keep_threshold(rate)
    bits = u8_bits(seed, x.shape, device=x.device)
    return torch.where(bits >= t, x / keep_p, 0.0)


def seed_at(seeds: Optional[torch.Tensor], i: int,
            n: int = 1) -> Optional[torch.Tensor]:
    """Entries ``[i, i + n)`` of a seed-table slice (None stays None: no
    draw)."""
    return None if seeds is None else seeds[i:i + n]


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """JAX ``_apply_dense``: x, weight and bias cast to ``dtype`` (when
    given), then one ``F.linear``."""
    if dtype is not None:
        x, weight = x.to(dtype), weight.to(dtype)
        bias = None if bias is None else bias.to(dtype)
    return F.linear(x, weight, bias)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (``MXUDense``'s ``dtype``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


def fused_linear(x: torch.Tensor, linears: Sequence[Dense]):
    """Several same-input projections as one GEMM in their compute dtype;
    returns the per-projection column views of the (..., sum(out))
    product."""
    w = torch.cat([lin.weight for lin in linears])
    b = (torch.cat([lin.bias for lin in linears])
         if linears[0].bias is not None else None)
    y = dense(x, w, b, linears[0].compute_dtype)
    return y.split([lin.out_features for lin in linears], dim=-1)


class ScaleNorm(nn.Module):
    """Learned-scale RMS-style norm (JAX ``ScaleNorm``)."""

    def __init__(self, scale_init: float, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.tensor(float(scale_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
        return x * (self.scale / norm.clamp_min(self.eps)).to(x.dtype)


class MLP(nn.Module):
    """up-proj -> act -> down-proj."""

    def __init__(self, hidden_size: int, inter_size: int, act: str,
                 use_bias: bool, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.act = ACT2FN[act]
        self.dropout = dropout
        self.up_proj = Dense(hidden_size, inter_size, use_bias, dtype)
        self.down_proj = Dense(inter_size, hidden_size, use_bias, dtype)

    def forward(self, x: torch.Tensor,
                seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        return dropout_u8(self.down_proj(self.act(self.up_proj(x))),
                          self.dropout, seed_at(seeds, 0))


# an attention's random sites: the in-kernel probability dropout, then the
# output dropout
_ATTN_PATHS = (((0,),), ((1,),))


def _attend(module, q, k, v, mask, seeds):
    """Fused attention with in-kernel probability dropout (entry 0), then
    the output dropout (entry 1), as JAX ``Attention`` does (:404-409)."""
    rate = module.dropout if seeds is not None else 0.0
    out = multi_head_attention(q, k, v, module.n_heads, mask_spec=mask,
                               dropout_rate=rate,
                               seed=seed_at(seeds, 0) if rate else None,
                               impl=module.attn_impl)
    return dropout_u8(out, module.dropout, seed_at(seeds, 1))


class Attention(nn.Module):
    """Self-attention; q/k/v as one (H, 3H) GEMM, then the fused kernel."""

    def __init__(self, hidden_size: int, n_heads: int, use_bias: bool,
                 attn_impl: str = "pallas", dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_heads = n_heads
        self.attn_impl = attn_impl
        self.dropout = dropout
        self.query = Dense(hidden_size, hidden_size, use_bias, dtype)
        self.key = Dense(hidden_size, hidden_size, use_bias, dtype)
        self.value = Dense(hidden_size, hidden_size, use_bias, dtype)
        self.out_proj = Dense(hidden_size, hidden_size, use_bias, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[MaskSpec] = None,
                seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = fused_linear(x, (self.query, self.key, self.value))
        return self.out_proj(_attend(self, q, k, v, mask, seeds))


class CrossAttention(nn.Module):
    """Cross-attention: q from x, k/v as one (H, 2H) GEMM over context."""

    def __init__(self, hidden_size: int, n_heads: int, use_bias: bool,
                 attn_impl: str = "pallas", dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_heads = n_heads
        self.attn_impl = attn_impl
        self.dropout = dropout
        self.query = Dense(hidden_size, hidden_size, use_bias, dtype)
        self.key = Dense(hidden_size, hidden_size, use_bias, dtype)
        self.value = Dense(hidden_size, hidden_size, use_bias, dtype)
        self.out_proj = Dense(hidden_size, hidden_size, use_bias, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[MaskSpec] = None,
                seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.query(x)
        k, v = fused_linear(context, (self.key, self.value))
        return self.out_proj(_attend(self, q, k, v, mask, seeds))


def _norm(cfg, dtype: Optional[torch.dtype]) -> nn.Module:
    if cfg.use_scalenorm:            # JAX's ScaleNorm keeps x's dtype
        return ScaleNorm(cfg.hidden_size ** 0.5)
    return LayerNorm(cfg.hidden_size, eps=1e-5, dtype=dtype)


def _under(prefix, paths):
    return tuple((prefix,) + p for p in paths)


class EncoderLayer(nn.Module):
    """Pre-norm residual block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    # the layer's random sites under its seed, in seed-table order
    SEED_PATHS = _under((0,), _ATTN_PATHS) + (((1,),),)

    def __init__(self, cfg, attn_impl: str = "pallas",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln1 = _norm(cfg, dtype)
        self.attn = Attention(cfg.hidden_size, cfg.n_heads,
                              cfg.attention_bias, attn_impl, cfg.dropout,
                              dtype)
        self.ln2 = _norm(cfg, dtype)
        self.mlp = MLP(cfg.hidden_size, cfg.inter_size, cfg.act, cfg.mlp_bias,
                       cfg.dropout, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[MaskSpec] = None,
                seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask, seed_at(seeds, 0, 2))
        return x + self.mlp(self.ln2(x), seed_at(seeds, 2))


class DecoderLayer(nn.Module):
    """Self-attn + cross-attn (query_norm / context_norm) + MLP block."""

    SEED_PATHS = (_under((0,), _ATTN_PATHS) + _under((1,), _ATTN_PATHS)
                  + (((2,),),))

    def __init__(self, cfg, attn_impl: str = "pallas",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln1 = _norm(cfg, dtype)
        self.attn = Attention(cfg.hidden_size, cfg.n_heads,
                              cfg.attention_bias, attn_impl, cfg.dropout,
                              dtype)
        self.query_norm = _norm(cfg, dtype)
        self.context_norm = _norm(cfg, dtype)
        self.cross_attn = CrossAttention(cfg.hidden_size, cfg.n_heads,
                                         cfg.attention_bias, attn_impl,
                                         cfg.dropout, dtype)
        self.ln2 = _norm(cfg, dtype)
        self.mlp = MLP(cfg.hidden_size, cfg.inter_size, cfg.act, cfg.mlp_bias,
                       cfg.dropout, dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                sa_mask: Optional[MaskSpec] = None,
                xa_mask: Optional[MaskSpec] = None,
                seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), sa_mask, seed_at(seeds, 0, 2))
        x = x + self.cross_attn(self.query_norm(x),
                                self.context_norm(context), xa_mask,
                                seed_at(seeds, 2, 2))
        return x + self.mlp(self.ln2(x), seed_at(seeds, 4))


class ModalityTokenizer(nn.Module):
    """Per-modality token path: Dense(C -> C*mult) -> act -> *scale ->
    Dense(-> H) -> dropout (``embed_dropout``), in the compute dtype. The
    reference's embedder module also owns the modality and position tables
    (``mod_emb``, ``pos_embed``); ``MultiModal`` attaches them here so the
    state_dict names match, and adds them itself."""

    def __init__(self, n_channels: int, hidden_size: int, mult: int,
                 act: str, scale: float, use_bias: bool,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        inter = n_channels * mult
        self.act = ACT2FN[act]
        self.scale = scale
        self.dropout = dropout
        self.token_embed = Dense(n_channels, inter, use_bias, dtype)
        self.projection = Dense(inter, hidden_size, True, dtype)

    def forward(self, inputs: torch.Tensor,
                seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.act(self.token_embed(inputs)) * self.scale
        return dropout_u8(self.projection(x), self.dropout, seed)
