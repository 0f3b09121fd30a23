"""Transformer building blocks and tokenizers (``nn.Module``).

Port of ``multi_modal_foundation_model_tpu/models/layers.py``. Parameter
names are the reference ``state_dict`` names
(``utils/torch_convert.py:21-40`` of the JAX package), with separate
``query``/``key``/``value`` Linears; the projections that share an input
run as ONE GEMM over the concatenated weights at apply time, as the JAX
package's ``_fused_proj`` does, and the q/k/v column views of that product
go to the attention kernel without a copy.

- ``MXUDense``/``MXUEmbed`` are ``nn.Linear``/``nn.Embedding``.
- Initialization is torch's default (U(+-1/sqrt(fan_in)) for Linear weight
  and bias, N(0, 1) for embeddings) drawn from an explicit
  ``torch.Generator`` (``reset_parameters_``). The JAX package's fixup
  rescaling of the output/value projections comes with the training slice.
- Dropout is the identity at eval; the modules here run the eval forward
  only (the training slice brings dropout).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MaskSpec, multi_head_attention
from ..ops.layernorm import LayerNorm


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


def fused_linear(x: torch.Tensor, linears: Sequence[nn.Linear]):
    """Several same-input projections as one GEMM; returns the per-
    projection column views of the (..., sum(out)) product."""
    w = torch.cat([lin.weight for lin in linears])
    b = (torch.cat([lin.bias for lin in linears])
         if linears[0].bias is not None else None)
    return F.linear(x, w, b).split([lin.out_features for lin in linears],
                                   dim=-1)


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
                 use_bias: bool):
        super().__init__()
        self.act = ACT2FN[act]
        self.up_proj = nn.Linear(hidden_size, inter_size, bias=use_bias)
        self.down_proj = nn.Linear(inter_size, hidden_size, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.act(self.up_proj(x)))


class Attention(nn.Module):
    """Self-attention; q/k/v as one (H, 3H) GEMM, then the fused kernel."""

    def __init__(self, hidden_size: int, n_heads: int, use_bias: bool,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.n_heads = n_heads
        self.attn_impl = attn_impl
        self.query = nn.Linear(hidden_size, hidden_size, bias=use_bias)
        self.key = nn.Linear(hidden_size, hidden_size, bias=use_bias)
        self.value = nn.Linear(hidden_size, hidden_size, bias=use_bias)
        self.out_proj = nn.Linear(hidden_size, hidden_size, bias=use_bias)

    def forward(self, x: torch.Tensor,
                mask: Optional[MaskSpec] = None) -> torch.Tensor:
        q, k, v = fused_linear(x, (self.query, self.key, self.value))
        out = multi_head_attention(q, k, v, self.n_heads, mask_spec=mask,
                                   impl=self.attn_impl)
        return self.out_proj(out)


class CrossAttention(nn.Module):
    """Cross-attention: q from x, k/v as one (H, 2H) GEMM over context."""

    def __init__(self, hidden_size: int, n_heads: int, use_bias: bool,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.n_heads = n_heads
        self.attn_impl = attn_impl
        self.query = nn.Linear(hidden_size, hidden_size, bias=use_bias)
        self.key = nn.Linear(hidden_size, hidden_size, bias=use_bias)
        self.value = nn.Linear(hidden_size, hidden_size, bias=use_bias)
        self.out_proj = nn.Linear(hidden_size, hidden_size, bias=use_bias)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[MaskSpec] = None) -> torch.Tensor:
        q = self.query(x)
        k, v = fused_linear(context, (self.key, self.value))
        out = multi_head_attention(q, k, v, self.n_heads, mask_spec=mask,
                                   impl=self.attn_impl)
        return self.out_proj(out)


def _norm(cfg) -> nn.Module:
    if cfg.use_scalenorm:
        return ScaleNorm(cfg.hidden_size ** 0.5)
    return LayerNorm(cfg.hidden_size, eps=1e-5)


class EncoderLayer(nn.Module):
    """Pre-norm residual block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    def __init__(self, cfg, attn_impl: str = "pallas"):
        super().__init__()
        self.ln1 = _norm(cfg)
        self.attn = Attention(cfg.hidden_size, cfg.n_heads,
                              cfg.attention_bias, attn_impl)
        self.ln2 = _norm(cfg)
        self.mlp = MLP(cfg.hidden_size, cfg.inter_size, cfg.act, cfg.mlp_bias)

    def forward(self, x: torch.Tensor,
                mask: Optional[MaskSpec] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp(self.ln2(x))


class DecoderLayer(nn.Module):
    """Self-attn + cross-attn (query_norm / context_norm) + MLP block."""

    def __init__(self, cfg, attn_impl: str = "pallas"):
        super().__init__()
        self.ln1 = _norm(cfg)
        self.attn = Attention(cfg.hidden_size, cfg.n_heads,
                              cfg.attention_bias, attn_impl)
        self.query_norm = _norm(cfg)
        self.context_norm = _norm(cfg)
        self.cross_attn = CrossAttention(cfg.hidden_size, cfg.n_heads,
                                         cfg.attention_bias, attn_impl)
        self.ln2 = _norm(cfg)
        self.mlp = MLP(cfg.hidden_size, cfg.inter_size, cfg.act, cfg.mlp_bias)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                sa_mask: Optional[MaskSpec] = None,
                xa_mask: Optional[MaskSpec] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), sa_mask)
        x = x + self.cross_attn(self.query_norm(x),
                                self.context_norm(context), xa_mask)
        return x + self.mlp(self.ln2(x))


class ModalityTokenizer(nn.Module):
    """Per-modality token path: Linear(C -> C*mult) -> act -> *scale ->
    Linear(-> H). The reference's embedder module also owns the modality
    and position tables (``mod_emb``, ``pos_embed``); ``MultiModal``
    attaches them here so the state_dict names match, and adds them
    itself."""

    def __init__(self, n_channels: int, hidden_size: int, mult: int,
                 act: str, scale: float, use_bias: bool):
        super().__init__()
        inter = n_channels * mult
        self.act = ACT2FN[act]
        self.scale = scale
        self.token_embed = nn.Linear(n_channels, inter, bias=use_bias)
        self.projection = nn.Linear(inter, hidden_size, bias=True)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.act(self.token_embed(inputs)) * self.scale
        return self.projection(x)
