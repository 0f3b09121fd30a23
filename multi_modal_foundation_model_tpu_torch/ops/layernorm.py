"""LayerNorm with the JAX package's fast-variance formula.

Port of the form ``FusedLayerNorm`` takes by default
(``multi_modal_foundation_model_tpu/ops/layernorm.py:86-93``; its Pallas
kernels K3/K4 are off by default there, ``PALLAS_LAYERNORM = "off"``):
f32 statistics with ``var = relu(E[x^2] - mu^2)``, eps 1e-5. Torch's
``F.layer_norm`` computes the variance in two passes, which differs in the
last bits, so the formula is written out here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fast-variance LayerNorm over the last axis, f32 math; output in
    ``dtype`` (default: x's dtype promoted with f32)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.relu((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu)
    y = (x32 - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(dtype or torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.Module):
    """``weight``/``bias`` LayerNorm (reference state_dict names)."""

    def __init__(self, hidden_size: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
