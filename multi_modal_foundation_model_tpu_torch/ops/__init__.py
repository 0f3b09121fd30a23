from .attention import (NEG_INF, MaskSpec, attention_bwd,
                        attention_bwd_reference, attention_fwd,
                        attention_reference, create_context_mask,
                        mask_to_bias, multi_head_attention, philox_keep,
                        spec_to_bias)
from .layernorm import LayerNorm, layer_norm
from .losses import masked_mse, masked_poisson_nll
from .masking import MaskParams, RegionSets, RegionTable

__all__ = [
    "NEG_INF", "MaskSpec", "attention_bwd", "attention_bwd_reference",
    "attention_fwd", "attention_reference", "create_context_mask",
    "mask_to_bias", "multi_head_attention", "philox_keep", "spec_to_bias",
    "LayerNorm", "layer_norm", "masked_mse", "masked_poisson_nll",
    "MaskParams", "RegionSets", "RegionTable",
]
