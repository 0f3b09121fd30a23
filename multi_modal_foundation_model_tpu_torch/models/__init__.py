from .baseline import BaselineDecoder, BaselineEncoder, BaselineOutput
from .layers import (Attention, CrossAttention, DecoderLayer, EncoderLayer,
                     FactorsProjection, MLP, ModalityTokenizer, ScaleNorm,
                     SessionStitchedHead, SessionStitchedTokenizer)
from .multimodal import (ModalityInput, MultiModal, MultiModalConfig,
                         MultiModalOutput)
from .region_lookup import RegionLookup

__all__ = [
    "BaselineDecoder", "BaselineEncoder", "BaselineOutput",
    "Attention", "CrossAttention", "DecoderLayer", "EncoderLayer",
    "FactorsProjection", "MLP",
    "ModalityTokenizer", "ScaleNorm", "SessionStitchedHead",
    "SessionStitchedTokenizer", "ModalityInput", "MultiModal",
    "MultiModalConfig", "MultiModalOutput", "RegionLookup",
]
