from .layers import (Attention, CrossAttention, DecoderLayer, EncoderLayer,
                     MLP, ModalityTokenizer, ScaleNorm)
from .multimodal import (ModalityInput, MultiModal, MultiModalConfig,
                         MultiModalOutput)

__all__ = [
    "Attention", "CrossAttention", "DecoderLayer", "EncoderLayer", "MLP",
    "ModalityTokenizer", "ScaleNorm", "ModalityInput", "MultiModal",
    "MultiModalConfig", "MultiModalOutput",
]
