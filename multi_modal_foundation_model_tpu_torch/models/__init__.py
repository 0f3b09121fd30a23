from .baseline import BaselineDecoder, BaselineEncoder, BaselineOutput
from .layers import (Attention, CrossAttention, DecoderLayer, EncoderLayer,
                     MLP, ModalityTokenizer, ScaleNorm)
from .multimodal import (ModalityInput, MultiModal, MultiModalConfig,
                         MultiModalOutput)

__all__ = [
    "BaselineDecoder", "BaselineEncoder", "BaselineOutput",
    "Attention", "CrossAttention", "DecoderLayer", "EncoderLayer", "MLP",
    "ModalityTokenizer", "ScaleNorm", "ModalityInput", "MultiModal",
    "MultiModalConfig", "MultiModalOutput",
]
