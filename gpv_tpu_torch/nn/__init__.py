from .bert import BertEncoder
from .coattention import BiAttention, CoAttentionLayer
from .detr_transformer import DetrTransformer, DecoderLayer, EncoderLayer
from .layers import FrozenBatchNorm, MLP, MultiHeadAttention, attend_heads
from .resnet import Bottleneck, ResNet
from .text_decoder import TextDecoder, TextDecoderLayer

__all__ = [
    "BertEncoder", "BiAttention", "CoAttentionLayer", "DetrTransformer",
    "DecoderLayer", "EncoderLayer", "FrozenBatchNorm", "MLP",
    "MultiHeadAttention", "attend_heads", "Bottleneck", "ResNet",
    "TextDecoder", "TextDecoderLayer",
]
