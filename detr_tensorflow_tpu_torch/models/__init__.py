"""DETR model in PyTorch: frozen-BN ResNet backbones, the transformer, the
assembled model, int8 quantization, weights and the construction API."""

from .api import DetrModel, build_detr, get_detr_model  # noqa: F401
from .detr import DETR, as_aux_list  # noqa: F401
from .layers import MLP, FrozenBatchNorm  # noqa: F401
from .position import sine_position_embedding  # noqa: F401
from .quantized import (  # noqa: F401
    calibrate_backbone,
    quant_backbone_forward,
    quantize_backbone,
    quantize_model,
)
from .resnet import ResNetBackbone, resnet50_backbone, resnet101_backbone  # noqa: F401
from .transformer import MultiHeadAttention, Transformer  # noqa: F401
