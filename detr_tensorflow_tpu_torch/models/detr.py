"""DETR assembly (port of ``detr_tensorflow_tpu/models/detr.py``):
backbone -> exact feature mask -> sine positions -> 1x1 projection ->
transformer -> heads. Detection heads only: no segmentation head and no
pipeline stages. ``backbone_quant=True`` runs the int8 post-training-quantized
backbone of ``models/quantized.py`` instead of the fp32 one;
``fuse_residual`` and ``fuse_bottleneck`` run the fused backbone kernels
(inference only)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import MLP, feature_valid_mask
from .position import sine_position_embedding
from .quantized import QuantizedBackbone
from .resnet import ResNetBackbone
from .transformer import Transformer

HEADS = ("detr", "finetune", "none")
STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class DETR(nn.Module):
    """End-to-end DETR: NHWC images -> set predictions.

    head:
      * ``"detr"``: ``class_embed`` Linear(num_classes) + ``bbox_embed`` MLP;
      * ``"finetune"``: fresh ``cls_layer`` Linear(nb_class) + ``pos_layer`` MLP;
      * ``"none"``: headless, returns ``hs`` (L, B, Q, D) and ``memory``.

    ``dtype`` is the compute dtype (float32 or bfloat16). The caller casts
    the Linear/Conv/LayerNorm parameters to it (``api.build_detr`` does);
    FrozenBN buffers and ``query_embed`` stay float32, as in JAX.

    ``backbone_quant=True`` (inference) takes the backbone's features from
    the int8 qtree in ``self.backbone_quant`` (filled by
    ``quantized.quantize_model`` or from an ``.npz`` with the JAX "quant"
    collection); the forward raises until it is filled. The fp32
    ``backbone`` stays: calibration reads it.

    ``fuse_residual=True`` (inference) runs every bottleneck's tail as
    kernel D; ``fuse_bottleneck=True`` (inference) runs every identity
    bottleneck as kernel E when the forward has no pixel mask (the JAX
    model's ``fuse_bottleneck and pixel_mask is None``: with a mask every
    block gets a validity map and stays off E). The parameter tree does
    not change with either flag.
    """

    def __init__(self, num_classes: int = 92, num_queries: int = 100,
                 model_dim: int = 256, num_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, backbone_depth: int = 50,
                 backbone_stage_sizes: Optional[Sequence[int]] = None,
                 head: str = "detr", nb_class: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 dropout: float = 0.1, backbone_quant: bool = False,
                 fuse_residual: bool = False, fuse_bottleneck: bool = False):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head: {head}")
        if head == "finetune" and nb_class is None:
            raise ValueError("finetune head needs nb_class")
        self.model_dim, self.head, self.dtype = model_dim, head, dtype
        self.fuse_residual, self.fuse_bottleneck = fuse_residual, fuse_bottleneck
        stage_sizes = backbone_stage_sizes or STAGE_SIZES[backbone_depth]
        self.backbone = ResNetBackbone(stage_sizes, fuse_residual, fuse_bottleneck)
        self.backbone_quant = QuantizedBackbone(stage_sizes) if backbone_quant else None
        self.input_proj = nn.Conv2d(2048, model_dim, 1)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, model_dim))
        self.transformer = Transformer(model_dim, num_heads, num_encoder_layers,
                                       num_decoder_layers, dim_feedforward, attn_impl,
                                       dropout)
        if head == "detr":
            self.class_embed = nn.Linear(model_dim, num_classes)
            self.bbox_embed = MLP(model_dim, model_dim, 4)
        elif head == "finetune":
            self.cls_layer = nn.Linear(model_dim, nb_class)
            self.pos_layer = MLP(model_dim, model_dim, 4)

    def forward(self, images: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """images: (B, H, W, 3) normalized, NHWC. pixel_mask: optional
        (B, H, W) bool, True = valid; omitted means all valid. ``train``
        turns on the transformer's dropout, drawn from ``generator`` (a
        generator on the model's device)."""
        if self.backbone_quant is not None:
            feats = self.backbone_quant(images, pixel_mask, self.dtype).permute(0, 3, 1, 2)
        else:
            feats = self.backbone(images.to(self.dtype), pixel_mask)  # (B, C, h, w)
        b, _, fh, fw = feats.shape
        if pixel_mask is None:
            valid = torch.ones((b, fh, fw), device=feats.device)
            key_padding_mask = None
        else:
            valid = feature_valid_mask(pixel_mask, fh, fw)
            key_padding_mask = (valid < 0.5).reshape(b, fh * fw)
        pos = sine_position_embedding(valid, self.model_dim // 2, dtype=self.dtype)
        pos = pos.reshape(b, fh * fw, self.model_dim)
        src = self.input_proj(feats).flatten(2).transpose(1, 2)  # (B, S, D)

        hs, memory = self.transformer(src, pos, self.query_embed, key_padding_mask,
                                      train, generator)
        if self.head == "none":
            return {"hs": hs, "memory": memory.reshape(b, fh, fw, self.model_dim)}
        if self.head == "detr":
            logits, boxes = self.class_embed(hs), self.bbox_embed(hs)
        else:
            logits, boxes = self.cls_layer(hs), self.pos_layer(hs)
        logits, boxes = logits.float(), boxes.float()
        return {
            "pred_logits": logits[-1],
            "pred_boxes": boxes[-1],
            "aux_logits": logits[:-1],
            "aux_boxes": boxes[:-1],
        }


def as_aux_list(outputs):
    """Stacked aux outputs -> the reference's list-of-dicts form."""
    out = {"pred_logits": outputs["pred_logits"], "pred_boxes": outputs["pred_boxes"]}
    if "aux_logits" in outputs:
        out["aux"] = [
            {"pred_logits": lg, "pred_boxes": bx}
            for lg, bx in zip(outputs["aux_logits"], outputs["aux_boxes"])
        ]
    return out
