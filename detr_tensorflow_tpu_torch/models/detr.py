"""DETR assembly (port of ``detr_tensorflow_tpu/models/detr.py``):
backbone -> exact feature mask -> sine positions -> 1x1 projection ->
transformer -> heads, and with ``masks=True`` the instance-segmentation head
(``models/segmentation.py``). ``pipeline`` (a ``parallel.pp.PipelineSpec``)
stages the transformer over processes (GPipe). ``backbone_quant=True``
runs the int8 post-training-quantized backbone of ``models/quantized.py``
instead of the fp32 one;
``fuse_residual`` and ``fuse_bottleneck`` run the fused backbone kernels
(inference only); ``dilation`` builds the DC5 family; ``remat`` and
``backbone_remat`` trade recomputation for activation memory in training."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import MLP, Conv2d, Linear, feature_valid_mask
from .position import sine_position_embedding
from .quantized import QuantizedBackbone
from .resnet import ResNetBackbone
from .segmentation import MaskHead, MHAttentionMap
from .transformer import Transformer

HEADS = ("detr", "finetune", "none")
STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class DETR(nn.Module):
    """End-to-end DETR: NHWC images -> set predictions.

    head:
      * ``"detr"``: ``class_embed`` Linear(num_classes) + ``bbox_embed`` MLP;
      * ``"finetune"``: fresh ``cls_layer`` Linear(nb_class) + ``pos_layer`` MLP;
      * ``"none"``: headless, returns ``hs`` (L, B, Q, D) and ``memory``.

    ``dtype`` is the compute dtype (float32 or bfloat16; float64 on the CPU
    for diagnosis, with ``.double()`` parameters), as flax's ``dtype=``:
    the images enter in it, every Linear and Conv casts its float32
    parameters to it at the call, LayerNorm computes in float32 and rounds
    once to it, and the heads' outputs leave as float32 (``models/layers.py``).
    Parameters, FrozenBN buffers and ``query_embed`` stay float32, as in JAX.

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

    ``masks=True`` adds the segmentation head: ``bbox_attention`` (an
    ``MHAttentionMap`` over the last decoder layer's output and the encoder
    memory) and ``mask_head`` (a ``MaskHead`` over ``input_proj``'s output,
    the attention maps and the backbone's c4/c3/c2 stages, fp32 or int8).
    Every head, ``"none"`` included, then returns ``pred_masks`` (B, Q,
    H/4, W/4) float32 logits. Its dropout on the attention maps draws from
    ``generator``; ``remat`` leaves it alone.

    ``dilation=True`` (DC5) dilates the backbone's last stage, fp32 and int8
    alike: C5 at stride 16, four times the encoder's keys. ``remat=True``
    recomputes each encoder and decoder layer in the backward, replaying its
    dropout draws; ``backbone_remat=n`` recomputes the first n backbone
    stages. Neither changes the forward or the gradients.

    ``pipeline`` (a ``parallel.pp.PipelineSpec``, or ``set_pipeline``) runs
    the transformer GPipe-staged over the spec's mesh, every rank holding
    the whole model (``models/transformer.py``): the same parameter names,
    outputs and gradients as the sequential model, on every stage rank.
    """

    def __init__(self, num_classes: int = 92, num_queries: int = 100,
                 model_dim: int = 256, num_heads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, backbone_depth: int = 50,
                 backbone_stage_sizes: Optional[Sequence[int]] = None,
                 head: str = "detr", nb_class: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 dropout: float = 0.1, backbone_quant: bool = False,
                 fuse_residual: bool = False, fuse_bottleneck: bool = False,
                 dilation: bool = False, remat: bool = False, backbone_remat: int = 0,
                 masks: bool = False, pipeline=None):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head: {head}")
        if head == "finetune" and nb_class is None:
            raise ValueError("finetune head needs nb_class")
        self.model_dim, self.head, self.dtype = model_dim, head, dtype
        self.backbone_depth, self.dilation = backbone_depth, dilation
        self.fuse_residual, self.fuse_bottleneck = fuse_residual, fuse_bottleneck
        self.masks, self.dropout, self.num_queries = masks, dropout, num_queries
        stage_sizes = backbone_stage_sizes or STAGE_SIZES[backbone_depth]
        self.backbone = ResNetBackbone(stage_sizes, fuse_residual, fuse_bottleneck,
                                       (False, False, dilation), backbone_remat,
                                       return_interm=masks)
        self.backbone_quant = (QuantizedBackbone(stage_sizes, dilation) if backbone_quant
                               else None)
        self.input_proj = Conv2d(2048, model_dim, 1)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, model_dim))
        self.transformer = Transformer(model_dim, num_heads, num_encoder_layers,
                                       num_decoder_layers, dim_feedforward, attn_impl,
                                       dropout, remat)
        if head == "detr":
            self.class_embed = Linear(model_dim, num_classes)
            self.bbox_embed = MLP(model_dim, model_dim, 4)
        elif head == "finetune":
            self.cls_layer = Linear(model_dim, nb_class)
            self.pos_layer = MLP(model_dim, model_dim, 4)
        if masks:
            self.bbox_attention = MHAttentionMap(model_dim, num_heads, dropout)
            self.mask_head = MaskHead(model_dim, num_heads)
        self.set_pipeline(pipeline)

    @property
    def pipeline(self):
        return self.transformer.pipeline

    def set_pipeline(self, spec) -> "DETR":
        """Stage the transformer over ``spec``'s mesh (GPipe), or run it
        sequentially with None. Returns the model."""
        self.transformer.pipeline = spec
        return self

    def features(self, images: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None):
        """The transformer's inputs: (src (B, h*w, D), pos (B, h*w, D), the
        key padding mask (B, h*w) or None, and (proj (B, h, w, D), the
        backbone's NHWC stage outputs or None) for the mask head)."""
        fpn = None
        if self.backbone_quant is not None:
            feats = self.backbone_quant(images, pixel_mask, self.dtype,
                                        return_interm=self.masks)
            if self.masks:
                feats, fpn = feats  # NHWC stage outputs
            feats = feats.permute(0, 3, 1, 2)
        else:
            feats = self.backbone(images.to(self.dtype), pixel_mask)  # (B, C, h, w)
            if self.masks:
                feats, interm = feats
                fpn = {k: v.permute(0, 2, 3, 1) for k, v in interm.items()}  # NHWC views
        b, _, fh, fw = feats.shape
        if pixel_mask is None:
            valid = torch.ones((b, fh, fw), device=feats.device)
            key_padding_mask = None
        else:
            valid = feature_valid_mask(pixel_mask, fh, fw)
            key_padding_mask = (valid < 0.5).reshape(b, fh * fw)
        pos = sine_position_embedding(valid, self.model_dim // 2, dtype=self.dtype)
        pos = pos.reshape(b, fh * fw, self.model_dim)
        proj = self.input_proj(feats).permute(0, 2, 3, 1)  # (B, h, w, D)
        src = proj.reshape(b, fh * fw, self.model_dim)
        return src, pos, key_padding_mask, (proj, fpn)

    def heads(self, hs: torch.Tensor) -> dict:
        """The class and box heads over the decoder stack hs (L, B, Q, D):
        the final layer's predictions and the auxiliary layers', float32."""
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

    def forward(self, images: torch.Tensor, pixel_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """images: (B, H, W, 3) normalized, NHWC. pixel_mask: optional
        (B, H, W) bool, True = valid; omitted means all valid. ``train``
        turns on the transformer's dropout, drawn from ``generator`` (a
        generator on the model's device)."""
        src, pos, key_padding_mask, (proj, fpn) = self.features(images, pixel_mask)
        b, fh, fw = proj.shape[:3]
        hs, memory = self.transformer(src, pos, self.query_embed, key_padding_mask,
                                      train, generator)
        memory = memory.reshape(b, fh, fw, self.model_dim)
        extra = {}
        if self.masks:
            attn_maps = self.bbox_attention(hs[-1], memory, key_padding_mask, train, generator)
            extra["pred_masks"] = self.mask_head(proj, attn_maps, fpn, pixel_mask)
        if self.head == "none":
            return {"hs": hs, "memory": memory, **extra}
        return {**self.heads(hs), **extra}


def as_aux_list(outputs):
    """Stacked aux outputs -> the reference's list-of-dicts form."""
    out = {"pred_logits": outputs["pred_logits"], "pred_boxes": outputs["pred_boxes"]}
    if "aux_logits" in outputs:
        out["aux"] = [
            {"pred_logits": lg, "pred_boxes": bx}
            for lg, bx in zip(outputs["aux_logits"], outputs["aux_boxes"])
        ]
    return out
